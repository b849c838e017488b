// Native SPSC shared-memory ring channel.
//
// TPU-native equivalent of the reference's C++ mutable-object channel
// (src/ray/core_worker/experimental_mutable_object_manager.h,
// backing python/ray/experimental/channel/shared_memory_channel.py):
// a pre-allocated ring written in place per DAG execution, no
// allocation or serialization in the hot path. Compared to the Python
// ShmChannel ring (experimental/channel/shm_channel.py) this adds real
// acquire/release atomics (the Python path leans on the GIL + x86 TSO)
// and GIL-released adaptive spin waits: the Python poller's latency
// floor is its 500us sleep; this wakes in microseconds.
//
// Built by ray_tpu_torch/_native/__init__.py with g++ via the CPython C API —
// no pybind11 (not in the image).
//
// Wire/layout compatibility: the Python and native rings use different
// segment layouts, so the backend choice is pinned in every pickled
// channel descriptor (ShmChannel.__reduce__, CompiledDAG desc()).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52547052494e4721ull;  // "RTpRING!"

struct RingHeader {
  uint64_t magic;
  uint64_t item_bytes;
  uint64_t capacity;
  uint64_t _pad;
  alignas(64) std::atomic<uint64_t> write_seq;
  alignas(64) std::atomic<uint64_t> read_seq;
};

struct Ring {
  RingHeader* hdr;
  std::atomic<uint64_t>* slot_seq;
  uint8_t* data;
  size_t total;
};

inline size_t ring_bytes(uint64_t item_bytes, uint64_t capacity) {
  return sizeof(RingHeader) + capacity * sizeof(std::atomic<uint64_t>) +
         capacity * item_bytes;
}

inline void map_views(Ring* r, void* base) {
  r->hdr = static_cast<RingHeader*>(base);
  r->slot_seq = reinterpret_cast<std::atomic<uint64_t>*>(
      static_cast<uint8_t*>(base) + sizeof(RingHeader));
  r->data = reinterpret_cast<uint8_t*>(r->slot_seq + r->hdr->capacity);
}

double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

// Adaptive wait: spin with pause, then escalate to short nanosleeps.
// Returns false on deadline expiry.
template <typename Pred>
bool wait_until(Pred pred, double deadline) {
  for (int i = 0; i < 4096; ++i) {
    if (pred()) return true;
#if defined(__x86_64__)
    __builtin_ia32_pause();
#endif
  }
  struct timespec ts = {0, 1000};  // 1us, escalating to 100us
  while (!pred()) {
    if (now_s() > deadline) return false;
    nanosleep(&ts, nullptr);
    if (ts.tv_nsec < 100000) ts.tv_nsec *= 2;
  }
  return true;
}

void capsule_destructor(PyObject* cap) {
  Ring* r = static_cast<Ring*>(PyCapsule_GetPointer(cap, "ray_tpu_torch.Ring"));
  if (r != nullptr) {
    munmap(r->hdr, r->total);
    delete r;
  }
}

Ring* get_ring(PyObject* cap) {
  return static_cast<Ring*>(PyCapsule_GetPointer(cap, "ray_tpu_torch.Ring"));
}

PyObject* ring_create(PyObject*, PyObject* args) {
  const char* name;
  unsigned long long item_bytes, capacity;
  if (!PyArg_ParseTuple(args, "sKK", &name, &item_bytes, &capacity))
    return nullptr;
  size_t total = ring_bytes(item_bytes, capacity);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return PyErr_SetFromErrno(PyExc_OSError);
  if (ftruncate(fd, (off_t)total) != 0) {
    close(fd);
    shm_unlink(name);
    return PyErr_SetFromErrno(PyExc_OSError);
  }
  void* base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) {
    shm_unlink(name);
    return PyErr_SetFromErrno(PyExc_OSError);
  }
  std::memset(base, 0, sizeof(RingHeader));
  auto* hdr = static_cast<RingHeader*>(base);
  hdr->item_bytes = item_bytes;
  hdr->capacity = capacity;
  hdr->write_seq.store(0, std::memory_order_relaxed);
  hdr->read_seq.store(0, std::memory_order_relaxed);
  auto* seq = reinterpret_cast<std::atomic<uint64_t>*>(
      static_cast<uint8_t*>(base) + sizeof(RingHeader));
  for (uint64_t i = 0; i < capacity; ++i)
    seq[i].store(0, std::memory_order_relaxed);
  hdr->magic = kMagic;  // publish last
  Ring* r = new Ring();
  r->total = total;
  map_views(r, base);
  return PyCapsule_New(r, "ray_tpu_torch.Ring", capsule_destructor);
}

PyObject* ring_attach(PyObject*, PyObject* args) {
  const char* name;
  if (!PyArg_ParseTuple(args, "s", &name)) return nullptr;
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return PyErr_SetFromErrno(PyExc_OSError);
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return PyErr_SetFromErrno(PyExc_OSError);
  }
  void* base =
      mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return PyErr_SetFromErrno(PyExc_OSError);
  auto* hdr = static_cast<RingHeader*>(base);
  if ((size_t)st.st_size < sizeof(RingHeader) || hdr->magic != kMagic ||
      ring_bytes(hdr->item_bytes, hdr->capacity) > (size_t)st.st_size) {
    munmap(base, st.st_size);
    PyErr_SetString(PyExc_ValueError, "not a ray_tpu_torch ring segment");
    return nullptr;
  }
  Ring* r = new Ring();
  r->total = st.st_size;
  map_views(r, base);
  return PyCapsule_New(r, "ray_tpu_torch.Ring", capsule_destructor);
}

PyObject* ring_unlink(PyObject*, PyObject* args) {
  const char* name;
  if (!PyArg_ParseTuple(args, "s", &name)) return nullptr;
  shm_unlink(name);  // best-effort
  Py_RETURN_NONE;
}

PyObject* ring_write(PyObject*, PyObject* args) {
  PyObject* cap;
  Py_buffer buf;
  double timeout_s;
  if (!PyArg_ParseTuple(args, "Oy*d", &cap, &buf, &timeout_s)) return nullptr;
  Ring* r = get_ring(cap);
  if (r == nullptr) {
    PyBuffer_Release(&buf);
    return nullptr;
  }
  RingHeader* h = r->hdr;
  if ((uint64_t)buf.len != h->item_bytes) {
    PyBuffer_Release(&buf);
    PyErr_Format(PyExc_ValueError, "item is %zd bytes, ring expects %llu",
                 buf.len, (unsigned long long)h->item_bytes);
    return nullptr;
  }
  bool ok;
  uint64_t w;
  Py_BEGIN_ALLOW_THREADS;
  double deadline = now_s() + timeout_s;
  w = h->write_seq.load(std::memory_order_relaxed);
  uint64_t cap_n = h->capacity;
  ok = wait_until(
      [&] { return w - h->read_seq.load(std::memory_order_acquire) < cap_n; },
      deadline);
  if (ok) {
    uint64_t slot = w % cap_n;
    std::memcpy(r->data + slot * h->item_bytes, buf.buf, h->item_bytes);
    r->slot_seq[slot].store(w + 1, std::memory_order_release);
    h->write_seq.store(w + 1, std::memory_order_release);
  }
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&buf);
  if (!ok) {
    PyErr_SetString(PyExc_TimeoutError, "ring full: reader not draining");
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyObject* ring_read_into(PyObject*, PyObject* args) {
  PyObject* cap;
  Py_buffer buf;
  double timeout_s;
  if (!PyArg_ParseTuple(args, "Ow*d", &cap, &buf, &timeout_s)) return nullptr;
  Ring* r = get_ring(cap);
  if (r == nullptr) {
    PyBuffer_Release(&buf);
    return nullptr;
  }
  RingHeader* h = r->hdr;
  if ((uint64_t)buf.len != h->item_bytes) {
    PyBuffer_Release(&buf);
    PyErr_Format(PyExc_ValueError, "out buffer is %zd bytes, ring item is %llu",
                 buf.len, (unsigned long long)h->item_bytes);
    return nullptr;
  }
  bool ok;
  Py_BEGIN_ALLOW_THREADS;
  double deadline = now_s() + timeout_s;
  uint64_t rd = h->read_seq.load(std::memory_order_relaxed);
  uint64_t slot = rd % h->capacity;
  ok = wait_until(
      [&] {
        return r->slot_seq[slot].load(std::memory_order_acquire) == rd + 1;
      },
      deadline);
  if (ok) {
    std::memcpy(buf.buf, r->data + slot * h->item_bytes, h->item_bytes);
    h->read_seq.store(rd + 1, std::memory_order_release);
  }
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&buf);
  if (!ok) {
    PyErr_SetString(PyExc_TimeoutError, "ring empty: writer not producing");
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyObject* ring_try_read_into(PyObject*, PyObject* args) {
  PyObject* cap;
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "Ow*", &cap, &buf)) return nullptr;
  Ring* r = get_ring(cap);
  if (r == nullptr) {
    PyBuffer_Release(&buf);
    return nullptr;
  }
  RingHeader* h = r->hdr;
  uint64_t rd = h->read_seq.load(std::memory_order_relaxed);
  uint64_t slot = rd % h->capacity;
  bool ready =
      r->slot_seq[slot].load(std::memory_order_acquire) == rd + 1 &&
      (uint64_t)buf.len == h->item_bytes;
  if (ready) {
    std::memcpy(buf.buf, r->data + slot * h->item_bytes, h->item_bytes);
    h->read_seq.store(rd + 1, std::memory_order_release);
  }
  PyBuffer_Release(&buf);
  return PyBool_FromLong(ready ? 1 : 0);
}

PyObject* ring_info(PyObject*, PyObject* args) {
  PyObject* cap;
  if (!PyArg_ParseTuple(args, "O", &cap)) return nullptr;
  Ring* r = get_ring(cap);
  if (r == nullptr) return nullptr;
  return Py_BuildValue(
      "{s:K,s:K,s:K,s:K}", "item_bytes",
      (unsigned long long)r->hdr->item_bytes, "capacity",
      (unsigned long long)r->hdr->capacity, "write_seq",
      (unsigned long long)r->hdr->write_seq.load(std::memory_order_acquire),
      "read_seq",
      (unsigned long long)r->hdr->read_seq.load(std::memory_order_acquire));
}

PyMethodDef methods[] = {
    {"create", ring_create, METH_VARARGS,
     "create(name, item_bytes, capacity) -> ring handle"},
    {"attach", ring_attach, METH_VARARGS, "attach(name) -> ring handle"},
    {"unlink", ring_unlink, METH_VARARGS, "unlink(name)"},
    {"write", ring_write, METH_VARARGS,
     "write(ring, buffer, timeout_s); blocks while full"},
    {"read_into", ring_read_into, METH_VARARGS,
     "read_into(ring, out_buffer, timeout_s); blocks until published"},
    {"try_read_into", ring_try_read_into, METH_VARARGS,
     "try_read_into(ring, out_buffer) -> bool"},
    {"info", ring_info, METH_VARARGS, "info(ring) -> dict"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_ring_native",
                         "native SPSC shm ring channel", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__ring_native(void) { return PyModule_Create(&moduledef); }
