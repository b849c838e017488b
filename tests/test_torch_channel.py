"""The shared-memory ring channel of the port against the reference's.

``ray_tpu_torch.experimental.channel.ShmChannel`` and
``ray_tpu.experimental.channel.ShmChannel`` run the same programs on both
backends (the C++ ring of ``_native/ring_channel.cpp`` and the numpy
ring): order across the ring's wrap, a full ring, blocking and
non-blocking reads, the pickled descriptor with its pinned backend, and
the shape check. The port differs by design (ROADMAP.md Queue C): its
segments carry the ``ray_tpu_torch_ch_`` prefix, its C++ ring is built
into ``build/ray_tpu_torch/`` and is the default, a failed build raises
with the compiler's output instead of falling back, and the numpy ring is
used only when asked for (``backend="py"``, or
``RAY_TPU_TORCH_DISABLE_NATIVE=1``).

Cost: no runtime; the first test builds the C++ ring with g++ (a few
seconds) unless ``build/ray_tpu_torch/`` holds it already.
"""

import os
import pickle
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch._native as port_native
from ray_tpu.experimental.channel import ShmChannel as RefChannel
from ray_tpu_torch.experimental.channel import ShmChannel as PortChannel

BACKENDS = ["native", "py"]
CHANNELS = {"ray_tpu": RefChannel, "ray_tpu_torch": PortChannel}


def _order_across_wrap(Ch, backend):
    ch = Ch.create(shape=(3, 2), dtype="int64", capacity=3, backend=backend)
    try:
        got = []
        for i in range(10):  # the ring wraps three times
            ch.write(np.full((3, 2), i, np.int64), timeout_s=5)
            if i % 2:
                got += [int(ch.read(timeout_s=5)[0, 0]) for _ in range(2)]
        return ch.backend, got
    finally:
        ch.close(unlink=True)


def _full_and_empty(Ch, backend):
    ch = Ch.create(shape=(1,), dtype="int8", capacity=2, backend=backend)
    out = []
    try:
        out.append(ch.try_read() is None)
        ch.write(np.ones(1, np.int8))
        ch.write(np.full(1, 2, np.int8))
        with pytest.raises(TimeoutError):
            ch.write(np.zeros(1, np.int8), timeout_s=0.1)
        out.append(int(ch.try_read()[0]))
        out.append(int(ch.read(timeout_s=1)[0]))
        with pytest.raises(TimeoutError):
            ch.read(timeout_s=0.1)
        out.append(ch.try_read() is None)
        return out
    finally:
        ch.close(unlink=True)


def _blocking_read(Ch, backend):
    ch = Ch.create(shape=(4,), dtype="float32", capacity=2, backend=backend)
    try:
        def late_writer():
            time.sleep(0.2)
            ch.write(np.arange(4, dtype=np.float32))

        t = threading.Thread(target=late_writer)
        t0 = time.perf_counter()
        t.start()
        out = ch.read(timeout_s=10)
        waited = time.perf_counter() - t0
        t.join()
        return out.tolist(), waited >= 0.15
    finally:
        ch.close(unlink=True)


def _pickled_descriptor(Ch, backend):
    ch = Ch.create(shape=(4,), dtype="float32", capacity=2, backend=backend)
    try:
        other = pickle.loads(pickle.dumps(ch))
        ch.write(np.arange(4, dtype=np.float32))
        got = other.read(timeout_s=5).tolist()
        other.write(np.full(4, 7.0, np.float32))
        back = ch.read(timeout_s=5).tolist()
        same = (other.name, other.shape, other.dtype, other.capacity, other.backend) == (
            ch.name, ch.shape, ch.dtype, ch.capacity, ch.backend)
        other.close()
        return got, back, same
    finally:
        ch.close(unlink=True)


def _shape_check(Ch, backend):
    ch = Ch.create(shape=(2, 2), dtype="float32", backend=backend)
    try:
        with pytest.raises(ValueError, match="shape"):
            ch.write(np.zeros((3,), dtype=np.float32))
        return True
    finally:
        ch.close(unlink=True)


PROGRAMS = [_order_across_wrap, _full_and_empty, _blocking_read, _pickled_descriptor,
            _shape_check]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("program", PROGRAMS, ids=lambda p: p.__name__.strip("_"))
def test_same_program_same_result(program, backend):
    assert program(PortChannel, backend) == program(RefChannel, backend)


def test_default_backend_is_the_native_ring_with_the_port_prefix():
    ch = PortChannel.create(shape=(4,), dtype="float32")
    ref = RefChannel.create(shape=(4,), dtype="float32")
    try:
        assert ch.backend == "native"
        assert ch.name.startswith("ray_tpu_torch_ch_") and not ref.name.startswith("ray_tpu_torch")
        so = str(port_native.build_extension(
            "_ring_native", port_native._SRC_DIR / "ring_channel.cpp"))
        assert os.sep.join(["build", "ray_tpu_torch", "_ring_native_"]) in so
        # the two packages' rings are separate extension modules
        assert port_native.ring_native().__file__ == so
    finally:
        ch.close(unlink=True)
        ref.close(unlink=True)


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    (tmp_path / "ring_channel.cpp").write_text("this is not C++;\n")
    with pytest.raises(RuntimeError, match="native build of ring_channel.cpp failed") as e:
        port_native.build_extension("_broken", tmp_path / "ring_channel.cpp", tmp_path)
    assert "error" in str(e.value)  # g++'s own log comes with it
    assert not list(tmp_path.glob("*.so"))
    monkeypatch.setattr(port_native, "_ring_mod", None)
    monkeypatch.setattr(port_native, "_SRC_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="native build"):
        PortChannel.create(shape=(4,), dtype="float32")
    # the numpy ring only when asked for, and then no build is tried
    monkeypatch.setenv("RAY_TPU_TORCH_DISABLE_NATIVE", "1")
    ch = PortChannel.create(shape=(4,), dtype="float32")
    try:
        assert ch.backend == "py" and port_native._ring_mod is None
    finally:
        ch.close(unlink=True)
    with pytest.raises(ValueError, match="backend"):
        PortChannel.create(shape=(4,), dtype="float32", backend="numpy")


def test_native_round_trip_is_far_under_the_numpy_poll_floor():
    """Self ping-pong median, as the reference's latency smoke bounds it."""
    ch = PortChannel.create(shape=(64,), dtype="float32", capacity=2)
    arr = np.zeros(64, np.float32)
    try:
        ch.write(arr)
        ch.read()
        lat = []
        for _ in range(200):
            t0 = time.perf_counter()
            ch.write(arr)
            ch.read()
            lat.append(time.perf_counter() - t0)
        assert sorted(lat)[len(lat) // 2] < 0.005
    finally:
        ch.close(unlink=True)
