// Fused lm-head cross-entropy backward for Hopper (sm_90a): for one chunk
// of rows, a dlog kernel forms dlog once, and a dx and a dW kernel each
// take it into one product. All three run on the wgmma/TMA core of
// wgmma_gemm.cuh.
//
// Replaces: ray_tpu/ops/pallas_ce.py `_bwd_call` (:201), the
// `pl.pallas_call`s at :208 (`_dx_kernel`, :142) and :229 (`_dw_kernel`,
// :171).
//
// For a chunk x_c (Nc, D) bf16 of x, w (D, V) bf16, the chunk's clamped
// targets (int32), the forward's lse and the upstream gradient g (f32):
//   ce_bwd_dlog_kernel: dlog_c = bf16((exp(x_c w - lse) - onehot(t)) * g)
//                       GEMM M = Nc, N = V, K = D; A = x_c K-major, B = w
//                       MN-major; the epilogue forms dlog and stores it with
//                       TMA into the chunk's (Nc, V) bf16 buffer;
//   ce_bwd_dx_kernel:   dx_c = bf16(dlog_c w^T)
//                       M = Nc, N = D, K = V; A = dlog_c K-major, B = w read
//                       as (N = D, K = V), K-major; the chunk holds all of V,
//                       so dx_c is finished in registers and written once;
//   ce_bwd_dw_kernel:   acc (D, V) f32 (+)= x_c^T dlog_c, or on the last chunk
//                       dW = bf16(acc + x_c^T dlog_c)
//                       M = D, N = V, K = Nc; A = x_c^T MN-major, B = dlog_c
//                       MN-major.
// dlog is rounded to bf16 once, where the reference rounds it (:162,
// :192), and that one buffer feeds both products. The caller
// (ops/cuda_ce.py) walks the chunks; no buffer of N x V elements exists.
//
// Bound on the H100: at the training shape (N 16384, D 2048, V 32000) the
// backward needs the logits once, dx and dW: 6 N D V = 6.44 TFLOP, 6.52 ms
// at the dense bf16 peak; each kernel does a third of it. The tensor cores
// bound all three (each moves ~0.3-1 GB per chunk, <0.3 ms at 3.35 TB/s).
//
// Design against that bound: wgmma m64n256k16 reads both operands from
// 128-byte-swizzled shared memory (no ldmatrix reloads per warp), 128 x 256
// tiles give 85 FLOP per byte loaded into shared memory, a producer warp
// keeps TMA loads of 4 stages in flight, and every kernel walks its tiles
// in a persistent loop, M fastest within the core's raster groups of 32
// row tiles (at the training shape each kernel's M is one group), so the
// CTAs in flight share their operand tiles in L2. The dW sum costs an f32
// read and write of D x V per chunk after the first (~0.5 ms in all at the
// training shape, 4 chunks); dx keeps no f32 copy. What is left between these kernels and the bound
// is mostly each tile's epilogue, which no product overlaps (dlog 4000
// tiles and dW 2000 per chunk at the training shape, dx 256).
// Deterministic: no atomics, every output element has one owner, chunks
// run in order.

#include "wgmma_gemm.cuh"

namespace rtt {
namespace {

using gemm::Major;

struct DlogParams {
  CUtensorMap a;                 // x_c (rows, D), boxes 128 x 64
  CUtensorMap b;                 // w (D, V), boxes 64 x 64
  CUtensorMap out;               // dlog (rows, V), boxes 64 x 64 (store)
  const int* targets;
  const float* lse;
  const float* g;
  int rows, D, V;

  // Per consumer: 64 rows x 128 columns (half its tile) as two swizzled
  // 64 x 64 boxes; the tile goes out in two halves, so 4 stages still fit.
  static constexpr int kEpiBytes = 2 * 2 * gemm::kBox;

  __device__ __forceinline__ void store(float (&acc)[gemm::kAcc], int m0, int n0, int c, int tid,
                                        uint8_t* epi) const {
    const int w = tid >> 5, gq = (tid & 31) >> 2, q = tid & 3;
    uint8_t* buf = epi + c * 2 * gemm::kBox;
    float lse2[2], gi[2];
    int tr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 64 * c + 16 * w + gq + 8 * h;
      const bool ok = row < rows;    // rows past the chunk get g = 0: dlog 0
      lse2[h] = ok ? lse[row] * kLog2e : 0.f;
      gi[h] = ok ? g[row] : 0.f;
      tr[h] = ok ? targets[row] : -1;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (tid == 0) bulk_wait_read();   // the last stores are out of buf
      named_bar_sync(1 + c, 128);
#pragma unroll
      for (int j = 0; j < gemm::kBN / 16; ++j) {
        const int jj = gemm::kBN / 16 * half + j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = n0 + 8 * jj + 2 * q;
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            d[e] = col + e < V ? (exp2f(acc[4 * jj + 2 * h + e] * kLog2e - lse2[h]) -
                                  (col + e == tr[h] ? 1.f : 0.f)) * gi[h]
                               : 0.f;
          const int r = 16 * w + gq + 8 * h;  // r % 8 == gq: the 128-byte swizzle
          *reinterpret_cast<uint32_t*>(buf + (j >> 3) * gemm::kBox + r * 128 +
                                       (((j & 7) ^ gq) << 4) + 4 * q) = pack_bf16(d[0], d[1]);
        }
      }
      fence_proxy_async();
      named_bar_sync(1 + c, 128);
      if (tid == 0) {
#pragma unroll
        for (int b = 0; b < 2; ++b)
          tma_store(&out, buf + b * gemm::kBox, n0 + 128 * half + 64 * b, m0 + 64 * c);
        bulk_commit();
      }
    }
  }
};

struct DxParams {
  CUtensorMap a;                 // dlog (rows, V), boxes 128 x 64
  CUtensorMap b;                 // w (D, V), boxes 256 x 64
  bf16* dx;                      // (rows, D)
  int rows, D, V;

  static constexpr int kEpiBytes = 0;

  __device__ __forceinline__ void store(float (&acc)[gemm::kAcc], int m0, int n0, int c, int tid,
                                        uint8_t*) const {
    const int w = tid >> 5, gq = (tid & 31) >> 2, q = tid & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 64 * c + 16 * w + gq + 8 * h;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < gemm::kBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * q;        // D % 8 == 0: col < D covers col + 1
        if (col < D)
          *reinterpret_cast<uint32_t*>(dx + static_cast<long long>(row) * D + col) =
              pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
};

struct DwParams {
  CUtensorMap a;                 // x_c (rows, D), boxes 64 x 64, read as x_c^T
  CUtensorMap b;                 // dlog (rows, V), boxes 64 x 64
  float* acc;                    // (D, V) f32 across chunks
  bf16* dw;                      // (D, V), written by the last chunk
  int rows, D, V;
  int accumulate;                // add the acc of the chunks before
  int last;                      // write bf16 dW, else f32 acc

  static constexpr int kEpiBytes = 0;

  // The sum is read in batches of 16 loads issued before their stores: a
  // load after a store to the same array cannot be hoisted above it, so
  // one at a time each would wait a full round trip.
  __device__ __forceinline__ void store(float (&d)[gemm::kAcc], int m0, int n0, int c, int tid,
                                        uint8_t*) const {
    const int w = tid >> 5, gq = (tid & 31) >> 2, q = tid & 3;
    constexpr int kBatch = 8;                               // j per batch, both rows
    long long base[2];
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 64 * c + 16 * w + gq + 8 * h;    // d index
      ok[h] = row < D;
      base[h] = static_cast<long long>(row) * V + n0 + 2 * q;
    }
#pragma unroll
    for (int j0 = 0; j0 < gemm::kBN / 8; j0 += kBatch) {
      float2 s[2][kBatch];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const bool in = ok[h] && n0 + 8 * (j0 + j) + 2 * q < V;
          s[h][j] = accumulate && in
                        ? *reinterpret_cast<const float2*>(acc + base[h] + 8 * (j0 + j))
                        : make_float2(-0.f, -0.f);        // x + -0 == x, exactly
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int jj = j0 + j;
          if (!ok[h] || n0 + 8 * jj + 2 * q >= V) continue;   // vocab index past V
          const float2 v = make_float2(d[4 * jj + 2 * h] + s[h][j].x,
                                       d[4 * jj + 2 * h + 1] + s[h][j].y);
          if (last)
            *reinterpret_cast<uint32_t*>(dw + base[h] + 8 * jj) = pack_bf16(v.x, v.y);
          else
            *reinterpret_cast<float2*>(acc + base[h] + 8 * jj) = v;
        }
    }
  }
};

__global__ void __launch_bounds__(gemm::kThreads, 1)
    ce_bwd_dlog_kernel(const __grid_constant__ DlogParams p) {
  gemm::run<Major::K, Major::MN>(&p.a, &p.b, p, p.rows, p.V, p.D);
}

__global__ void __launch_bounds__(gemm::kThreads, 1)
    ce_bwd_dx_kernel(const __grid_constant__ DxParams p) {
  gemm::run<Major::K, Major::K>(&p.a, &p.b, p, p.rows, p.D, p.V);
}

__global__ void __launch_bounds__(gemm::kThreads, 1)
    ce_bwd_dw_kernel(const __grid_constant__ DwParams p) {
  gemm::run<Major::MN, Major::MN>(&p.a, &p.b, p, p.D, p.V, p.rows);
}

bool bad_shape(int rows, int D, int V) {
  return rows <= 0 || D <= 0 || V <= 0 || D % 8 || V % 8;
}

}  // namespace
}  // namespace rtt

// All matrices bf16, contiguous, 16-byte aligned; D and V multiples of 8.
// x (rows, D) and targets, lse, g (rows,) are the chunk's rows; targets
// already clamped to [0, V). Each returns a CUDA error code (0: launched).

// dlog (rows, V) = bf16((softmax(x w) - onehot(targets)) * g).
extern "C" int rtt_fused_ce_bwd_dlog(const void* x, const void* w, const void* targets,
                                     const void* lse, const void* g, void* dlog, int rows, int D,
                                     int V, void* stream) {
  using namespace rtt;
  if (bad_shape(rows, D, V)) return (int)cudaErrorInvalidValue;
  DlogParams p{};
  cudaError_t err = gemm::make_map(&p.a, x, rows, D, 128, 64);
  if (err == cudaSuccess) err = gemm::make_map(&p.b, w, D, V, 64, 64);
  if (err == cudaSuccess) err = gemm::make_map(&p.out, dlog, rows, V, 64, 64);
  if (err != cudaSuccess) return (int)err;
  p.targets = static_cast<const int*>(targets);
  p.lse = static_cast<const float*>(lse);
  p.g = static_cast<const float*>(g);
  p.rows = rows;
  p.D = D;
  p.V = V;
  return (int)gemm::launch(ce_bwd_dlog_kernel, p, rows, V, static_cast<cudaStream_t>(stream));
}

// dx (rows, D) = bf16(dlog (rows, V) w^T).
extern "C" int rtt_fused_ce_bwd_dx(const void* dlog, const void* w, void* dx, int rows, int D,
                                   int V, void* stream) {
  using namespace rtt;
  if (bad_shape(rows, D, V)) return (int)cudaErrorInvalidValue;
  DxParams p{};
  cudaError_t err = gemm::make_map(&p.a, dlog, rows, V, 128, 64);
  if (err == cudaSuccess) err = gemm::make_map(&p.b, w, D, V, 256, 64);
  if (err != cudaSuccess) return (int)err;
  p.dx = static_cast<bf16*>(dx);
  p.rows = rows;
  p.D = D;
  p.V = V;
  return (int)gemm::launch(ce_bwd_dx_kernel, p, rows, D, static_cast<cudaStream_t>(stream));
}

// x (rows, D)^T dlog (rows, V), added to acc (D, V) f32 when accumulate;
// written to acc (f32) or, when last, to dw (D, V) bf16.
extern "C" int rtt_fused_ce_bwd_dw(const void* x, const void* dlog, void* acc, void* dw, int rows,
                                   int D, int V, int accumulate, int last, void* stream) {
  using namespace rtt;
  if (bad_shape(rows, D, V)) return (int)cudaErrorInvalidValue;
  DwParams p{};
  cudaError_t err = gemm::make_map(&p.a, x, rows, D, 64, 64);
  if (err == cudaSuccess) err = gemm::make_map(&p.b, dlog, rows, V, 64, 64);
  if (err != cudaSuccess) return (int)err;
  p.acc = static_cast<float*>(acc);
  p.dw = static_cast<bf16*>(dw);
  p.rows = rows;
  p.D = D;
  p.V = V;
  p.accumulate = accumulate;
  p.last = last;
  return (int)gemm::launch(ce_bwd_dw_kernel, p, D, V, static_cast<cudaStream_t>(stream));
}
