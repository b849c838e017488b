// Fused lm-head cross-entropy forward for Hopper (sm_90a), on the wgmma/TMA
// GEMM core of wgmma_gemm.cuh.
//
// Replaces: ray_tpu/ops/pallas_ce.py `_fwd_call` (:95), the
// `pl.pallas_call` at :109 of kernel `_fwd_kernel` (:52).
//
// For x (N, D) bf16, w (D, V) bf16 and clamped targets (N,) int32 it
// writes lse_i = logsumexp_v (x_i . w_v) and tgt_i = x_i . w_{targets_i},
// both f32; the caller's loss is lse - tgt. The (N, V) logits never reach
// device memory.
//
// Bound on the H100: at the scoring shape (N 16384, D 2048, V 32000) the
// product is 2 N D V = 2.15 TFLOP against ~200 MB of inputs, so the tensor
// cores bound it (2.17 ms at the dense bf16 peak).
//
// Design: ce_partial_kernel is the GEMM of the CE backward's dlog kernel
// (M = N, N = V, K = D; A = x K-major, B = w MN-major, 128 x 256 tiles, a
// producer warpgroup feeding 4 TMA stages, two consumer warpgroups on
// wgmma m64n256k16) with another epilogue: each consumer reduces its
// 64 x 256 f32 tile per row to the row's max (log2 units), the sum of exp2
// against that max, and the target logit when the target falls in the
// tile (columns past V count as -inf). A row's 256 columns lie in the 4
// threads of a quad, 64 each, so the reductions are local then two
// shuffles. Each tile writes one partial per row, struct-of-arrays (3,
// vocab tiles, N) so that a warp's stores land in one sector; the small
// ce_combine_kernel merges the vocab tiles into lse and tgt.
// At full N, x (64 MB) is larger than the 50 MB L2: the core walks the
// tiles in groups of 32 row tiles (16 MB of x) across all of V, so x is
// read from device memory about once and w once per group (4 times).
// What is left between it and the bound: each tile's epilogue (exp2 over
// 32768 logits) runs while the tensor cores wait, as in the dlog kernel;
// ping-pong consumers would overlap it.
// Deterministic: every partial has one owner, the combine sums in order.

#include <math_constants.h>

#include "wgmma_gemm.cuh"

namespace rtt {
namespace {

using gemm::Major;

struct CeFwdParams {
  CUtensorMap a;                 // x (N, D), boxes 128 x 64
  CUtensorMap b;                 // w (D, V), boxes 64 x 64
  const int* targets;
  float* part;                   // (3, n_vt, N): max (log2 units), sum, target logit
  int N, D, V, n_vt;

  static constexpr int kEpiBytes = 0;

  __device__ __forceinline__ void store(float (&acc)[gemm::kAcc], int m0, int n0, int c, int tid,
                                        uint8_t*) const {
    const int w = tid >> 5, gq = (tid & 31) >> 2, q = tid & 3;
    const long long plane = static_cast<long long>(n_vt) * N;
    float* out = part + static_cast<long long>(n0 / gemm::kBN) * N;
    // this thread's columns are n0 + 2q + (8j + e), j < 32, e < 2; they lie
    // below V while 8j + e < lim, all of them in every vocab tile but a
    // ragged last one
    const bool full = n0 + gemm::kBN <= V;
    const int lim = V - n0 - 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 64 * c + 16 * w + gq + 8 * h;
      float mx = -CUDART_INF_F, m2, sum = 0.f, tg = 0.f;
      // every tile holds at least one column < V, so the max is finite. A
      // full tile skips the column test: the ragged loop alone is exact on
      // it too, but spills registers and makes K4 ~9% slower (PERF.md)
      if (full) {
#pragma unroll
        for (int j = 0; j < gemm::kBN / 8; ++j)
          mx = fmaxf(mx, fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
        m2 = quad_max(mx) * kLog2e;
#pragma unroll
        for (int i = 0; i < gemm::kBN / 4; ++i)
          sum += exp2f(fmaf(acc[4 * (i >> 1) + 2 * h + (i & 1)], kLog2e, -m2));
      } else {
#pragma unroll
        for (int i = 0; i < gemm::kBN / 4; ++i)
          if (8 * (i >> 1) + (i & 1) < lim) mx = fmaxf(mx, acc[4 * (i >> 1) + 2 * h + (i & 1)]);
        m2 = quad_max(mx) * kLog2e;
#pragma unroll
        for (int i = 0; i < gemm::kBN / 4; ++i)
          if (8 * (i >> 1) + (i & 1) < lim)
            sum += exp2f(fmaf(acc[4 * (i >> 1) + 2 * h + (i & 1)], kLog2e, -m2));
      }
      const int tc = (row < N ? targets[row] : -1) - n0 - 2 * q;
      if (tc >= 0 && tc < gemm::kBN) {                    // the target is in this tile
#pragma unroll
        for (int i = 0; i < gemm::kBN / 4; ++i)
          if (8 * (i >> 1) + (i & 1) == tc) tg = acc[4 * (i >> 1) + 2 * h + (i & 1)];
      }
      sum = quad_sum(sum);
      tg = quad_sum(tg);
      if (q == 0 && row < N) {
        out[row] = m2;
        out[plane + row] = sum;
        out[2 * plane + row] = tg;
      }
    }
  }
};

__global__ void __launch_bounds__(gemm::kThreads, 1)
    ce_partial_kernel(const __grid_constant__ CeFwdParams p) {
  gemm::run<Major::K, Major::MN>(&p.a, &p.b, p, p.N, p.V, p.D);
}

__global__ void ce_combine_kernel(const float* __restrict__ part, float* __restrict__ lse,
                                  float* __restrict__ tgt, int N, int n_vt) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  const long long plane = static_cast<long long>(n_vt) * N;
  float m = -CUDART_INF_F;
  for (int v = 0; v < n_vt; ++v) m = fmaxf(m, part[static_cast<long long>(v) * N + r]);
  float l = 0.f, g = 0.f;
  for (int v = 0; v < n_vt; ++v) {
    const long long i = static_cast<long long>(v) * N + r;
    l += part[plane + i] * exp2f(part[i] - m);
    g += part[2 * plane + i];
  }
  lse[r] = m * kLn2 + logf(l);
  tgt[r] = g;
}

}  // namespace
}  // namespace rtt

// x (N,D) and w (D,V) bf16 contiguous and 16-byte aligned, targets (N,)
// int32 already clamped to [0, V). part is scratch of 3 * n_vt * N f32,
// n_vt the caller's count of vocab tiles, which must be ceil(V/256); lse
// and tgt are (N,) f32. D and V must be multiples of 8 (16-byte rows for
// TMA).
extern "C" int rtt_fused_ce_fwd(const void* x, const void* w, const void* targets,
                                void* part, void* lse, void* tgt, int N, int D, int V,
                                int n_vt, void* stream) {
  using namespace rtt;
  if (N <= 0 || D <= 0 || V <= 0 || D % 8 || V % 8) return (int)cudaErrorInvalidValue;
  if (n_vt != (V + gemm::kBN - 1) / gemm::kBN) return (int)cudaErrorInvalidValue;
  CeFwdParams p{};
  cudaError_t err = gemm::make_map(&p.a, x, N, D, 128, 64);
  if (err == cudaSuccess) err = gemm::make_map(&p.b, w, D, V, 64, 64);
  if (err != cudaSuccess) return (int)err;
  p.targets = static_cast<const int*>(targets);
  p.part = static_cast<float*>(part);
  p.N = N;
  p.D = D;
  p.V = V;
  p.n_vt = n_vt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = gemm::launch(ce_partial_kernel, p, N, V, st);
  if (err != cudaSuccess) return (int)err;
  ce_combine_kernel<<<(N + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(lse), static_cast<float*>(tgt), N,
      p.n_vt);
  return (int)cudaGetLastError();
}
