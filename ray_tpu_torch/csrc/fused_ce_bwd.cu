// Fused lm-head cross-entropy backward for Hopper (sm_90a): a dx kernel
// and a dW kernel, each recomputing the logits tile by tile.
//
// Replaces: ray_tpu/ops/pallas_ce.py `_bwd_call` (:201), the
// `pl.pallas_call`s at :208 (`_dx_kernel`, :142) and :229 (`_dw_kernel`,
// :171).
//
// For x (N, D) bf16, w (D, V) bf16, clamped targets (N,) int32, the
// forward's lse (N,) f32 and the upstream gradient g (N,) f32:
//   dlog = (exp(x w - lse) - onehot(targets)) * g       (f32, per tile)
//   dx = bf16(dlog) w^T  -> (N, D) bf16;  dW = x^T bf16(dlog) -> (D, V) bf16,
// the casts where the reference casts (:162, :192). The (N, V) logits
// never reach device memory.
//
// Bound on the H100: at the training shape (N 16384, D 2048, V 32000)
// each kernel does two products of 2NDV (the logits again, then its
// gradient): 4.29 TFLOP, 4.34 ms at the dense bf16 peak, against ~200 MB
// of inputs. The tensor cores bound both.
//
// The difficulty: the TPU kernels kept the whole output accumulator in
// VMEM (dx: block_n x D f32 = 1 MB; dW: D x block_v f32 = 4 MB), and a
// logits tile needs the whole D contraction before its dlog exists, so
// the output cannot be split over D without recomputing the logits per
// D slice. A Hopper CTA has 227 KB of shared memory. Design: each CTA
// owns one output block that spans all of D (dx: 128 rows; dW: 128 vocab
// columns) and walks the other dimension in ROUNDS of 512 (dx: vocab;
// dW: rows). In a round it computes four 128 x 128 logits tiles (K loop
// over D through a 3-stage cp.async ring, mma.sync m16n8k16 with f32
// accumulation, 8 warps of 16 rows), turns them into dlog and keeps the
// 128 x 512 (or 512 x 128) bf16 dlog in shared memory (136 KB); then it
// runs the gradient product over D in chunks of 128 output columns (f32
// registers), K = the round's 512, and adds each chunk into an f32
// scratch copy of the output in device memory that only this CTA
// touches; the last round writes the bf16 output instead. The logits are
// computed once per kernel, as in the reference; the cost of the design
// is that read-modify-write of the f32 scratch, once per round: 2 x 4 B x
// N x D x V/512 = 16.8 GB for dx and as much for dW at the training
// shape, plus W (dx) or x (dW) read twice per round from L2.
// Deterministic: no atomics, every output element has one owner. Grid:
// dx ceil(N/128) CTAs, dW ceil(V/128). The ragged edges of N, D and V
// are masked (zero-filled loads, dlog 0 outside).
//
// Not yet used (later PRs): TMA, wgmma, warp specialisation, one pass
// that forms dlog once for both products.

#include "common.cuh"

namespace rtt {
namespace {

constexpr int kBM = 128;        // rows of a logits tile (16 per warp)
constexpr int kBN = 128;        // vocab columns of a logits tile
constexpr int kBK = 32;         // K step
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kRound = 4;       // logits tiles per round
constexpr int kLDA = kBK + 8;   // padded smem rows (elements)
constexpr int kLDB = kBN + 8;
constexpr int kStageElems = kBM * kLDA + kBK * kLDB;
constexpr int kRingElems = kStages * kStageElems;
constexpr int kLDG_DX = kRound * kBN + 8;    // dlog [128 rows][512 vocab]
constexpr int kLDG_DW = kBN + 8;             // dlog [512 rows][128 vocab]
constexpr int kDlogElems = kRound * kBM * kLDG_DW > kBM * kLDG_DX
                               ? kRound * kBM * kLDG_DW : kBM * kLDG_DX;
constexpr int kSmem = (kRingElems + kDlogElems) * 2;

struct CeBwdParams {
  const bf16* x;
  const bf16* w;
  const int* targets;
  const float* lse;
  const float* g;
  float* scratch;                // f32 copy of the output, (N, D) or (D, V)
  bf16* out;                     // dx (N, D) or dW (D, V)
  int N, D, V;
};

// x rows row0.. x K step k0 and w K step k0 x vocab col0.. into one stage.
__device__ __forceinline__ void load_logits_stage(bf16* st, const CeBwdParams& p, int row0,
                                                  int col0, int k0, int tid) {
  bf16* sA = st;
  bf16* sB = st + kBM * kLDA;
#pragma unroll
  for (int i = 0; i < 2; ++i) {              // A: 128 x 32 = 512 chunks
    const int c = tid + i * kThreads;
    const int r = c >> 2, cc = c & 3;
    const int row = row0 + r, col = k0 + cc * 8;
    const bool ok = row < p.N && col < p.D;
    cp_async16(sA + r * kLDA + cc * 8, ok ? p.x + (long long)row * p.D + col : p.x, ok);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {              // B: 32 x 128 = 512 chunks
    const int c = tid + i * kThreads;
    const int r = c >> 4, cc = c & 15;
    const int d = k0 + r, col = col0 + cc * 8;
    const bool ok = d < p.D && col < p.V;
    cp_async16(sB + r * kLDB + cc * 8, ok ? p.w + (long long)d * p.V + col : p.w, ok);
  }
}

// dlog of rows row0..row0+127 x vocab col0..col0+127, stored bf16 at
// dst[r * ld + c] (r, c local). Uses and then frees the ring.
__device__ void dlog_tile(const CeBwdParams& p, bf16* ring, int row0, int col0,
                          bf16* dst, int ld) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nK = (p.D + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nK) load_logits_stage(ring + s * kStageElems, p, row0, col0, s * kBK, tid);
    cp_async_commit();
  }
  float acc[kBN / 8][4];
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int it = 0; it < nK; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                          // stage `it` here; every warp is done with it-1
    const int nx = it + kStages - 1;
    if (nx < nK)
      load_logits_stage(ring + (nx % kStages) * kStageElems, p, row0, col0, nx * kBK, tid);
    cp_async_commit();
    const bf16* sA = ring + (it % kStages) * kStageElems;
    const bf16* sB = sA + kBM * kLDA;
#pragma unroll
    for (int k16 = 0; k16 < kBK / 16; ++k16) {
      uint32_t a[4];
      ldmatrix_x4(a, sA + (warp * 16 + (lane & 15)) * kLDA + k16 * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nb2 = 0; nb2 < kBN / 16; ++nb2) {
        uint32_t bw[4];
        ldmatrix_x4_trans(bw, sB + (k16 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLDB
                                  + nb2 * 16 + (lane >> 4) * 8);
        mma_16816(acc[2 * nb2], a, bw[0], bw[1]);
        mma_16816(acc[2 * nb2 + 1], a, bw[2], bw[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                            // the ring is free for its next user

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int lr = warp * 16 + g + 8 * i, row = row0 + lr;
    const bool ok = row < p.N;
    // rows past N get g = 0: their dlog is exactly 0
    const float lse2 = ok ? p.lse[row] * kLog2e : 0.f;
    const float gi = ok ? p.g[row] : 0.f;
    const int tr = ok ? p.targets[row] : -1;
#pragma unroll
    for (int nb = 0; nb < kBN / 8; ++nb) {
      float d[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = col0 + nb * 8 + 2 * t + j;
        d[j] = col < p.V
                   ? (exp2f(acc[nb][2 * i + j] * kLog2e - lse2) - (col == tr ? 1.f : 0.f)) * gi
                   : 0.f;
      }
      *reinterpret_cast<uint32_t*>(dst + lr * ld + nb * 8 + 2 * t) = pack_bf16(d[0], d[1]);
    }
  }
}

// Add a 128 x 128 f32 chunk (8 warps of 16 rows) into the scratch at
// (m0, n0) of an (M, Nn) row-major output; the last round writes bf16.
__device__ __forceinline__ void add_chunk(const CeBwdParams& p, const float (&acc)[kBN / 8][4],
                                          int m0, int n0, int M, int Nn, bool first, bool last) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + warp * 16 + g + 8 * i;
    if (m >= M) continue;
#pragma unroll
    for (int nb = 0; nb < kBN / 8; ++nb) {
      const int n = n0 + nb * 8 + 2 * t;
      if (n >= Nn) continue;
      const long long off = (long long)m * Nn + n;
      float2 v = make_float2(acc[nb][2 * i], acc[nb][2 * i + 1]);
      if (!first) {
        const float2 s = *reinterpret_cast<const float2*>(p.scratch + off);
        v.x += s.x;
        v.y += s.y;
      }
      if (last)
        *reinterpret_cast<uint32_t*>(p.out + off) = pack_bf16(v.x, v.y);
      else
        *reinterpret_cast<float2*>(p.scratch + off) = v;
    }
  }
}

// dx: W rows d0..d0+127 x vocab v0+k0..+31 into a stage laid out [d][v].
__device__ __forceinline__ void load_w_stage(bf16* st, const CeBwdParams& p, int d0, int v,
                                             int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {              // 128 x 32 = 512 chunks
    const int c = tid + i * kThreads;
    const int r = c >> 2, cc = c & 3;
    const int d = d0 + r, col = v + cc * 8;
    const bool ok = d < p.D && col < p.V;
    cp_async16(st + r * kLDA + cc * 8, ok ? p.w + (long long)d * p.V + col : p.w, ok);
  }
}

// dW: x rows n..n+31 x d0..d0+127 into a stage laid out [row][d].
__device__ __forceinline__ void load_x_stage(bf16* st, const CeBwdParams& p, int n, int d0,
                                             int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {              // 32 x 128 = 512 chunks
    const int c = tid + i * kThreads;
    const int r = c >> 4, cc = c & 15;
    const int row = n + r, d = d0 + cc * 8;
    const bool ok = row < p.N && d < p.D;
    cp_async16(st + r * kLDB + cc * 8, ok ? p.x + (long long)row * p.D + d : p.x, ok);
  }
}

__global__ void __launch_bounds__(kThreads) ce_bwd_dx_kernel(const CeBwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* sG = ring + kRingElems;               // dlog [128 rows][512 vocab]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kBM;
  const int n_vt = (p.V + kBN - 1) / kBN;
  const int n_rounds = (n_vt + kRound - 1) / kRound;
  const int n_dc = (p.D + kBN - 1) / kBN;

  for (int rd = 0; rd < n_rounds; ++rd) {
    const int vt0 = rd * kRound;
    const int tiles = min(kRound, n_vt - vt0);
    for (int tl = 0; tl < tiles; ++tl)
      dlog_tile(p, ring, row0, (vt0 + tl) * kBN, sG + tl * kBN, kLDG_DX);
    __syncthreads();                          // dlog of the round here
    const int v0 = vt0 * kBN;
    const int nK = tiles * (kBN / kBK);
    for (int dc = 0; dc < n_dc; ++dc) {
      const int d0 = dc * kBN;
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < nK) load_w_stage(ring + s * kStageElems, p, d0, v0 + s * kBK, tid);
        cp_async_commit();
      }
      float acc[kBN / 8][4];
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      for (int it = 0; it < nK; ++it) {
        cp_async_wait<kStages - 2>();
        __syncthreads();
        const int nx = it + kStages - 1;
        if (nx < nK) load_w_stage(ring + (nx % kStages) * kStageElems, p, d0, v0 + nx * kBK, tid);
        cp_async_commit();
        const bf16* sW = ring + (it % kStages) * kStageElems;   // [d][v]
#pragma unroll
        for (int k16 = 0; k16 < kBK / 16; ++k16) {
          uint32_t a[4];                      // dlog rows x vocab
          ldmatrix_x4(a, sG + (warp * 16 + (lane & 15)) * kLDG_DX + it * kBK + k16 * 16
                             + (lane >> 4) * 8);
#pragma unroll
          for (int nb2 = 0; nb2 < kBN / 16; ++nb2) {
            uint32_t b[4];                    // w^T: n = d, k = vocab
            ldmatrix_x4(b, sW + (nb2 * 16 + (lane & 7) + (lane >> 4) * 8) * kLDA
                               + k16 * 16 + ((lane >> 3) & 1) * 8);
            mma_16816(acc[2 * nb2], a, b[0], b[1]);
            mma_16816(acc[2 * nb2 + 1], a, b[2], b[3]);
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();                        // the ring is free
      add_chunk(p, acc, row0, d0, p.N, p.D, rd == 0, rd == n_rounds - 1);
    }
  }
}

__global__ void __launch_bounds__(kThreads) ce_bwd_dw_kernel(const CeBwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* sG = ring + kRingElems;               // dlog [512 rows][128 vocab]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int v0 = blockIdx.x * kBN;
  const int n_rt = (p.N + kBM - 1) / kBM;
  const int n_rounds = (n_rt + kRound - 1) / kRound;
  const int n_dc = (p.D + kBN - 1) / kBN;

  for (int rd = 0; rd < n_rounds; ++rd) {
    const int rt0 = rd * kRound;
    const int tiles = min(kRound, n_rt - rt0);
    for (int tl = 0; tl < tiles; ++tl)
      dlog_tile(p, ring, (rt0 + tl) * kBM, v0, sG + tl * kBM * kLDG_DW, kLDG_DW);
    __syncthreads();                          // dlog of the round here
    const int n0 = rt0 * kBM;
    const int nK = tiles * (kBM / kBK);
    for (int dc = 0; dc < n_dc; ++dc) {
      const int d0 = dc * kBN;
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < nK) load_x_stage(ring + s * kStageElems, p, n0 + s * kBK, d0, tid);
        cp_async_commit();
      }
      float acc[kBN / 8][4];
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      for (int it = 0; it < nK; ++it) {
        cp_async_wait<kStages - 2>();
        __syncthreads();
        const int nx = it + kStages - 1;
        if (nx < nK) load_x_stage(ring + (nx % kStages) * kStageElems, p, n0 + nx * kBK, d0, tid);
        cp_async_commit();
        const bf16* sX = ring + (it % kStages) * kStageElems;   // [row][d]
#pragma unroll
        for (int k16 = 0; k16 < kBK / 16; ++k16) {
          uint32_t a[4];                      // x^T: m = d, k = row
          ldmatrix_x4_trans(a, sX + (k16 * 16 + (lane & 7) + (lane >> 4) * 8) * kLDB
                                   + warp * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int nb2 = 0; nb2 < kBN / 16; ++nb2) {
            uint32_t b[4];                    // dlog: k = row, n = vocab
            ldmatrix_x4_trans(b, sG + (it * kBK + k16 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                          * kLDG_DW + nb2 * 16 + (lane >> 4) * 8);
            mma_16816(acc[2 * nb2], a, b[0], b[1]);
            mma_16816(acc[2 * nb2 + 1], a, b[2], b[3]);
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();                        // the ring is free
      add_chunk(p, acc, d0, v0, p.D, p.V, rd == 0, rd == n_rounds - 1);
    }
  }
}

cudaError_t launch(void (*kern)(const CeBwdParams), int blocks, const CeBwdParams& p,
                   cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmem);
  if (err != cudaSuccess) return err;
  kern<<<blocks, kThreads, kSmem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rtt

// x (N,D) and w (D,V) bf16 contiguous, targets (N,) int32 already clamped
// to [0, V), lse and g (N,) f32. D and V must be multiples of 8.
// dx: scratch (N,D) f32, out (N,D) bf16. dW: scratch (D,V) f32, out (D,V)
// bf16. Scratch needs no initial value.
extern "C" int rtt_fused_ce_bwd_dx(const void* x, const void* w, const void* targets,
                                   const void* lse, const void* g, void* scratch, void* dx,
                                   int N, int D, int V, void* stream) {
  using rtt::bf16;
  if (N <= 0 || D <= 0 || V <= 0 || D % 8 || V % 8) return (int)cudaErrorInvalidValue;
  const rtt::CeBwdParams p{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                           static_cast<const int*>(targets), static_cast<const float*>(lse),
                           static_cast<const float*>(g), static_cast<float*>(scratch),
                           static_cast<bf16*>(dx), N, D, V};
  return (int)rtt::launch(rtt::ce_bwd_dx_kernel, (N + rtt::kBM - 1) / rtt::kBM, p,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int rtt_fused_ce_bwd_dw(const void* x, const void* w, const void* targets,
                                   const void* lse, const void* g, void* scratch, void* dw,
                                   int N, int D, int V, void* stream) {
  using rtt::bf16;
  if (N <= 0 || D <= 0 || V <= 0 || D % 8 || V % 8) return (int)cudaErrorInvalidValue;
  const rtt::CeBwdParams p{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                           static_cast<const int*>(targets), static_cast<const float*>(lse),
                           static_cast<const float*>(g), static_cast<float*>(scratch),
                           static_cast<bf16*>(dw), N, D, V};
  return (int)rtt::launch(rtt::ce_bwd_dw_kernel, (V + rtt::kBN - 1) / rtt::kBN, p,
                          static_cast<cudaStream_t>(stream));
}
