// Flash-attention backward for Hopper (sm_90a): the FlashAttention-2
// split into a dK/dV kernel and a dQ kernel, bf16 in, f32 accumulation.
//
// Replaces: ray_tpu/ops/pallas_attention.py `_bwd` (:309), the
// `pl.pallas_call`s at :336 (`_bwd_dkv_kernel`, :200) and :368
// (`_bwd_dq_kernel`, :256).
//
// Both kernels recompute p = exp(q k^T * scale - lse) per tile from the
// forward's lse (B, H, S) f32 and take delta = rowsum(dO * O) (B, H, S)
// f32, computed by the caller as the reference does (:318-324). Then
//   dV += bf16(p)^T dO;  dP = dO V^T;  dS = p * (dP - delta) * scale;
//   dK += bf16(dS)^T Q;  dQ += bf16(dS) K,
// with the casts where the reference casts (:236, :246, :295). Causal
// masking is TOP-LEFT aligned, as in the forward: query row i sees kv
// columns j <= i.
//
// Bound on the H100: at the training shape (B 8, S=T 2048, H 16, KVH 8,
// hd 128, causal) the dK/dV kernel does four products over the visible
// pairs (275 GFLOP, 0.28 ms at the dense bf16 peak) and the dQ kernel
// three (206 GFLOP, 0.21 ms); both read ~100 MB, so the tensor cores
// bound them.
//
// Design, dK/dV: one CTA of 4 warps per (b, kv head, 64-row kv tile);
// each warp owns 16 kv rows and keeps their dK and dV in f32 registers.
// The CTA loops over the G query heads of its GQA group and, for each,
// over the q tiles that can see its kv rows (from the tile holding row
// kv_start to the end when causal), so dK and dV are summed over the
// group in f32 and rounded once: the reference writes per-query-head
// partials in bf16 and sums them outside (:334-366). No buffer of
// (B, H, T, hd) and no atomics: every CTA writes its own rows.
// Design, dQ: one CTA of 4 warps per (b, head, 64-row q tile), heaviest
// tiles first; each warp owns 16 query rows and keeps dQ in f32
// registers while the CTA walks kv tiles 0..(q_end-1)/64 (all when not
// causal). Deterministic: no atomics on dQ.
// Both: the 64-wide tiles are processed in two chunks of 32 columns so
// that the S and dP accumulators (16 registers each) fit beside the two
// (or one) 16 x hd accumulators; every product runs on the tensor cores
// (mma.sync m16n8k16, f32 accumulation) with operands from shared memory
// through ldmatrix, and P and dS go from the accumulator registers
// straight into the A operand. The streamed tiles (Q and dO for dK/dV,
// K and V for dQ) are double-buffered by cp.async so the next tile's
// copy overlaps this tile's math. All layouts are read through strides;
// the ragged edges of S and T are masked (zero-filled loads, lse = +inf
// for rows past S, masked p).
//
// Not yet used (later PRs): TMA, wgmma, warp specialisation, one fused
// kernel with atomic dQ.

#include "common.cuh"

#include <math_constants.h>

namespace rtt {
namespace {

constexpr int kBQ = 64;       // q rows per tile
constexpr int kBKV = 64;      // kv rows per tile
constexpr int kChunk = 32;    // tile columns processed at once
constexpr int kThreads = 128;

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;           // (B, H, S)
  const float* delta;         // (B, H, S)
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int B, S, T, H, KVH;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dkv_sb, dkv_ss, dkv_sh;   // dk and dv share one layout
  float scale;
  int causal;
};

template <int HD>
struct BwdCfg {
  static constexpr int LD = HD + 8;                  // padded smem row (elements)
  static constexpr int TILE = 64 * LD;
  // six tiles, then lse and delta for two q tiles (the dK/dV kernel)
  static constexpr int SMEM = 6 * TILE * 2 + 4 * kBQ * 4;
};

// 64 rows x HD columns from global (row stride `rs`) into a padded tile;
// rows at or beyond `n_valid` are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* g, long long rs,
                                          int row0, int n_valid, int tid) {
  constexpr int CPR = HD / 8;
#pragma unroll
  for (int c = tid; c < 64 * CPR; c += kThreads) {
    const int r = c / CPR, cc = c % CPR;
    const bool ok = row0 + r < n_valid;
    const bf16* src = ok ? g + (long long)(row0 + r) * rs + cc * 8 : g;
    cp_async16(sm + r * BwdCfg<HD>::LD + cc * 8, src, ok);
  }
}

// acc (16 x 32) += X (16 rows at sX) . Y^T (32 rows at sY), over HD.
template <int HD>
__device__ __forceinline__ void mma_xyT(float (&acc)[4][4], const bf16* sX,
                                        const bf16* sY, int lane) {
  constexpr int LD = BwdCfg<HD>::LD;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, sX + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nb2 = 0; nb2 < 2; ++nb2) {
      uint32_t b[4];
      ldmatrix_x4(b, sY + (nb2 * 16 + (lane & 7) + (lane >> 4) * 8) * LD
                         + kk * 16 + ((lane >> 3) & 1) * 8);
      mma_16816(acc[2 * nb2], a, b[0], b[1]);
      mma_16816(acc[2 * nb2 + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x HD) += bf16(P) (16 x 32, accumulator registers) . Z (32 rows at sZ).
template <int HD>
__device__ __forceinline__ void mma_pz(float (&acc)[HD / 8][4], const float (&pm)[4][4],
                                       const bf16* sZ, int lane) {
  constexpr int LD = BwdCfg<HD>::LD;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t a[4];
    a[0] = pack_bf16(pm[2 * ks][0], pm[2 * ks][1]);
    a[1] = pack_bf16(pm[2 * ks][2], pm[2 * ks][3]);
    a[2] = pack_bf16(pm[2 * ks + 1][0], pm[2 * ks + 1][1]);
    a[3] = pack_bf16(pm[2 * ks + 1][2], pm[2 * ks + 1][3]);
#pragma unroll
    for (int nd2 = 0; nd2 < HD / 16; ++nd2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sZ + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                               + nd2 * 16 + (lane >> 4) * 8);
      mma_16816(acc[2 * nd2], a, b[0], b[1]);
      mma_16816(acc[2 * nd2 + 1], a, b[2], b[3]);
    }
  }
}

template <int HD>
__device__ __forceinline__ void store_rows(bf16* g, long long rs, const float (&acc)[HD / 8][4],
                                           const int (&row)[2], int n_valid, int t) {
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] < n_valid)
        *reinterpret_cast<uint32_t*>(g + row[i] * rs + nb * 8 + 2 * t) =
            pack_bf16(acc[nb][2 * i], acc[nb][2 * i + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const BwdParams p) {
  using Cfg = BwdCfg<HD>;
  constexpr int LD = Cfg::LD, TILE = Cfg::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + TILE;
  bf16* sQ = sV + TILE;                                 // two buffers
  bf16* sO = sQ + 2 * TILE;                             // dO, two buffers
  float* sL = reinterpret_cast<float*>(sO + 2 * TILE);  // lse * log2e, two buffers
  float* sD = sL + 2 * kBQ;                             // delta, two buffers

  const int kv0 = blockIdx.x * kBKV, kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KVH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (p.S + kBQ - 1) / kBQ;
  const int qt0 = p.causal ? kv0 / kBQ : 0;             // first q tile that sees kv0
  const int per_head = max(0, nq - qt0);
  const int n_it = G * per_head;

  load_tile<HD>(sK, p.k + b * p.k_sb + kvh * p.k_sh, p.k_ss, kv0, p.T, tid);
  load_tile<HD>(sV, p.v + b * p.v_sb + kvh * p.v_sh, p.v_ss, kv0, p.T, tid);

  // q tile `it` of the flattened (head in group, q tile) walk into buffer `buf`
  auto prefetch = [&](int it, int buf) {
    const int h = kvh * G + it / per_head;
    const int q0 = (qt0 + it % per_head) * kBQ;
    load_tile<HD>(sQ + buf * TILE, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.S, tid);
    load_tile<HD>(sO + buf * TILE, p.dout + b * p.do_sb + h * p.do_sh, p.do_ss, q0, p.S, tid);
    if (tid < kBQ) {
      const int r = q0 + tid;
      const long long i = ((long long)b * p.H + h) * p.S + r;
      // rows past S get lse = +inf, so their p is exactly 0
      sL[buf * kBQ + tid] = r < p.S ? p.lse[i] * kLog2e : CUDART_INF_F;
      sD[buf * kBQ + tid] = r < p.S ? p.delta[i] : 0.f;
    }
  };
  if (n_it > 0) prefetch(0, 0);
  cp_async_commit();

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  const float sl2 = p.scale * kLog2e;
  const int kv_row[2] = {kv0 + warp * 16 + g, kv0 + warp * 16 + g + 8};

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) prefetch(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                       // tile `it` (and K, V) here
    const int q0 = (qt0 + it % per_head) * kBQ;
    const bf16* cQ = sQ + buf * TILE;
    const bf16* cO = sO + buf * TILE;
    const float* cL = sL + buf * kBQ;
    const float* cD = sD + buf * kBQ;
    const bool diag = p.causal && q0 < kv0 + kBKV;

#pragma unroll
    for (int c = 0; c < kBQ / kChunk; ++c) {
      // S^T = K Q^T: 16 kv rows x 32 q columns; P^T in place
      float s[4][4] = {};
      mma_xyT<HD>(s, sK + warp * 16 * LD, cQ + c * kChunk * LD, lane);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c * kChunk + nb * 8 + 2 * t + (e & 1);
          float x = exp2f(s[nb][e] * sl2 - cL[col]);
          if (diag && q0 + col < kv_row[e >> 1]) x = 0.f;
          s[nb][e] = x;
        }
      }
      mma_pz<HD>(dv, s, cO + c * kChunk * LD, lane);          // dV += P^T dO
      // dP^T = V dO^T; dS^T = P^T (dP^T - delta) * scale in place
      float dp[4][4] = {};
      mma_xyT<HD>(dp, sV + warp * 16 * LD, cO + c * kChunk * LD, lane);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c * kChunk + nb * 8 + 2 * t + (e & 1);
          dp[nb][e] = s[nb][e] * (dp[nb][e] - cD[col]) * p.scale;
        }
      }
      mma_pz<HD>(dk, dp, cQ + c * kChunk * LD, lane);         // dK += dS^T Q
    }
    __syncthreads();                       // every warp is done with buffer `buf`
  }
  cp_async_wait<0>();

  store_rows<HD>(p.dk + b * p.dkv_sb + kvh * p.dkv_sh, p.dkv_ss, dk, kv_row, p.T, t);
  store_rows<HD>(p.dv + b * p.dkv_sb + kvh * p.dkv_sh, p.dkv_ss, dv, kv_row, p.T, t);
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdParams p) {
  using Cfg = BwdCfg<HD>;
  constexpr int LD = Cfg::LD, TILE = Cfg::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + TILE;
  bf16* sK = sO + TILE;                    // two buffers
  bf16* sV = sK + 2 * TILE;                // two buffers

  const int n_qt = (p.S + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBQ;   // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kv_end = p.causal ? min(p.T, q0 + kBQ) : p.T;
  const int n_kt = (kv_end + kBKV - 1) / kBKV;

  const bf16* kg = p.k + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg = p.v + b * p.v_sb + kvh * p.v_sh;
  load_tile<HD>(sQ, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.S, tid);
  load_tile<HD>(sO, p.dout + b * p.do_sb + h * p.do_sh, p.do_ss, q0, p.S, tid);
  if (n_kt > 0) {
    load_tile<HD>(sK, kg, p.k_ss, 0, p.T, tid);
    load_tile<HD>(sV, vg, p.v_ss, 0, p.T, tid);
  }
  cp_async_commit();

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long idx = ((long long)b * p.H + h) * p.S + row[i];
    lse2[i] = row[i] < p.S ? p.lse[idx] * kLog2e : CUDART_INF_F;
    dl[i] = row[i] < p.S ? p.delta[idx] : 0.f;
  }
  float dq[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  const float sl2 = p.scale * kLog2e;

  for (int j = 0; j < n_kt; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_kt) {
      load_tile<HD>(sK + (buf ^ 1) * TILE, kg, p.k_ss, (j + 1) * kBKV, p.T, tid);
      load_tile<HD>(sV + (buf ^ 1) * TILE, vg, p.v_ss, (j + 1) * kBKV, p.T, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                       // K_j, V_j (and Q, dO) here
    const int kvb = j * kBKV;
    const bf16* cK = sK + buf * TILE;
    const bf16* cV = sV + buf * TILE;
    const bool need_mask = (kvb + kBKV > p.T) || (p.causal && kvb + kBKV - 1 > q0);

#pragma unroll
    for (int c = 0; c < kBKV / kChunk; ++c) {
      float s[4][4] = {};
      mma_xyT<HD>(s, sQ + warp * 16 * LD, cK + c * kChunk * LD, lane);   // S = Q K^T
      float dp[4][4] = {};
      mma_xyT<HD>(dp, sO + warp * 16 * LD, cV + c * kChunk * LD, lane);  // dP = dO V^T
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kvb + c * kChunk + nb * 8 + 2 * t + (e & 1);
          float x = exp2f(s[nb][e] * sl2 - lse2[e >> 1]);
          if (need_mask && (col >= p.T || (p.causal && col > row[e >> 1]))) x = 0.f;
          dp[nb][e] = x * (dp[nb][e] - dl[e >> 1]) * p.scale;
        }
      }
      mma_pz<HD>(dq, dp, cK + c * kChunk * LD, lane);         // dQ += dS K
    }
    __syncthreads();                       // every warp is done with buffer `buf`
  }
  cp_async_wait<0>();

  store_rows<HD>(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_ss, dq, row, p.S, t);
}

template <int HD>
cudaError_t launch_dkv(const BwdParams& p, cudaStream_t stream) {
  auto kern = flash_bwd_dkv_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, BwdCfg<HD>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + kBKV - 1) / kBKV, p.KVH, p.B);
  kern<<<grid, kThreads, BwdCfg<HD>::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const BwdParams& p, cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, BwdCfg<HD>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kBQ - 1) / kBQ, p.H, p.B);
  kern<<<grid, kThreads, BwdCfg<HD>::SMEM, stream>>>(p);
  return cudaGetLastError();
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, void* dk, void* dv,
                      int B, int S, int T, int H, int KVH, const long long* st,
                      float scale, int causal) {
  return BwdParams{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                   static_cast<const float*>(lse), static_cast<const float*>(delta),
                   static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                   B, S, T, H, KVH,
                   st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                   st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17],
                   scale, causal};
}

}  // namespace
}  // namespace rtt

// q, dout (B,S,H,hd); k, v (B,T,KVH,hd): bf16, innermost dim contiguous,
// other strides in elements, in `strides` as (b, s, h) triples for q, k,
// v, dout, dq and dk/dv (18 values). lse and delta (B,H,S) f32
// contiguous. The dK/dV entry point writes dk and dv (B,T,KVH,hd) and
// reads no dq; the dQ entry point writes dq (B,S,H,hd).
extern "C" int rtt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    int B, int S, int T, int H, int KVH, int hd, const long long* strides,
    float scale, int causal, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KVH <= 0 || H % KVH != 0)
    return (int)cudaErrorInvalidValue;
  const rtt::BwdParams p = rtt::make_params(q, k, v, dout, lse, delta, nullptr, dk, dv,
                                            B, S, T, H, KVH, strides, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128) return (int)rtt::launch_dkv<128>(p, st);
  if (hd == 64) return (int)rtt::launch_dkv<64>(p, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rtt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq,
    int B, int S, int T, int H, int KVH, int hd, const long long* strides,
    float scale, int causal, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KVH <= 0 || H % KVH != 0)
    return (int)cudaErrorInvalidValue;
  const rtt::BwdParams p = rtt::make_params(q, k, v, dout, lse, delta, dq, nullptr, nullptr,
                                            B, S, T, H, KVH, strides, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128) return (int)rtt::launch_dq<128>(p, st);
  if (hd == 64) return (int)rtt::launch_dq<64>(p, st);
  return (int)cudaErrorInvalidValue;
}
