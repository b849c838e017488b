// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 softmax state.
//
// Replaces: ray_tpu/ops/pallas_attention.py `_fwd` (:141), the
// `pl.pallas_call` at :157 of kernel `_fwd_kernel` (:78).
//
// Computes o = softmax(q k^T * scale [causal mask]) v for GQA (query head
// h reads kv head h / (H / KVH)) and lse = logsumexp of each row, f32,
// shape (B, H, S). Causal masking is TOP-LEFT aligned: query row i sees
// kv columns j <= i, both counted from 0 (pallas_attention.py:104-108).
// P is rounded to bf16 before P.V, as the reference casts it (:120).
//
// Bound on the H100: at the scoring shape (B 8, S=T 2048, H 16, hd 128,
// causal) the two products are 4 hd (causal pairs) B H = 137 GFLOP
// against ~200 MB of traffic, so the tensor cores bound it (0.139 ms at
// the dense bf16 peak). The softmax's exp2 runs on the SM's 16 special
// function units a clock: per 64 x 128 tile of scores, half the time the
// tensor cores take for its two products.
//
// Design (FlashAttention-3's shape): one CTA per (b, h, 128-row q tile) of
// 3 warpgroups.
//   warpgroup 0, producer (40 registers): one thread loads Q once and
//     streams 128-row K and V tiles through 3 stages of shared memory
//     (224 KB at hd 128) with TMA on 4-D tensor maps over (hd, S, H, B), so
//     the (B, S, H, hd) layout is read through its strides with no copy.
//     K and V each complete on a barrier of their own and are freed on one
//     of their own: K as soon as its S product is done, V after P V. Rows
//     past S or T are zero-filled by TMA: the mainloop has no load masks.
//     Tiles strictly above the causal diagonal are never loaded.
//   warpgroups 1, 2, consumers (232 registers): consumer c owns query rows
//     64c..64c+63. S = Q K^T with wgmma m64n128k16, both operands K-major
//     from 128-byte-swizzled shared memory (hd 128 is two 64-column boxes);
//     the online softmax in the log2 domain in registers, with masks only
//     on the diagonal and ragged edge tiles; O += P V with the register-A
//     form of wgmma (m64n{hd}k16): the f32 accumulator fragment of S is the
//     A fragment, packed to bf16 pairs with no shuffle, and V is the
//     MN-major B operand read through the instruction's transpose bit.
//     Each consumer issues S of tile j together with P V of tile j - 1, so
//     its softmax of tile j overlaps its own P V; and the two consumers
//     take turns to issue (ping-pong on named barriers), so one consumer's
//     softmax overlaps the other's products.
//   epilogue: O / l rounded to bf16 into the consumer's own rows of the Q
//     tile (no longer read), stored by TMA, which clips rows past S; lse
//     f32 from registers.
// Scheduling: the heaviest causal q tiles first; the (b, h) of one q tile
// run together, so the heads of a GQA group, side by side, share their K
// and V tiles in L2.
// Deterministic: every output element has one owner; no atomics.
// What is left between it and the bound: every CTA pays its prologue (Q
// and the first K loaded before any product) and its epilogue with the
// tensor cores idle (one q tile per CTA, not persistent); the diagonal
// tile's masked half; the causal tail's light tiles.

#include <math_constants.h>

#include "sm90.cuh"

namespace rtt {
namespace {

constexpr int kBQ = 128;         // query rows per CTA: two consumers of 64
constexpr int kBKV = 128;        // kv rows per tile
constexpr int kStages = 3;       // K/V stages: 224 KB of shared memory at hd 128
constexpr int kThreads = 384;
constexpr int kBox = kBKV * 128; // one TMA box: 128 rows x 64 bf16, 16 KB
constexpr int kHalf = 64 * 128;  // one consumer's 64 rows of a box, 8 KB

struct FaParams {
  CUtensorMap q, k, v;           // 4-D (hd, rows, heads, B), boxes {64, 128, 1, 1}
  CUtensorMap o;                 // 4-D like q, boxes {64, 64, 1, 1} (store)
  float* lse;                    // (B, H, S)
  int B, S, T, H, KVH, n_qt;
  float scale, scale_log2;       // softmax scale, and times log2(e)
  int causal;
};

template <int HD>
struct FaCfg {
  static constexpr int kBoxes = HD / 64;                  // 64-column boxes per row
  static constexpr int kTile = kBoxes * kBox;             // one Q, K or V tile
  static constexpr int kSmem = 1024 + (1 + 2 * kStages) * kTile + (1 + 4 * kStages) * 8;
};

// Issues S = Q K^T (64 x 128, f32) for one consumer: q at its 64 rows of
// the Q tile, k at a K tile; both K-major, hd in 64-column boxes.
template <int HD>
__device__ __forceinline__ void issue_s(float (&sc)[kBKV / 2], const uint8_t* q, const uint8_t* k) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_m64n128k16<0, 0>(sc, smem_desc(q + (kk >> 2) * kBox + (kk & 3) * 32, 16, 1024),
                           smem_desc(k + (kk >> 2) * kBox + (kk & 3) * 32, 16, 1024), kk != 0);
  wgmma_commit();
}

// Issues O += P V: P (64 x 128 bf16) in registers, V a tile read MN-major
// (LBO: one box between the 64-column halves of hd 128).
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&pa)[kBKV / 16][4],
                                         const uint8_t* v) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBKV / 16; ++kk) {
    const uint64_t db = smem_desc(v + kk * 16 * 128, kBox, 1024);
    if constexpr (HD == 128) wgmma_m64n128k16_rs(o, pa[kk], db);
    else wgmma_m64n64k16_rs(o, pa[kk], db);
  }
  wgmma_commit();
}

// The online softmax of one 64 x 128 tile of scores, log2 domain: masks
// (only on the diagonal and ragged edge tiles), the new row max m, corr =
// exp2 of the old max against the new one, and sc <- exp2(sc - m) with
// this thread's part of each row sum in rs.
__device__ __forceinline__ void softmax_tile(float (&sc)[kBKV / 2], float (&m)[2], float (&corr)[2],
                                             float (&rs)[2], int kv0, const int (&row)[2],
                                             int row0, int qd, const FaParams& p) {
  const float sl2 = p.scale_log2;
  if (kv0 + kBKV > p.T || (p.causal && kv0 + kBKV - 1 > row0)) {
#pragma unroll
    for (int i = 0; i < kBKV / 2; ++i) {
      const int col = kv0 + 8 * (i >> 2) + 2 * qd + (i & 1);
      if (col >= p.T || (p.causal && col > row[(i >> 1) & 1])) sc[i] = -CUDART_INF_F;
    }
  }
  float neg[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = m[hh];
#pragma unroll
    for (int jj = 0; jj < kBKV / 8; ++jj)
      mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * hh], sc[4 * jj + 2 * hh + 1]));
    mx = quad_max(mx);
    // a row with nothing visible yet computes against 0 and keeps -inf
    const float mu = mx == -CUDART_INF_F ? 0.f : mx;
    corr[hh] = exp2f((m[hh] - mu) * sl2);                 // exp2(-inf) = 0
    m[hh] = mx;
    neg[hh] = -mu * sl2;
    rs[hh] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kBKV / 2; ++i) {
    sc[i] = exp2f(fmaf(sc[i], sl2, neg[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += sc[i];
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(const __grid_constant__ FaParams p) {
  using Cfg = FaCfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  // stage s: K at sq + (1 + 2s) kTile, V right after it
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sq + (1 + 2 * kStages) * Cfg::kTile);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;

  // heaviest q tiles first; the (b, h) of one q tile together
  const int bh = p.B * p.H;
  const int qt = p.n_qt - 1 - static_cast<int>(blockIdx.x) / bh;
  const int b = static_cast<int>(blockIdx.x) % bh / p.H, h = static_cast<int>(blockIdx.x) % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = qt * kBQ;
  const int kv_end = p.causal ? min(p.T, q0 + kBQ) : p.T;
  const int n_kt = (kv_end + kBKV - 1) / kBKV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 8);   // one arrival per consumer warp
      mbar_init(&empty_v[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, Cfg::kTile);
#pragma unroll
      for (int x = 0; x < Cfg::kBoxes; ++x) tma_load_4d(sq + x * kBox, &p.q, bar_q, 64 * x, q0, h, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        const uint32_t ph = ((j / kStages) & 1) ^ 1;
        uint8_t* sk = sq + (1 + 2 * s) * Cfg::kTile;
        mbar_wait(&empty_k[s], ph);
        mbar_expect_tx(&full_k[s], Cfg::kTile);
#pragma unroll
        for (int x = 0; x < Cfg::kBoxes; ++x)
          tma_load_4d(sk + x * kBox, &p.k, &full_k[s], 64 * x, j * kBKV, kvh, b);
        mbar_wait(&empty_v[s], ph);
        mbar_expect_tx(&full_v[s], Cfg::kTile);
#pragma unroll
        for (int x = 0; x < Cfg::kBoxes; ++x)
          tma_load_4d(sk + Cfg::kTile + x * kBox, &p.v, &full_v[s], 64 * x, j * kBKV, kvh, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1, tid = threadIdx.x - 128 * wg;
    const int w = tid >> 5, g = (tid & 31) >> 2, qd = tid & 3;
    const int row0 = q0 + 64 * c;                       // this consumer's first row
    const int row[2] = {row0 + 16 * w + g, row0 + 16 * w + g + 8};
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};        // row max of the raw scores
    float l[2] = {0.f, 0.f};                            // this thread's part of the row sum

    // Turn t of a consumer issues its products for step t: S_0 on turn 0,
    // S_t and P_{t-1} V_{t-1} on turn t, P V of the last tile on turn n_kt.
    // The turns alternate between the consumers (named barriers 3 + c, 256
    // threads: the owner syncs, the other arrives), so one consumer's
    // softmax runs while the other's products hold the tensor cores.
    // Consumer 1 lets consumer 0 go first and skips its last arrival, so
    // each barrier sees as many arrivals as syncs.
    if (c == 1) named_bar_arrive(3, 256);
    const auto end_turn = [&](int t) {
      if (c == 0 || t < n_kt) named_bar_arrive(4 - c, 256);
    };
    float sc[kBKV / 2];
    uint32_t pa[kBKV / 16][4];
    float corr[2], rs[2];
    mbar_wait(bar_q, 0);

    mbar_wait(&full_k[0], 0);
    named_bar_sync(3 + c, 256);
    issue_s<HD>(sc, sq + c * kHalf, sq + Cfg::kTile);
    end_turn(0);
    wgmma_wait<0>();
    fence_acc(sc);
    if ((tid & 31) == 0) mbar_arrive(&empty_k[0]);
    softmax_tile(sc, m, corr, rs, 0, row, row0, qd, p);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = rs[hh];
    pack_a(sc, pa);

    for (int j = 1; j < n_kt; ++j) {
      const int s = j % kStages, sp = (j - 1) % kStages;
      const uint8_t* sk = sq + (1 + 2 * s) * Cfg::kTile;
      const uint8_t* sv_prev = sq + (2 + 2 * sp) * Cfg::kTile;
      mbar_wait(&full_k[s], (j / kStages) & 1);
      named_bar_sync(3 + c, 256);
      issue_s<HD>(sc, sq + c * kHalf, sk);
      mbar_wait(&full_v[sp], ((j - 1) / kStages) & 1);
      issue_pv<HD>(o, pa, sv_prev);
      end_turn(j);
      wgmma_wait<1>();                                  // S_j is done, P V may run
      fence_acc(sc);
      if ((tid & 31) == 0) mbar_arrive(&empty_k[s]);
      softmax_tile(sc, m, corr, rs, j * kBKV, row, row0, qd, p);
      wgmma_wait<0>();
      fence_acc(o);
      fence_regs(pa);                                   // read by the product until here
      if ((tid & 31) == 0) mbar_arrive(&empty_v[sp]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * corr[hh] + rs[hh];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      pack_a(sc, pa);
    }

    const int sl = (n_kt - 1) % kStages;
    mbar_wait(&full_v[sl], ((n_kt - 1) / kStages) & 1);
    named_bar_sync(3 + c, 256);
    issue_pv<HD>(o, pa, sq + (2 + 2 * sl) * Cfg::kTile);
    end_turn(n_kt);
    wgmma_wait<0>();
    fence_acc(o);
    fence_regs(pa);

    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] = quad_sum(l[hh]);
      inv[hh] = 1.f / fmaxf(l[hh], 1e-30f);
    }
    // O as bf16 into this consumer's rows of the Q tile, 128-byte swizzled
    // as TMA reads it (row r % 8 == g)
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * w + g + 8 * hh;
        *reinterpret_cast<uint32_t*>(sq + (jj >> 3) * kBox + c * kHalf + r * 128 +
                                     (((jj & 7) ^ g) << 4) + 4 * qd) =
            pack_bf16(o[4 * jj + 2 * hh] * inv[hh], o[4 * jj + 2 * hh + 1] * inv[hh]);
      }
    fence_proxy_async();
    named_bar_sync(1 + c, 128);
    if (tid == 0) {
#pragma unroll
      for (int x = 0; x < Cfg::kBoxes; ++x)
        tma_store_4d(&p.o, sq + x * kBox + c * kHalf, 64 * x, row0, h, b);
      bulk_commit();
    }
    if (qd == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (row[hh] < p.S)
          p.lse[(static_cast<long long>(b) * p.H + h) * p.S + row[hh]] =
              m[hh] * p.scale + logf(fmaxf(l[hh], 1e-30f));
    }
    if (tid == 0) bulk_wait();
  }
}

template <int HD>
cudaError_t launch(const FaParams& p, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         FaCfg<HD>::kSmem);
  if (err != cudaSuccess) return err;
  kern<<<p.n_qt * p.B * p.H, kThreads, FaCfg<HD>::kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rtt

// q (B,S,H,hd), k/v (B,T,KVH,hd), o like q: bf16, innermost dim
// contiguous, other strides in elements, multiples of 8 (16 bytes, for
// TMA), base pointers 16-byte aligned. lse (B,H,S) f32, contiguous.
extern "C" int rtt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int S, int T, int H, int KVH, int hd,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, void* stream) {
  using namespace rtt;
  if (B <= 0 || S <= 0 || T <= 0 || KVH <= 0 || H % KVH != 0 || (hd != 64 && hd != 128))
    return (int)cudaErrorInvalidValue;
  FaParams p{};
  cudaError_t err = make_map4(&p.q, q, B, S, H, hd, q_sb, q_ss, q_sh, kBQ);
  if (err == cudaSuccess) err = make_map4(&p.k, k, B, T, KVH, hd, k_sb, k_ss, k_sh, kBKV);
  if (err == cudaSuccess) err = make_map4(&p.v, v, B, T, KVH, hd, v_sb, v_ss, v_sh, kBKV);
  if (err == cudaSuccess) err = make_map4(&p.o, o, B, S, H, hd, o_sb, o_ss, o_sh, 64);
  if (err != cudaSuccess) return (int)err;
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.S = S;
  p.T = T;
  p.H = H;
  p.KVH = KVH;
  p.n_qt = (S + kBQ - 1) / kBQ;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(hd == 128 ? launch<128>(p, st) : launch<64>(p, st));
}
