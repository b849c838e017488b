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
// Design, both kernels (K1's skeleton, flash_attention_fwd.cu): a CTA of 3
// warpgroups owns 128 rows, 64 per consumer warpgroup, and streams 64-row
// tiles of the other side through a ring of 4 stages of shared memory.
//   warpgroup 0, producer (40 registers): one thread loads the resident
//     tiles once and the streamed tiles with TMA on 4-D tensor maps over
//     (hd, rows, heads, B), so every layout is read through its strides
//     with no copy; rows past S or T are zero-filled. Each stage completes
//     on a full barrier and is freed on an empty barrier when both
//     consumers are done with it. Tiles wholly above the causal diagonal
//     are never loaded.
//   warpgroups 1, 2, consumers (232 registers): every product is a wgmma
//     with f32 accumulation. The two score-like products of a tile have
//     both operands K-major in 128-byte-swizzled shared memory
//     (m64n64k16); p and dS are formed in registers and packed to bf16 as
//     the A fragments of the register form (m64n{hd}k16, no shuffle), with
//     the streamed tile read MN-major through the transpose bit. Masks
//     only on the diagonal and ragged edge tiles.
//   Ping-pong: two turns per tile (the score products, then the products
//     that take p or dS), and the consumers take turns on named barriers,
//     so one consumer's elementwise step runs while the other's products
//     hold the tensor cores. Each consumer waits for its own products.
// Scheduling, both kernels: the CTAs walk chunks of 8 (b, kv head) groups,
//   so a chunk's streamed tiles are read from device memory once and then
//   from L2; inside a chunk the heaviest causal tiles come first.
// dQ: one CTA per (b, head, 128-row q tile), the heads of a GQA group side
//   by side. Q and dO stay resident; K and V stream. Per kv tile:
//   S = Q K^T and dP = dO V^T; dS in registers (lse and delta of the
//   thread's two rows held in registers; rows past S get lse = +inf, so
//   p is exactly 0; kv columns past T are masked); dQ += dS K.
//   Epilogue: dQ as bf16 into the consumer's rows of the Q tile, stored by
//   TMA, which clips rows past S.
// dK/dV: one CTA per (b, kv head, 128-row kv tile) (under top-left masking
//   kv tile 0 sees every q tile, so it is the heaviest). K and V stay resident;
//   for each query head of the GQA group and each q tile that can see the
//   kv tile, Q and dO stream, with that tile's lse (times log2 e; +inf past
//   S) and delta written beside them by the producer warp's plain loads.
//   Per q tile: S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come out
//   as the A fragments; dV += P^T dO, dK += dS^T Q, both register-A with
//   dO and Q read MN-major. dK and dV stay in f32 registers across the
//   whole walk, so they are summed over the GQA group in f32 and rounded
//   once (the reference writes per-head bf16 partials and sums them,
//   :334-366). Epilogue: bf16 into the freed K and V tiles, stored by TMA,
//   which clips rows past T.
// Deterministic: every output element has one owner; no atomics. Neither
// kernel uses mma.sync or cp.async: the tiles come by TMA, the products
// are wgmma.
// What is left between it and the bound: a consumer waits for its own
// products before its elementwise step (issuing the next tile's scores
// first measured slower for dQ, and for dK/dV the registers do not allow
// it: dK and dV hold 128 of them); one tile per CTA (not persistent), so
// each CTA's prologue and epilogue run with the tensor cores idle; the
// split's two extra products (dQ recomputes S and dP, 7 products where a
// fused kernel with dQ summed across kv tiles does 5); the diagonal
// tiles' masked halves and the causal tail's light CTAs.

#include <math_constants.h>

#include "sm90.cuh"

namespace rtt {
namespace {

constexpr int kThreads = 384;            // a producer warpgroup and two consumers
constexpr int kBig = 128;                // rows a CTA owns, 64 per consumer
constexpr int kSmall = 64;               // rows of a streamed tile
constexpr int kStages = 4;
constexpr int kBigBox = kBig * 128;      // one TMA box: 128 rows x 64 bf16, 16 KB
constexpr int kSmallBox = kSmall * 128;  // 64 rows x 64 bf16, 8 KB
constexpr int kHalf = 64 * 128;          // one consumer's 64 rows of a big box
constexpr int kChunk = 8;                // (b, kv head) groups whose CTAs run together

struct BwdParams {
  CUtensorMap q, k, v, dout;     // 4-D (hd, rows, heads, B) loads
  CUtensorMap out0, out1;        // 4-D stores, boxes of 64 rows: dq, or dk and dv
  const float* lse;              // (B, H, S)
  const float* delta;            // (B, H, S)
  int B, S, T, H, KVH, n_tiles;  // n_tiles: the 128-row tiles of the grid
  float scale, scale_log2;       // softmax scale, and times log2(e)
  int causal;
};

template <int HD>
struct BwdCfg {
  static constexpr int kBoxes = HD / 64;                  // 64-column boxes per row
  static constexpr int kBigTile = kBoxes * kBigBox;       // a resident tile
  static constexpr int kSmallTile = kBoxes * kSmallBox;   // a streamed tile
  static constexpr int kStats = kStages * 2 * kSmall * 4; // lse and delta per stage (dK/dV)
  // two resident tiles, the stages of two streamed tiles, stats, barriers
  static constexpr int kSmem =
      1024 + 2 * kBigTile + 2 * kStages * kSmallTile + kStats + (1 + 2 * kStages) * 8;
};

__device__ __forceinline__ uint8_t* smem_base() {
  extern __shared__ uint8_t smem_raw[];
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
}

// d = A B^T (64 x 64, f32) over HD, both K-major: A a consumer's 64 rows of
// a resident tile (boxes kBigBox apart), B a streamed tile.
template <int HD>
__device__ __forceinline__ void mma_abt(float (&d)[32], const uint8_t* a, const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_m64n64k16<0, 0>(d, smem_desc(a + (kk >> 2) * kBigBox + (kk & 3) * 32, 16, 1024),
                          smem_desc(b + (kk >> 2) * kSmallBox + (kk & 3) * 32, 16, 1024),
                          kk != 0);
}

// d += A Z: A (64 x 64 bf16) in registers, Z a streamed tile (64 rows x
// HD) read MN-major (LBO: one box between the 64-column halves of hd 128).
template <int HD>
__device__ __forceinline__ void mma_az(float (&d)[HD / 2], const uint32_t (&a)[4][4],
                                       const uint8_t* z) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = smem_desc(z + kk * 16 * 128, kSmallBox, 1024);
    if constexpr (HD == 128) wgmma_m64n128k16_rs(d, a[kk], db);
    else wgmma_m64n64k16_rs(d, a[kk], db);
  }
}

// An accumulator (64 x HD) as bf16 into a consumer's 64 rows of a resident
// tile at dst, 128-byte swizzled as TMA reads it (row r % 8 == g).
template <int HD>
__device__ __forceinline__ void stage_rows(uint8_t* dst, const float (&d)[HD / 2], int w, int g,
                                           int qd) {
#pragma unroll
  for (int jj = 0; jj < HD / 8; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * w + g + 8 * hh;
      *reinterpret_cast<uint32_t*>(dst + (jj >> 3) * kBigBox + r * 128 + (((jj & 7) ^ g) << 4) +
                                   4 * qd) = pack_bf16(d[4 * jj + 2 * hh], d[4 * jj + 2 * hh + 1]);
    }
}

// The consumer's 64 rows of `src` (a resident tile) to rows row0.. of
// `map` at (head, b): one thread, after the warpgroup's writes.
template <int HD>
__device__ __forceinline__ void store_rows(const CUtensorMap* map, const uint8_t* src, int row0,
                                           int head, int b) {
#pragma unroll
  for (int x = 0; x < HD / 64; ++x) tma_store_4d(map, src + x * kBigBox, 64 * x, row0, head, b);
}

// The consumers of a CTA take turns to issue their products (named
// barriers 3 + c, 256 threads: the owner syncs, the other arrives), so one
// consumer's elementwise step runs while the other's products hold the
// tensor cores. Consumer 1 lets consumer 0 go first (`first_turn`) and
// skips its arrival after its last turn, so each barrier sees as many
// arrivals as syncs.
__device__ __forceinline__ void first_turn(int c) {
  if (c == 1) named_bar_arrive(3, 256);
}

__device__ __forceinline__ void begin_turn(int c) { named_bar_sync(3 + c, 256); }

__device__ __forceinline__ void end_turn(int c, bool last) {
  if (c == 0 || !last) named_bar_arrive(4 - c, 256);
}

__device__ __forceinline__ void init_barriers(uint64_t* bar, uint64_t* full, uint64_t* empty,
                                              uint32_t full_count) {
  mbar_init(bar, 1);
  for (int s = 0; s < kStages; ++s) {
    mbar_init(&full[s], full_count);
    mbar_init(&empty[s], 8);   // one arrival per consumer warp
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(const __grid_constant__ BwdParams p) {
  using Cfg = BwdCfg<HD>;
  uint8_t* sq = smem_base();
  uint8_t* sdo = sq + Cfg::kBigTile;
  uint8_t* skv = sdo + Cfg::kBigTile;   // stage s: K at skv + 2s kSmallTile, V after it
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(skv + 2 * kStages * Cfg::kSmallTile + Cfg::kStats);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kStages;

  // chunks of kChunk (b, kv head) groups, so their K and V stay in L2;
  // in a chunk the heaviest q tiles first, the heads of one q tile together
  const int G = p.H / p.KVH, n_groups = p.B * p.KVH;
  const int per_chunk = kChunk * G * p.n_tiles;
  const int chunk = static_cast<int>(blockIdx.x) / per_chunk;
  const int r = static_cast<int>(blockIdx.x) % per_chunk;
  const int cg = min(kChunk, n_groups - chunk * kChunk) * G;   // CTAs per q tile in this chunk
  const int qt = p.n_tiles - 1 - r / cg;
  const int grp = chunk * kChunk + r % cg / G;
  const int b = grp / p.KVH, kvh = grp % p.KVH, h = kvh * G + r % G;
  const int q0 = qt * kBig;
  const int kv_end = p.causal ? min(p.T, q0 + kBig) : p.T;
  const int n_kt = (kv_end + kSmall - 1) / kSmall;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) init_barriers(bar_q, full, empty, 1);
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, 2 * Cfg::kBigTile);
#pragma unroll
      for (int x = 0; x < Cfg::kBoxes; ++x) {
        tma_load_4d(sq + x * kBigBox, &p.q, bar_q, 64 * x, q0, h, b);
        tma_load_4d(sdo + x * kBigBox, &p.dout, bar_q, 64 * x, q0, h, b);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        uint8_t* sk = skv + 2 * s * Cfg::kSmallTile;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * Cfg::kSmallTile);
#pragma unroll
        for (int x = 0; x < Cfg::kBoxes; ++x) {
          tma_load_4d(sk + x * kSmallBox, &p.k, &full[s], 64 * x, j * kSmall, kvh, b);
          tma_load_4d(sk + Cfg::kSmallTile + x * kSmallBox, &p.v, &full[s], 64 * x, j * kSmall,
                      kvh, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1, tid = threadIdx.x - 128 * wg;
    const int w = tid >> 5, g = (tid & 31) >> 2, qd = tid & 3;
    const int row0 = q0 + 64 * c;                       // this consumer's first row
    const int row[2] = {row0 + 16 * w + g, row0 + 16 * w + g + 8};
    float lse2[2], dl[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long i = (static_cast<long long>(b) * p.H + h) * p.S + row[hh];
      // rows past S get lse = +inf, so their p is exactly 0
      lse2[hh] = row[hh] < p.S ? p.lse[i] * kLog2e : CUDART_INF_F;
      dl[hh] = row[hh] < p.S ? p.delta[i] : 0.f;
    }
    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
    const uint8_t* qc = sq + c * kHalf;
    const uint8_t* doc = sdo + c * kHalf;
    mbar_wait(bar_q, 0);

    // Two turns per kv tile: S and dP, then dQ. Each consumer waits for its
    // own products; the other consumer's products fill the tensor cores
    // meanwhile.
    first_turn(c);
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % kStages;
      const uint8_t* sk = skv + 2 * s * Cfg::kSmallTile;
      float sc[32], dp[32];
      uint32_t da[4][4];
      mbar_wait(&full[s], (j / kStages) & 1);
      begin_turn(c);
      wgmma_fence();
      mma_abt<HD>(sc, qc, sk);                          // S = Q K^T
      mma_abt<HD>(dp, doc, sk + Cfg::kSmallTile);       // dP = dO V^T
      wgmma_commit();
      end_turn(c, false);
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);
      // dS = p (dP - delta) scale in place in sc; masks only on the
      // diagonal and ragged edge tiles
      const int kv0 = j * kSmall;
      const bool edge = kv0 + kSmall > p.T || (p.causal && kv0 + kSmall - 1 > row0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        float pv = exp2f(fmaf(sc[i], p.scale_log2, -lse2[hh]));
        if (edge) {
          const int col = kv0 + 8 * (i >> 2) + 2 * qd + (i & 1);
          if (col >= p.T || (p.causal && col > row[hh])) pv = 0.f;
        }
        sc[i] = pv * (dp[i] - dl[hh]) * p.scale;
      }
      pack_a(sc, da);
      begin_turn(c);
      wgmma_fence();
      mma_az<HD>(dq, da, sk);                           // dQ += dS K
      wgmma_commit();
      end_turn(c, j == n_kt - 1);
      wgmma_wait<0>();
      fence_acc(dq);
      fence_regs(da);
      if ((tid & 31) == 0) mbar_arrive(&empty[s]);
    }

    stage_rows<HD>(sq + c * kHalf, dq, w, g, qd);
    fence_proxy_async();
    named_bar_sync(1 + c, 128);
    if (tid == 0) {
      store_rows<HD>(&p.out0, sq + c * kHalf, row0, h, b);
      bulk_commit();
      bulk_wait();
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_kernel(const __grid_constant__ BwdParams p) {
  using Cfg = BwdCfg<HD>;
  uint8_t* sk = smem_base();
  uint8_t* sv = sk + Cfg::kBigTile;
  uint8_t* sqd = sv + Cfg::kBigTile;    // stage s: Q at sqd + 2s kSmallTile, dO after it
  float* stats = reinterpret_cast<float*>(sqd + 2 * kStages * Cfg::kSmallTile);  // lse2, delta
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(stats) + Cfg::kStats);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + kStages;

  // chunks of kChunk (b, kv head) groups, so their Q and dO stay in L2;
  // in a chunk the heaviest kv tiles first (top-left causal: kv tile 0
  // sees every q tile)
  const int n_groups = p.B * p.KVH, per_chunk = kChunk * p.n_tiles;
  const int chunk = static_cast<int>(blockIdx.x) / per_chunk;
  const int r = static_cast<int>(blockIdx.x) % per_chunk;
  const int cg = min(kChunk, n_groups - chunk * kChunk);       // CTAs per kv tile in this chunk
  const int kvt = r / cg;
  const int grp = chunk * kChunk + r % cg;
  const int b = grp / p.KVH, kvh = grp % p.KVH;
  const int G = p.H / p.KVH;
  const int kv0 = kvt * kBig;
  const int qt0 = p.causal ? kv0 / kSmall : 0;          // first q tile that sees row kv0
  const int per_head = max(0, (p.S + kSmall - 1) / kSmall - qt0);
  const int n_it = G * per_head;                        // (head in group, q tile) pairs
  const int wg = threadIdx.x / 128;

  // full: the TMA thread's arrival with the byte count, and one per lane of
  // the warp that writes lse and delta
  if (threadIdx.x == 0) init_barriers(bar_kv, full, empty, 1 + 32);
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 2 * Cfg::kBigTile);
#pragma unroll
        for (int x = 0; x < Cfg::kBoxes; ++x) {
          tma_load_4d(sk + x * kBigBox, &p.k, bar_kv, 64 * x, kv0, kvh, b);
          tma_load_4d(sv + x * kBigBox, &p.v, bar_kv, 64 * x, kv0, kvh, b);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        const int h = kvh * G + it / per_head;
        const int q0 = (qt0 + it % per_head) * kSmall;
        uint8_t* sq = sqd + 2 * s * Cfg::kSmallTile;
        float* st = stats + 2 * kSmall * s;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * Cfg::kSmallTile);
#pragma unroll
          for (int x = 0; x < Cfg::kBoxes; ++x) {
            tma_load_4d(sq + x * kSmallBox, &p.q, &full[s], 64 * x, q0, h, b);
            tma_load_4d(sq + Cfg::kSmallTile + x * kSmallBox, &p.dout, &full[s], 64 * x, q0, h, b);
          }
        }
        const long long base = (static_cast<long long>(b) * p.H + h) * p.S;
#pragma unroll
        for (int i = 0; i < kSmall / 32; ++i) {
          const int r = lane + 32 * i, row = q0 + r;
          // rows past S get lse = +inf, so their p is exactly 0
          st[r] = row < p.S ? p.lse[base + row] * kLog2e : CUDART_INF_F;
          st[kSmall + r] = row < p.S ? p.delta[base + row] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1, tid = threadIdx.x - 128 * wg;
    const int w = tid >> 5, g = (tid & 31) >> 2, qd = tid & 3;
    const int krow0 = kv0 + 64 * c;                     // this consumer's first kv row
    const int krow[2] = {krow0 + 16 * w + g, krow0 + 16 * w + g + 8};
    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
    const uint8_t* kc = sk + c * kHalf;
    const uint8_t* vc = sv + c * kHalf;
    mbar_wait(bar_kv, 0);

    // Two turns per q tile: S^T and dP^T, then dV and dK. dK and dV (128
    // f32 registers) leave no room to keep one tile's fragments live while
    // the next tile's scores are computed, so each consumer waits for its
    // own products and only the other consumer fills its elementwise step.
    if (n_it > 0) first_turn(c);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kStages;
      const int q0 = (qt0 + it % per_head) * kSmall;
      const uint8_t* sq = sqd + 2 * s * Cfg::kSmallTile;
      const uint8_t* sdo = sq + Cfg::kSmallTile;
      const float* st = stats + 2 * kSmall * s;
      float sc[32], dp[32];
      uint32_t pa[4][4], da[4][4];
      mbar_wait(&full[s], (it / kStages) & 1);
      begin_turn(c);
      wgmma_fence();
      mma_abt<HD>(sc, kc, sq);                          // S^T = K Q^T
      mma_abt<HD>(dp, vc, sdo);                         // dP^T = V dO^T
      wgmma_commit();
      end_turn(c, false);
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);
      // P^T in sc, dS^T = P^T (dP^T - delta) scale in dp; the q columns
      // 8jj + 2qd + e of this thread, lse and delta from the stage
      const bool diag = p.causal && q0 < krow0 + 64;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 l = *reinterpret_cast<const float2*>(st + 8 * jj + 2 * qd);
        const float2 dl = *reinterpret_cast<const float2*>(st + kSmall + 8 * jj + 2 * qd);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * jj + 2 * hh + e;
            float pv = exp2f(fmaf(sc[i], p.scale_log2, -(e ? l.y : l.x)));
            if (diag && q0 + 8 * jj + 2 * qd + e < krow[hh]) pv = 0.f;
            dp[i] = pv * (dp[i] - (e ? dl.y : dl.x)) * p.scale;
            sc[i] = pv;
          }
      }
      pack_a(sc, pa);
      pack_a(dp, da);
      begin_turn(c);
      wgmma_fence();
      mma_az<HD>(dv, pa, sdo);                          // dV += P^T dO
      mma_az<HD>(dk, da, sq);                           // dK += dS^T Q
      wgmma_commit();
      end_turn(c, it == n_it - 1);
      wgmma_wait<0>();
      fence_acc(dv);
      fence_acc(dk);
      fence_regs(pa);
      fence_regs(da);
      if ((tid & 31) == 0) mbar_arrive(&empty[s]);
    }

    stage_rows<HD>(sk + c * kHalf, dk, w, g, qd);
    stage_rows<HD>(sv + c * kHalf, dv, w, g, qd);
    fence_proxy_async();
    named_bar_sync(1 + c, 128);
    if (tid == 0) {
      store_rows<HD>(&p.out0, sk + c * kHalf, krow0, kvh, b);
      store_rows<HD>(&p.out1, sv + c * kHalf, krow0, kvh, b);
      bulk_commit();
      bulk_wait();
    }
  }
}

template <int HD>
cudaError_t launch(const BwdParams& p, bool dkv, cudaStream_t stream) {
  auto kern = dkv ? flash_bwd_dkv_kernel<HD> : flash_bwd_dq_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         BwdCfg<HD>::kSmem);
  if (err != cudaSuccess) return err;
  kern<<<p.n_tiles * p.B * (dkv ? p.KVH : p.H), kThreads, BwdCfg<HD>::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// The maps and fields of both kernels. `st` holds the (b, s, h) element
// strides of q, k, v, dout, dq and dk/dv; the dK/dV kernel owns the kv
// rows (128-row boxes of k and v, 64-row boxes of q and dout), the dQ
// kernel the q rows.
cudaError_t make_params(BwdParams* p, bool dkv, const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta, void* out0,
                        void* out1, int B, int S, int T, int H, int KVH, int hd,
                        const long long* st, float scale, int causal) {
  const int qbox = dkv ? kSmall : kBig, kvbox = dkv ? kBig : kSmall;
  cudaError_t err = make_map4(&p->q, q, B, S, H, hd, st[0], st[1], st[2], qbox);
  if (err == cudaSuccess) err = make_map4(&p->k, k, B, T, KVH, hd, st[3], st[4], st[5], kvbox);
  if (err == cudaSuccess) err = make_map4(&p->v, v, B, T, KVH, hd, st[6], st[7], st[8], kvbox);
  if (err == cudaSuccess) err = make_map4(&p->dout, dout, B, S, H, hd, st[9], st[10], st[11], qbox);
  if (dkv) {
    if (err == cudaSuccess) err = make_map4(&p->out0, out0, B, T, KVH, hd, st[15], st[16], st[17], 64);
    if (err == cudaSuccess) err = make_map4(&p->out1, out1, B, T, KVH, hd, st[15], st[16], st[17], 64);
  } else if (err == cudaSuccess) {
    err = make_map4(&p->out0, out0, B, S, H, hd, st[12], st[13], st[14], 64);
  }
  p->lse = static_cast<const float*>(lse);
  p->delta = static_cast<const float*>(delta);
  p->B = B;
  p->S = S;
  p->T = T;
  p->H = H;
  p->KVH = KVH;
  p->n_tiles = ((dkv ? T : S) + kBig - 1) / kBig;
  p->scale = scale;
  p->scale_log2 = scale * kLog2e;
  p->causal = causal;
  return err;
}

int run(bool dkv, const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* delta, void* out0, void* out1, int B, int S, int T, int H, int KVH, int hd,
        const long long* strides, float scale, int causal, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KVH <= 0 || H % KVH != 0 || (hd != 64 && hd != 128))
    return (int)cudaErrorInvalidValue;
  BwdParams p{};
  cudaError_t err = make_params(&p, dkv, q, k, v, dout, lse, delta, out0, out1, B, S, T, H, KVH,
                                hd, strides, scale, causal);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(hd == 128 ? launch<128>(p, dkv, st) : launch<64>(p, dkv, st));
}

}  // namespace
}  // namespace rtt

// q, dout (B,S,H,hd); k, v (B,T,KVH,hd): bf16, innermost dim contiguous,
// other strides in elements, multiples of 8 (16 bytes, for TMA), base
// pointers 16-byte aligned; the strides in `strides` as (b, s, h) triples
// for q, k, v, dout, dq and dk/dv (18 values). lse and delta (B,H,S) f32
// contiguous. The dK/dV entry point writes dk and dv (B,T,KVH,hd) and
// reads no dq; the dQ entry point writes dq (B,S,H,hd).
extern "C" int rtt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    int B, int S, int T, int H, int KVH, int hd, const long long* strides,
    float scale, int causal, void* stream) {
  return rtt::run(true, q, k, v, dout, lse, delta, dk, dv, B, S, T, H, KVH, hd, strides, scale,
                  causal, stream);
}

extern "C" int rtt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq,
    int B, int S, int T, int H, int KVH, int hd, const long long* strides,
    float scale, int causal, void* stream) {
  return rtt::run(false, q, k, v, dout, lse, delta, dq, nullptr, B, S, T, H, KVH, hd, strides,
                  scale, causal, stream);
}
