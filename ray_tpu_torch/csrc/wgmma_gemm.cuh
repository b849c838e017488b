// A warp-specialised bf16 GEMM core for Hopper (sm_90a): TMA loads into a
// ring of shared-memory stages completed on mbarriers, wgmma products with
// f32 accumulation, and a per-kernel epilogue.
//
//   C (M, N) = A (M, K) . B (K, N), f32 in registers, one 128 x 256 tile of
//   C per CTA at a time (a persistent loop over tiles, M fastest within
//   groups of kGroupM row tiles that walk all of N before the next group).
//
// Roles (384 threads, one CTA per SM):
//   warpgroup 0  producer: drops to 40 registers; one thread waits for a
//                free stage, arms its `full` barrier with the stage's bytes
//                and issues the TMA loads of A and B for the next K step;
//   warpgroups 1, 2  consumers: rise to 232 registers; consumer c owns rows
//                64c..64c+63 of the tile, waits for a stage, runs four
//                wgmma.mma_async m64n256k16 over its 64 K columns, and
//                frees the stage (one arrival per warpgroup) once the next
//                stage's products are issued; after the last K step it
//                hands its 64 x 256 f32 accumulator to the epilogue.
//
// Operands are bf16 in device memory, read through CUtensorMaps with the
// 128-byte swizzle, either K-major (K contiguous) or MN-major (M or N
// contiguous); wgmma reads an MN-major operand through the transpose bit
// of its instruction, so no transposed copy is ever made. Shared-memory
// formats (all 1024-byte aligned, rows of 128 bytes = 64 bf16):
//   K-major A:  one TMA box {64 K, 128 M}  -> [128 m][64 k]
//   K-major B:  one TMA box {64 K, 256 N}  -> [256 n][64 k]
//   MN-major A: two boxes  {64 M, 64 K}    -> [2][64 k][64 m]
//   MN-major B: four boxes {64 N, 64 K}    -> [4][64 k][64 n]
// wgmma descriptors (sm90.cuh): K-major: SBO = 1024, one k16 step = +32
// bytes; MN-major: LBO = 8192 (next 64-wide MN block, one box), SBO = 1024,
// one k16 step = +2048 bytes. Consumer c's A starts 8192 bytes in, in both
// formats.
//
// TMA zero-fills loads outside the matrix, so the ragged edges of M, N and
// K need no masks in the mainloop; epilogues mask their own stores.
#pragma once

#include "sm90.cuh"

namespace rtt {
namespace gemm {

constexpr int kBM = 128;                  // tile rows (two consumers of 64)
constexpr int kBN = 256;                  // tile columns (m64n256k16)
constexpr int kBK = 64;                   // K per stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kThreads = 384;
constexpr int kABytes = kBM * kBK * 2;    // 16 KB
constexpr int kBBytes = kBN * kBK * 2;    // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kBox = 64 * 64 * 2;         // one [64][64] box, 8 KB
constexpr int kAcc = kBN / 2;             // f32 accumulator registers per consumer thread
constexpr int kGroupM = 32;               // row tiles per raster group: 16 MB of A at K 2048

enum class Major { K, MN };

// ---- the mainloop ----

template <int kEpiBytes>
constexpr int smem_bytes() {
  return 1024 + kStages * kStageBytes + kEpiBytes + 2 * kStages * 8;
}

// Origin (m0, n0) of tile t: groups of kGroupM row tiles, each walked M
// fastest across all of N before the next, so the CTAs in flight share one
// group's rows of A in L2 (A larger than the 50 MB L2 is read about once)
// while B streams once per group. With at most kGroupM row tiles the one
// group is all of M, walked M fastest.
__device__ __forceinline__ void tile_origin(int t, int tiles_m, int tiles_n, int& m0, int& n0) {
  const int per_group = kGroupM * tiles_n;
  const int first = t / per_group * kGroupM;
  const int rows = min(kGroupM, tiles_m - first);
  const int r = t % per_group;
  m0 = (first + r % rows) * kBM;
  n0 = r / rows * kBN;
}

// Runs every tile of C assigned to this CTA; Ep::store(acc, m0, n0, c,
// tid, epi) writes consumer c's rows m0 + 64c.. of the tile at columns
// n0.. (tid: thread in the warpgroup; epi: Ep::kEpiBytes of shared memory,
// 1024-aligned). acc has the accumulator layout of sm90.cuh: acc[4j + 2h +
// e] holds row 16w + g + 8h, column 8j + 2q + e.
template <Major kA, Major kB, class Ep>
__device__ __forceinline__ void run(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                    const Ep& ep, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* epi = smem + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + Ep::kEpiBytes);
  uint64_t* empty = full + kStages;

  const int tiles_m = (M + kBM - 1) / kBM;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int tiles = tiles_m * tiles_n;
  const int nk = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);       // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0;
        tile_origin(t, tiles_m, tiles_n, m0, n0);
        for (int k = 0; k < nk; ++k) {
          const int k0 = k * kBK;
          mbar_wait(&empty[s], ph ^ 1);
          mbar_expect_tx(&full[s], kStageBytes);
          uint8_t* sa = smem + s * kStageBytes;
          uint8_t* sb = sa + kABytes;
          if (kA == Major::K) {
            tma_load(sa, map_a, &full[s], k0, m0);
          } else {
            tma_load(sa, map_a, &full[s], m0, k0);
            tma_load(sa + kBox, map_a, &full[s], m0 + 64, k0);
          }
          if (kB == Major::K) {
            tma_load(sb, map_b, &full[s], k0, n0);
          } else {
#pragma unroll
            for (int b = 0; b < 4; ++b) tma_load(sb + b * kBox, map_b, &full[s], n0 + 64 * b, k0);
          }
          if (++s == kStages) { s = 0; ph ^= 1; }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    constexpr uint32_t kLboA = kA == Major::K ? 16 : kBox, kLboB = kB == Major::K ? 16 : kBox;
    constexpr uint32_t kStepA = kA == Major::K ? 32 : 16 * 128, kStepB = kB == Major::K ? 32 : 16 * 128;
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    int s = 0, prev = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, n0;
      tile_origin(t, tiles_m, tiles_n, m0, n0);
      for (int k = 0; k < nk; ++k) {
        mbar_wait(&full[s], ph);
        const uint8_t* sa = smem + s * kStageBytes + c * kBox;
        const uint8_t* sb = smem + s * kStageBytes + kABytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_m64n256k16<kA == Major::MN, kB == Major::MN>(
              acc, smem_desc(sa + kk * kStepA, kLboA, 1024),
              smem_desc(sb + kk * kStepB, kLboB, 1024), (k | kk) != 0);
        wgmma_commit();
        if (k > 0) {                   // the previous stage's products are done
          wgmma_wait<1>();
          if (tid == 0) mbar_arrive(&empty[prev]);
        }
        prev = s;
        if (++s == kStages) { s = 0; ph ^= 1; }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (tid == 0) mbar_arrive(&empty[prev]);
      ep.store(acc, m0, n0, c, tid, epi);
    }
    if (tid == 0) bulk_wait();         // TMA stores of the epilogue, if any
  }
}

// ---- host side ----

// Map of a contiguous row-major bf16 (rows, cols) matrix read in boxes of
// box_rows x box_cols (box_cols = 64: one 128-byte swizzle row).
inline cudaError_t make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
                            int box_cols) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  return encode_map(map, base, 2, dims, strides, box);
}

// One CTA per SM (or per tile, when there are fewer tiles), with the
// shared memory of kStages stages and P::kEpiBytes for the epilogue.
template <class P>
cudaError_t launch(void (*kern)(const P), const P& p, int M, int N, cudaStream_t st) {
  constexpr int smem = smem_bytes<P::kEpiBytes>();
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  kern<<<tiles < sms ? tiles : sms, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace gemm
}  // namespace rtt
