// A warp-specialised bf16 GEMM core for Hopper (sm_90a): TMA loads into a
// ring of shared-memory stages completed on mbarriers, wgmma products with
// f32 accumulation, and a per-kernel epilogue.
//
//   C (M, N) = A (M, K) . B (K, N), f32 in registers, one 128 x 256 tile of
//   C per CTA at a time (a persistent loop over tiles, M fastest).
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
// wgmma descriptors (PTX ISA, "Matrix Descriptor Format"; CUTLASS's
// make_gmma_desc): K-major: SBO = 1024 (next 8 rows), LBO unused, one k16
// step = +32 bytes; MN-major: LBO = 8192 (next 64-wide MN block), SBO =
// 1024 (next 8 K rows), one k16 step = +2048 bytes. Consumer c's A starts
// 8192 bytes in, in both formats.
//
// TMA zero-fills loads outside the matrix, so the ragged edges of M, N and
// K need no masks in the mainloop; epilogues mask their own stores.
#pragma once

#include <cuda.h>

#include "common.cuh"

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

enum class Major { K, MN };

// ---- mbarriers, TMA, wgmma (PTX) ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Box at column c0, row c1 of the map's matrix into dst; completes on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

// src into the box at column c0, row c1; what lies outside the matrix is
// not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0,
                                          int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This thread's TMA stores have finished reading shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// This thread's TMA stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Generic-proxy writes to shared memory become visible to TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulator across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// d (+)= A (64 x 16) . B (16 x 256); kTransA/kTransB = 1 for an MN-major
// operand. scale_d = 0 ignores d's old value.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[kAcc], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// ---- the mainloop ----

template <int kEpiBytes>
constexpr int smem_bytes() {
  return 1024 + kStages * kStageBytes + kEpiBytes + 2 * kStages * 8;
}

// Runs every tile of C assigned to this CTA; Ep::store(acc, m0, n0, c,
// tid, epi) writes consumer c's rows m0 + 64c.. of the tile at columns
// n0.. (tid: thread in the warpgroup; epi: Ep::kEpiBytes of shared memory,
// 1024-aligned). The accumulator layout of m64nNk16 (PTX ISA, "Matrix
// fragment for the accumulator"): with w = tid / 32, g = (tid % 32) / 4,
// q = tid % 4, acc[4j + 2h + e] holds row 16w + g + 8h, column 8j + 2q + e.
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
  const int tiles = tiles_m * ((N + kBN - 1) / kBN);
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
        const int m0 = (t % tiles_m) * kBM, n0 = (t / tiles_m) * kBN;
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
      const int m0 = (t % tiles_m) * kBM, n0 = (t / tiles_m) * kBN;
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

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, without linking libcuda.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(f) : nullptr;
  }();
  return fn;
}

// Map of a contiguous row-major bf16 (rows, cols) matrix read in boxes of
// box_rows x box_cols (box_cols = 64: one 128-byte swizzle row).
inline cudaError_t make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
                            int box_cols) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
