// One-pass AdamW for Hopper (sm_90a): the clip by the global norm and the
// AdamW update of one parameter leaf of `default_optimizer`
// (parallel/train_step.py), in place, in one read and one write.
//
// Replaces no TPU kernel: the reference's optimizer is optax, whose chain
// of elementwise ops XLA fuses into one pass. PyTorch runs the same chain
// as ~20 kernels a leaf, each reading and writing whole f32 tensors
// (~168 B an element with the global norm); this kernel is the fusion.
//
// For a leaf of n elements, g, p, mu and nu (one dtype, f32 or bf16), with
// the global norm (0-d f32 on the device) and the host's scalars, each
// rounded to the leaf dtype as the plain loop rounds them:
//   keep = norm < clip;  g' = g / (keep ? 1 : norm) * (keep ? 1 : clip)
//   mu  = mu * b1 + g' * (1 - b1)
//   nu  = nu * b2 + g'^2 * (1 - b2)
//   p  += (mu / bc1 / (sqrt(nu / bc2) + eps) + p * wd) * -lr
// with the plain loop's (ops/cuda_adamw.py `adamw_update_plain`) order of
// ops and rounding, so that the two agree bit for bit on the card:
// - every op rounds to its tensor's dtype (f32 through __f*_rn, which nvcc
//   never contracts into an FMA; bf16 computed in f32 and rounded after
//   each op, as PyTorch's bf16 kernels do), a product before its sum;
// - the clip's norm, a 0-d f32 tensor, is cast to the leaf dtype first,
//   as the loop casts it; a tensor times a Python scalar (1 - b1, 1 - b2)
//   takes the scalar in f32 (read on the card);
// - a tensor over a Python scalar (mu / bc1, nu / bc2) is PyTorch's CUDA
//   product with the f32 reciprocal of the scalar, not a division.
//
// Bound on the H100: the pass reads g, p, mu and nu and writes p, mu and
// nu once: 28 B an element in f32, 14 in bf16. At 3,758,231,552 f32
// parameters that is 105 GB, 31.4 ms at 3.35 TB/s; the largest leaf
// (939,524,096 elements) 7.85 ms. Memory bandwidth bounds it (~1 op a
// byte). Design against that bound: 16-byte loads and stores only (8
// elements a pack: two float4 or one 8 x bf16 vector an array), two packs
// in flight a thread, all loads issued before any arithmetic; a grid of
// as many resident blocks as the card holds, striding over the packs; no
// shared memory and no temporaries. A leaf whose size is not a multiple
// of 8 ends in a scalar tail, and a leaf with a pointer that is not
// 16-byte aligned runs wholly through the scalar path.

#include "common.cuh"

namespace rtt {
namespace {

constexpr int kThreads = 256;
constexpr int kPack = 8;      // elements a pack: 16 bytes of bf16, 32 of f32
constexpr int kUnroll = 2;    // packs in flight a thread

// The host's scalars, in this order in the array the entry point takes.
struct Scalars {
  float clip_f32;   // grad_clip in f32: the norm is compared with it
  float clip;       // grad_clip, b1, ... rounded to the leaf dtype
  float b1, omb1, b2, omb2, bc1, bc2, eps, wd, neg_lr;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// x rounded to T, back in f32.
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ void load_pack(const float* src, float (&v)[kPack]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load_pack(const bf16* src, float (&v)[kPack]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kPack / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_pack(float* dst, const float (&v)[kPack]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store_pack(bf16* dst, const float (&v)[kPack]) {
  uint4 raw;
  uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
  for (int i = 0; i < kPack / 2; ++i) w[i] = pack_bf16(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = raw;
}

// The per-leaf factors, formed on the device from the norm: no sync.
struct Leaf {
  float div, fac;             // the clip: g / div * fac
  float inv_bc1, inv_bc2;     // f32 reciprocals of bc1, bc2
};

template <typename T>
__device__ __forceinline__ Leaf leaf_factors(const Scalars& s, float norm) {
  const bool keep = norm < s.clip_f32;
  Leaf f;
  f.div = keep ? 1.0f : rnd<T>(norm);
  f.fac = keep ? 1.0f : s.clip;
  f.inv_bc1 = __fdiv_rn(1.0f, s.bc1);
  f.inv_bc2 = __fdiv_rn(1.0f, s.bc2);
  return f;
}

// One element; g, p, mu, nu hold their tensors' values in f32.
template <typename T>
__device__ __forceinline__ void step(const Scalars& s, const Leaf& f, float g, float& p,
                                     float& mu, float& nu) {
  g = rnd<T>(__fdiv_rn(g, f.div));
  g = rnd<T>(__fmul_rn(g, f.fac));
  mu = rnd<T>(__fmul_rn(mu, s.b1));
  mu = rnd<T>(__fadd_rn(mu, rnd<T>(__fmul_rn(g, s.omb1))));
  nu = rnd<T>(__fmul_rn(nu, s.b2));
  const float sq = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(g, g)), s.omb2));
  nu = rnd<T>(__fadd_rn(nu, sq));
  float u = rnd<T>(__fmul_rn(mu, f.inv_bc1));
  float den = rnd<T>(__fmul_rn(nu, f.inv_bc2));
  den = rnd<T>(__fsqrt_rn(den));
  den = rnd<T>(__fadd_rn(den, s.eps));
  u = rnd<T>(__fdiv_rn(u, den));
  u = rnd<T>(__fadd_rn(u, rnd<T>(__fmul_rn(p, s.wd))));
  u = rnd<T>(__fmul_rn(u, s.neg_lr));
  p = rnd<T>(__fadd_rn(p, u));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_adamw_kernel(const T* __restrict__ g, T* __restrict__ p, T* __restrict__ mu,
                   T* __restrict__ nu, const float* __restrict__ norm, long long n,
                   long long n_packs, Scalars s) {
  const Leaf f = leaf_factors<T>(s, *norm);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long i = tid; i < n_packs; i += stride * kUnroll) {
    float gv[kUnroll][kPack], pv[kUnroll][kPack], mv[kUnroll][kPack], vv[kUnroll][kPack];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = (i + u * stride) * kPack;
      if (i + u * stride < n_packs) {
        load_pack(g + e, gv[u]);
        load_pack(p + e, pv[u]);
        load_pack(mu + e, mv[u]);
        load_pack(nu + e, vv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = (i + u * stride) * kPack;
      if (i + u * stride < n_packs) {
#pragma unroll
        for (int k = 0; k < kPack; ++k) step<T>(s, f, gv[u][k], pv[u][k], mv[u][k], vv[u][k]);
        store_pack(p + e, pv[u]);
        store_pack(mu + e, mv[u]);
        store_pack(nu + e, vv[u]);
      }
    }
  }
  // the tail past the last whole pack, or every element when unaligned
  for (long long e = n_packs * kPack + tid; e < n; e += stride) {
    float pe = to_f(p[e]), me = to_f(mu[e]), ve = to_f(nu[e]);
    step<T>(s, f, to_f(g[e]), pe, me, ve);
    p[e] = from_f<T>(pe);
    mu[e] = from_f<T>(me);
    nu[e] = from_f<T>(ve);
  }
}

template <typename T>
cudaError_t launch(const void* g, void* p, void* mu, void* nu, const float* norm, long long n,
                   const Scalars& s, cudaStream_t stream) {
  auto kernel = fused_adamw_kernel<T>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  static int per_sm = 0;  // resident blocks an SM; the same on every sm_90a card
  if (err == cudaSuccess && per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(p) |
        reinterpret_cast<uintptr_t>(mu) | reinterpret_cast<uintptr_t>(nu)) % 16) == 0;
  const long long n_packs = aligned ? n / kPack : 0;
  const long long work = aligned ? -(-n_packs / kUnroll) : n;   // items for the first sweep
  const long long want = (work + kThreads - 1) / kThreads;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(want < 1 ? 1 : (want < most ? want : most));
  kernel<<<grid, kThreads, 0, stream>>>(static_cast<const T*>(g), static_cast<T*>(p),
                                        static_cast<T*>(mu), static_cast<T*>(nu), norm, n,
                                        n_packs, s);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rtt

// p, mu, nu (n elements, in bf16 if `is_bf16`, else in f32) updated in
// place from g (of their dtype) and the global norm (0-d f32 on the
// device); `scalars` points to the 11 host floats of rtt::Scalars, in its
// order.
extern "C" int rtt_fused_adamw(const void* g, void* p, void* mu, void* nu, const void* norm,
                               long long n, int is_bf16, const float* scalars, void* stream) {
  using namespace rtt;
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  Scalars s;
  s.clip_f32 = scalars[0];
  s.clip = scalars[1];
  s.b1 = scalars[2];
  s.omb1 = scalars[3];
  s.b2 = scalars[4];
  s.omb2 = scalars[5];
  s.bc1 = scalars[6];
  s.bc2 = scalars[7];
  s.eps = scalars[8];
  s.wd = scalars[9];
  s.neg_lr = scalars[10];
  const float* nrm = static_cast<const float*>(norm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch<bf16>(g, p, mu, nu, nrm, n, s, st)
                                  : launch<float>(g, p, mu, nu, nrm, n, s, st);
  return (int)err;
}
