// K8: the AdamW update, or one gradient accumulation step, over every leaf of
// a model in one launch.
//
// Replaces no Pallas kernel: vats_tpu leaves optax's adamw and MultiSteps to
// XLA, which fuses each leaf's chain under jit.  The port's plain version
// (vats_tpu_torch/ops/adamw.py, adamw_update_ref and accumulate_ref) runs
// that chain as about 20 elementwise PyTorch kernels a leaf, each reading and
// writing whole fp32 tensors: ~172 bytes a parameter where an update needs
// 24.
//
// Bound: bytes.  About 0.6 operations a byte against the card's ~295.  An
// update reads p, g, mu and nu and writes p, mu and nu once: 24 bytes a
// parameter with an fp32 p and a bf16 mu, 4 more where the accumulator it
// reads is reset in the same pass.  An accumulation step reads g and acc and
// writes acc: 12 bytes.
//
// Design: one pass, every intermediate in registers.
//   * A leaf table on the device, built by the wrapper once for a set of
//     tensors (outside any capture): each leaf's pointers, length, first
//     chunk and dtypes (ROW int64 words a leaf).  A leaf is cut into chunks
//     of CHUNK elements.  A persistent grid (as many CTAs as fit on the SMs)
//     walks the chunks blockIdx.x, + gridDim.x, ..., each CTA finding a
//     chunk's leaf by walking the table forward, so a 768-element norm weight
//     is one chunk among the tied embedding's thousands and costs no wave.
//   * A thread takes 4 consecutive elements a step: 16-byte loads of fp32 (8
//     bytes of bf16) where every pointer of the leaf is 16-byte aligned; a
//     scalar loop takes a tail that is not a multiple of 4, and a leaf that
//     is not aligned.
//   * The arithmetic is the plain version's, operation for operation and
//     rounding for rounding.  Each operation is an intrinsic that rounds to
//     nearest (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), so
//     nvcc contracts nothing into an FMA, and each result is rounded to the
//     dtype PyTorch gives it (rnd<T>): a 0-d fp32 coefficient meets a bf16
//     tensor as bf16, a Python number (eps, weight decay) stays fp32.  The
//     card gives the plain version's bits.
//   * The step's coefficients (bias corrections, decays, learning rate, the
//     clip's scale, the finite flag) are 0-d device tensors read by pointer:
//     a replayed CUDA graph reads each step's values, the host never waits.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 8192;  // elements a chunk: 8 steps of 4 a thread
constexpr int ROW = 8;       // table words a leaf: p, g, mu, nu, numel, chunk0, kind, 0

// kind bits: the param (and grad, nu, acc) dtype is bf16; mu is bf16; every
// pointer of the leaf is 16-byte aligned
constexpr long long T_BF16 = 1, M_BF16 = 2, ALIGNED = 4;

static_assert(CHUNK % 4 == 0, "chunks start on a 4-element boundary");

// x rounded to T's precision, as PyTorch stores a result of dtype T
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat16 h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __float2bfloat16(v[j]);
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// The update's device coefficients (0-d fp32 tensors; scale and finite may be
// null) and its host numbers.
struct Coef {
  const float *bc1, *bc2, *d1, *c1, *d2, *c2, *neg_lr, *scale;
  const bool* finite;
  float eps, wd;
  int has_wd, reset;
};

// The coefficients' values, read once a CTA
struct Vals {
  float bc1, bc2, d1, c1, d2, c2, neg_lr, scale;
  bool has_scale, finite;
};

// One element of optax's adamw as the plain version computes it (T: param,
// grad and nu dtype; M: mu dtype).  g is the gradient as stored; where the
// pass resets it (MultiSteps' accumulator) it leaves as g * 0.
template <typename T, typename M>
struct Update {
  float sc, d1, c1, d2, c2, bc1, bc2, neg_lr, eps, wd;
  bool has_scale, finite, has_wd, reset;

  __device__ Update(const Vals& v, const Coef& k)
      : sc(rnd<T>(v.scale)), d1(rnd<M>(v.d1)), c1(rnd<T>(v.c1)), d2(rnd<T>(v.d2)),
        c2(rnd<T>(v.c2)), bc1(v.bc1), bc2(rnd<T>(v.bc2)), neg_lr(v.neg_lr), eps(k.eps),
        wd(k.wd), has_scale(v.has_scale), finite(v.finite), has_wd(k.has_wd != 0),
        reset(k.reset != 0) {}

  __device__ __forceinline__ void operator()(float& p, float& g, float& mu, float& nu) const {
    float gs = g;
    if (has_scale) gs = rnd<T>(__fmul_rn(gs, sc));                 // g * scale.to(T)
    if (!finite) gs = 0.f;                                         // where(finite, g, 0)
    const float mu32 = __fadd_rn(rnd<M>(__fmul_rn(mu, d1)),        // (mu * d1.to(M)).float()
                                 rnd<T>(__fmul_rn(c1, gs)));       //   + c1 * g
    const float nu_d = rnd<T>(__fmul_rn(nu, d2));                  // nu.mul_(d2)
    nu = rnd<T>(__fadd_rn(nu_d, rnd<T>(__fmul_rn(c2, rnd<T>(__fmul_rn(gs, gs))))));
    const float den = rnd<T>(__fadd_rn(                            // sqrt(nu / bc2) + eps
        rnd<T>(__fsqrt_rn(rnd<T>(__fdiv_rn(nu, bc2)))), eps));
    float u = __fdiv_rn(__fdiv_rn(mu32, bc1), den);
    if (has_wd) u = __fadd_rn(u, rnd<T>(__fmul_rn(wd, p)));        // + wd * p
    p = rnd<T>(__fadd_rn(p, __fmul_rn(u, neg_lr)));                // p.add_(u * neg_lr)
    mu = mu32;                                                     // mu.copy_(mu32)
    if (reset) g = rnd<T>(__fmul_rn(g, 0.f));                      // acc.mul_(0)
  }
};

// One element of MultiSteps' mean: acc.add_((g - acc) / n), the division by a
// host number done as PyTorch does it, times the fp32 reciprocal r.
template <typename T>
__device__ __forceinline__ float accumulate(float acc, float g, float r) {
  return rnd<T>(__fadd_rn(acc, rnd<T>(__fmul_rn(rnd<T>(__fsub_rn(g, acc)), r))));
}

// The leaf of chunk c: the last leaf whose first chunk is <= c, from `leaf`
// on (a CTA's chunks only grow)
__device__ __forceinline__ int leaf_of(const long long* table, int n_leaves, int c, int leaf) {
  while (leaf + 1 < n_leaves && table[(long long)(leaf + 1) * ROW + 5] <= c) ++leaf;
  return leaf;
}

template <typename T, typename M>
__device__ void update_chunk(const long long* row, long long start, long long end,
                             const Update<T, M>& op) {
  T* p = reinterpret_cast<T*>(row[0]);
  T* g = reinterpret_cast<T*>(row[1]);
  M* mu = reinterpret_cast<M*>(row[2]);
  T* nu = reinterpret_cast<T*>(row[3]);
  long long i0 = start;
  if (row[6] & ALIGNED) {
    const long long vend = start + ((end - start) & ~3LL);
    for (long long i = start + 4 * threadIdx.x; i < vend; i += 4 * THREADS) {
      float vp[4], vg[4], vm[4], vn[4];
      load4(p + i, vp);
      load4(g + i, vg);
      load4(mu + i, vm);
      load4(nu + i, vn);
#pragma unroll
      for (int j = 0; j < 4; ++j) op(vp[j], vg[j], vm[j], vn[j]);
      store4(p + i, vp);
      store4(mu + i, vm);
      store4(nu + i, vn);
      if (op.reset) store4(g + i, vg);
    }
    i0 = vend;
  }
  for (long long i = i0 + threadIdx.x; i < end; i += THREADS) {
    float vp = vats::to_f(p[i]), vg = vats::to_f(g[i]), vm = vats::to_f(mu[i]),
          vn = vats::to_f(nu[i]);
    op(vp, vg, vm, vn);
    p[i] = vats::from_f<T>(vp);
    mu[i] = vats::from_f<M>(vm);
    nu[i] = vats::from_f<T>(vn);
    if (op.reset) g[i] = vats::from_f<T>(vg);
  }
}

template <typename T>
__device__ void accumulate_chunk(const long long* row, long long start, long long end, float r) {
  T* acc = reinterpret_cast<T*>(row[0]);
  const T* g = reinterpret_cast<const T*>(row[1]);
  long long i0 = start;
  if (row[6] & ALIGNED) {
    const long long vend = start + ((end - start) & ~3LL);
    for (long long i = start + 4 * threadIdx.x; i < vend; i += 4 * THREADS) {
      float va[4], vg[4];
      load4(acc + i, va);
      load4(g + i, vg);
#pragma unroll
      for (int j = 0; j < 4; ++j) va[j] = accumulate<T>(va[j], vg[j], r);
      store4(acc + i, va);
    }
    i0 = vend;
  }
  for (long long i = i0 + threadIdx.x; i < end; i += THREADS)
    acc[i] = vats::from_f<T>(accumulate<T>(vats::to_f(acc[i]), vats::to_f(g[i]), r));
}

__global__ void __launch_bounds__(THREADS)
adamw_update_kernel(const long long* __restrict__ table, int n_leaves, int n_chunks,
                    const Coef k) {
  Vals v;
  v.bc1 = *k.bc1;
  v.bc2 = *k.bc2;
  v.d1 = *k.d1;
  v.c1 = *k.c1;
  v.d2 = *k.d2;
  v.c2 = *k.c2;
  v.neg_lr = *k.neg_lr;
  v.has_scale = k.scale != nullptr;
  v.scale = v.has_scale ? *k.scale : 1.f;
  v.finite = k.finite == nullptr || *k.finite;
  int leaf = 0;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    leaf = leaf_of(table, n_leaves, c, leaf);
    const long long* row = table + (long long)leaf * ROW;
    const long long start = (long long)(c - row[5]) * CHUNK;
    const long long end = min(start + CHUNK, row[4]);
    switch (row[6] & (T_BF16 | M_BF16)) {
      case 0:
        update_chunk(row, start, end, Update<float, float>(v, k));
        break;
      case T_BF16:
        update_chunk(row, start, end, Update<__nv_bfloat16, float>(v, k));
        break;
      case M_BF16:
        update_chunk(row, start, end, Update<float, __nv_bfloat16>(v, k));
        break;
      default:
        update_chunk(row, start, end, Update<__nv_bfloat16, __nv_bfloat16>(v, k));
    }
  }
}

__global__ void __launch_bounds__(THREADS)
accumulate_kernel(const long long* __restrict__ table, int n_leaves, int n_chunks, float r) {
  int leaf = 0;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    leaf = leaf_of(table, n_leaves, c, leaf);
    const long long* row = table + (long long)leaf * ROW;
    const long long start = (long long)(c - row[5]) * CHUNK;
    const long long end = min(start + CHUNK, row[4]);
    if (row[6] & T_BF16) accumulate_chunk<__nv_bfloat16>(row, start, end, r);
    else accumulate_chunk<float>(row, start, end, r);
  }
}

// CTAs of a persistent grid for `kernel`: as many as fit on the SMs at once
// (read once; the first launch is eager, outside any capture)
template <typename K>
int persistent_grid(K kernel, int n_chunks) {
  static int ctas = 0;
  if (ctas == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0) !=
            cudaSuccess)
      return 0;
    ctas = sms * (per_sm > 0 ? per_sm : 1);
  }
  return n_chunks < ctas ? n_chunks : ctas;
}

}  // namespace

// table [n_leaves, ROW] int64 on the device (p, g, mu, nu, numel, first
// chunk, kind); n_chunks the leaves' chunks together.  bc1 ... neg_lr 0-d
// fp32 device tensors; scale (0-d fp32) and finite (0-d bool) may be null.
// reset: write g * 0 into g after reading it.
extern "C" int vats_adamw_update(const void* table, int n_leaves, int n_chunks,
                                 const void* bc1, const void* bc2, const void* d1,
                                 const void* c1, const void* d2, const void* c2,
                                 const void* neg_lr, const void* scale, const void* finite,
                                 float eps, float wd, int has_wd, int reset, void* stream) {
  if (n_chunks == 0) return 0;
  if (n_leaves <= 0 || n_chunks < 0) return (int)cudaErrorInvalidValue;
  const int grid = persistent_grid(adamw_update_kernel, n_chunks);
  if (grid <= 0) return (int)cudaGetLastError();
  Coef k;
  k.bc1 = (const float*)bc1;
  k.bc2 = (const float*)bc2;
  k.d1 = (const float*)d1;
  k.c1 = (const float*)c1;
  k.d2 = (const float*)d2;
  k.c2 = (const float*)c2;
  k.neg_lr = (const float*)neg_lr;
  k.scale = (const float*)scale;
  k.finite = (const bool*)finite;
  k.eps = eps;
  k.wd = wd;
  k.has_wd = has_wd;
  k.reset = reset;
  adamw_update_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)table, n_leaves, n_chunks, k);
  return (int)cudaGetLastError();
}

// table as above with (acc, g, -, -, numel, first chunk, kind); acc is the
// running mean of `count` - 1 gradients, g the count-th.
extern "C" int vats_accumulate(const void* table, int n_leaves, int n_chunks, int count,
                               void* stream) {
  if (n_chunks == 0) return 0;
  if (n_leaves <= 0 || n_chunks < 0 || count <= 0) return (int)cudaErrorInvalidValue;
  const int grid = persistent_grid(accumulate_kernel, n_chunks);
  if (grid <= 0) return (int)cudaGetLastError();
  const float r = 1.0f / (float)count;  // PyTorch's reciprocal of a host divisor
  accumulate_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>((const long long*)table,
                                                               n_leaves, n_chunks, r);
  return (int)cudaGetLastError();
}
