// K3, redesigned for Hopper as the fused decode prologue.
//
// Replaces vats_tpu/ops/cache_append.py:_append_kernel (entry
// append_token_inplace) and, around it, the chain of small ops that one
// decode step runs between the QKV product and the attention of every layer
// (vats_tpu/nn/attention.py:240-244, :311-315, :520-522; XLA fuses that
// chain under jit, the port ran it one PyTorch op at a time).  One body,
// four modes (template flag MODE):
//
//   APPEND  today's K3: k_new, v_new [B, G, D] written at column
//           min(length, S-1) of layer `layer` of the dense cache
//           k, v [L, B, G, D, S] (the JAX package's sequence-minor layout);
//   DENSE   the dense decode prologue: q, k [B, 1, H, hd] L2-normalised
//           (NORM) and rotated by 1-D interleaved RoPE at position `length`;
//           q written zero-padded to D into q_out [B, 1, Hq, D]; k and v
//           written zero-padded to D into column min(length, S-1);
//   RING    DENSE with the column length % S (sliding-window ring cache);
//   PAGED   the paged decode prologue: the same norm and RoPE at each row's
//           own position lengths[b]; q and k written into q_out [B, Hq+G,
//           hd] (q heads, then k heads), which K1/K4 take with the
//           unchanged v; nothing is committed here (K1/K4 commit).
//
// Numerics follow the unfused chain (nn/norms.py l2_normalize, nn/rope.py
// apply_rope_1d), op by op, with no contraction into FMAs:
//   n  = T(x / sqrt(max(sum x^2, 1e-12)))   (IEEE sqrt and division; n is
//                                             rounded to the model dtype)
//   a  = float(pos) * inv_freq[i];  c, s = cosf(a), sinf(a)
//   r1 = T(n1*c - n2*s);  r2 = T(n1*s + n2*c)
// Only the order of the sum of squares differs from PyTorch's reduction.
// `length` / `lengths` are read on the device (no host sync), so a CUDA
// graph captures the launch.
//
// Bound: bytes, and below them the launch.  A row reads (Hq+2G)*hd elements
// and writes q, k and v once (~160 KiB at nlp_medium, B=16: 0.00005 ms at
// 3.35 TB/s), far below the time of an empty launch; what the design does
// is to replace the ~50 small kernels of the chain with this one.  One warp
// per head vector; lane i owns the interleaved pairs (2i, 2i+1) and
// (2i+64, 2i+65), so the rotation needs no exchange and the norm is one
// shuffle reduction; 4 warps a CTA over a (head block, row) grid, so B=1
// still fills several SMs.  The dense commit writes stride-S columns as the
// old K3 did (2*G*D elements a row).

#include "common.cuh"

namespace {

enum Mode { APPEND = 0, DENSE = 1, RING = 2, PAGED = 3 };

constexpr int WARPS = 4;
constexpr int MAX_PAIRS = 2;  // head dims up to 128: two pairs a lane

struct Args {
  const void* q;  // sources, [B, ..., H, hd] with row strides (elements)
  const void* k;
  const void* v;
  long long q_row, k_row, v_row;
  const int* pos;          // int32: a scalar (APPEND, DENSE, RING) or [B] (PAGED)
  const float* inv_freq;   // [hd/2] fp32 (not read in APPEND)
  void* q_out;             // DENSE, RING: [B, Hq, D]; PAGED: [B, Hq+G, hd]
  void* cache_k;           // [L, B, G, D, S] (APPEND, DENSE, RING)
  void* cache_v;
  int B, Hq, G, hd, D, S, layer;
};

template <typename T> struct Vec2;
template <> struct Vec2<__nv_bfloat16> { using type = __nv_bfloat162; };
template <> struct Vec2<float> { using type = float2; };

__device__ __forceinline__ float2 to_f2(__nv_bfloat162 x) { return __bfloat1622float2(x); }
__device__ __forceinline__ float2 to_f2(float2 x) { return x; }

template <typename T>
__device__ __forceinline__ typename Vec2<T>::type from_f2(float a, float b);
template <>
__device__ __forceinline__ __nv_bfloat162 from_f2<__nv_bfloat16>(float a, float b) {
  return __halves2bfloat162(__float2bfloat16(a), __float2bfloat16(b));
}
template <>
__device__ __forceinline__ float2 from_f2<float>(float a, float b) { return make_float2(a, b); }

// The value rounded to the model dtype and back: l2_normalize returns x.dtype.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return vats::to_f(vats::from_f<T>(x));
}

template <typename T, int MODE, bool NORM>
__global__ void __launch_bounds__(WARPS * 32) prologue_kernel(Args a) {
  using V2 = typename Vec2<T>::type;
  const int lane = threadIdx.x & 31;
  const int vec = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  const int nq = MODE == APPEND ? 0 : a.Hq;
  const int nvec = nq + (MODE == PAGED ? a.G : 2 * a.G);
  if (vec >= nvec) return;
  const bool is_q = vec < nq;
  const bool is_k = !is_q && vec < nq + a.G;
  const int h = is_q ? vec : (is_k ? vec - nq : vec - nq - a.G);
  const T* src = is_q ? (const T*)a.q + b * a.q_row
               : is_k ? (const T*)a.k + b * a.k_row
                      : (const T*)a.v + b * a.v_row;
  src += (size_t)h * a.hd;
  const int pos = MODE == PAGED ? a.pos[b] : a.pos[0];
  const bool rotate = MODE != APPEND && (is_q || is_k);

  // this lane's pairs; pad pairs (hd <= d < D) stay zero
  V2 raw[MAX_PAIRS];
  float2 x[MAX_PAIRS];
#pragma unroll
  for (int p = 0; p < MAX_PAIRS; ++p) {
    const int d = 2 * (lane + 32 * p);
    raw[p] = from_f2<T>(0.f, 0.f);
    if (d < a.hd) raw[p] = *reinterpret_cast<const V2*>(src + d);
    x[p] = to_f2(raw[p]);
  }

  if (rotate) {
    float norm = 1.f;
    if (NORM) {
      float ss = 0.f;
#pragma unroll
      for (int p = 0; p < MAX_PAIRS; ++p)
        ss = __fadd_rn(ss, __fadd_rn(__fmul_rn(x[p].x, x[p].x), __fmul_rn(x[p].y, x[p].y)));
      ss = vats::warp_sum(ss);
      norm = __fsqrt_rn(fmaxf(ss, 1e-12f));
    }
    const float fpos = __int2float_rn(pos);
#pragma unroll
    for (int p = 0; p < MAX_PAIRS; ++p) {
      const int d = 2 * (lane + 32 * p);
      if (d < a.hd) {
        float n1 = x[p].x, n2 = x[p].y;
        if (NORM) {
          n1 = round_to<T>(__fdiv_rn(n1, norm));
          n2 = round_to<T>(__fdiv_rn(n2, norm));
        }
        const float ang = __fmul_rn(fpos, a.inv_freq[d / 2]);
        const float c = cosf(ang), s = sinf(ang);
        raw[p] = from_f2<T>(__fsub_rn(__fmul_rn(n1, c), __fmul_rn(n2, s)),
                            __fadd_rn(__fmul_rn(n1, s), __fmul_rn(n2, c)));
      }
    }
  }

  if (MODE == PAGED) {  // q heads, then k heads, unpadded
    T* dst = (T*)a.q_out + ((size_t)b * (a.Hq + a.G) + vec) * a.hd;
#pragma unroll
    for (int p = 0; p < MAX_PAIRS; ++p) {
      const int d = 2 * (lane + 32 * p);
      if (d < a.hd) *reinterpret_cast<V2*>(dst + d) = raw[p];
    }
    return;
  }
  if (is_q) {  // padded to D
    T* dst = (T*)a.q_out + ((size_t)b * a.Hq + h) * a.D;
#pragma unroll
    for (int p = 0; p < MAX_PAIRS; ++p) {
      const int d = 2 * (lane + 32 * p);
      if (d < a.D) *reinterpret_cast<V2*>(dst + d) = raw[p];
    }
    return;
  }
  int col;
  if (MODE == RING) {
    col = pos % a.S;
  } else {
    col = pos < a.S - 1 ? pos : a.S - 1;
    col = col > 0 ? col : 0;
  }
  T* dst = (T*)(is_k ? a.cache_k : a.cache_v) +
           (((size_t)a.layer * a.B + b) * a.G + h) * (size_t)a.D * a.S + col;
#pragma unroll
  for (int p = 0; p < MAX_PAIRS; ++p) {
    const int d = 2 * (lane + 32 * p);
    if (d < a.D) {
      dst[(size_t)d * a.S] = raw[p].x;
      dst[(size_t)(d + 1) * a.S] = raw[p].y;
    }
  }
}

// The yardstick for the prologue's fixed cost: a kernel with its grid and
// block that does nothing.  Not on any path; chip_smoke.py times it beside
// the prologue in a replayed graph.
__global__ void empty_kernel(int unused) {}

dim3 grid_of(int mode, int B, int Hq, int G) {
  const int nvec = (mode == APPEND ? 0 : Hq) + (mode == PAGED ? G : 2 * G);
  return dim3((nvec + WARPS - 1) / WARPS, B);
}

template <typename T, int MODE>
void launch_mode(const Args& a, bool norm, cudaStream_t stream) {
  const dim3 grid = grid_of(MODE, a.B, a.Hq, a.G);
  if (norm)
    prologue_kernel<T, MODE, true><<<grid, WARPS * 32, 0, stream>>>(a);
  else
    prologue_kernel<T, MODE, false><<<grid, WARPS * 32, 0, stream>>>(a);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, long long q_row,
           long long k_row, long long v_row, const void* pos,
           const void* inv_freq, void* q_out, void* cache_k, void* cache_v,
           int mode, int norm, int B, int Hq, int G, int hd, int D, int S,
           int layer, void* stream) {
  Args a{q, k, v, q_row, k_row, v_row, (const int*)pos, (const float*)inv_freq,
         q_out, cache_k, cache_v, B, Hq, G, hd, D, S, layer};
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case APPEND: launch_mode<T, APPEND>(a, false, s); break;
    case DENSE: launch_mode<T, DENSE>(a, norm != 0, s); break;
    case RING: launch_mode<T, RING>(a, norm != 0, s); break;
    case PAGED: launch_mode<T, PAGED>(a, norm != 0, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define VATS_PROLOGUE_ENTRY(name, T)                                            \
  extern "C" int name(const void* q, const void* k, const void* v,             \
                      long long q_row, long long k_row, long long v_row,       \
                      const void* pos, const void* inv_freq, void* q_out,      \
                      void* cache_k, void* cache_v, int mode, int norm, int B, \
                      int Hq, int G, int hd, int D, int S, int layer,          \
                      void* stream) {                                          \
    return launch<T>(q, k, v, q_row, k_row, v_row, pos, inv_freq, q_out,       \
                     cache_k, cache_v, mode, norm, B, Hq, G, hd, D, S, layer,  \
                     stream);                                                  \
  }

VATS_PROLOGUE_ENTRY(vats_decode_prologue_bf16, __nv_bfloat16)
VATS_PROLOGUE_ENTRY(vats_decode_prologue_f32, float)

extern "C" int vats_decode_prologue_empty(int mode, int B, int Hq, int G, void* stream) {
  empty_kernel<<<grid_of(mode, B, Hq, G), WARPS * 32, 0, (cudaStream_t)stream>>>(0);
  return (int)cudaGetLastError();
}
