// K1 and K4: paged decode attention with in-place commit of the current
// token, over bf16/fp32 pools (K1) and int8 pools with fp32 scales (K4).
//
// Replaces vats_tpu/ops/decode_attention.py:_decode_kernel (built by
// _run_decode_kernel, entered through paged_decode_attention_commit and,
// with commit=0, paged_decode_attention): K1 is its bf16 mode, K4 its
// quantized=True mode.  One body serves both; the storage type T selects
// the mode at compile time.
//
// Semantics (identical to the JAX kernel and its XLA oracle):
//   * one query token per row b with Hq = G*N heads attends over the row's
//     lengths[b] settled tokens, read through page_table[b], plus one extra,
//     always-valid column: the current token's K/V (`cur`).  That column
//     seeds the fp32 online softmax (m = s_cur, l = 1, o = v_cur).
//   * K1: q and cur arrive in pool precision.  K4: q, cur and the output
//     are fp32 (q attends in its own precision, the current token
//     unquantized); each history score is (q . k_int8) * k_scale * scale,
//     and each probability is multiplied by its token's v_scale before p.v
//     (the normaliser sums the unscaled probabilities).
//   * with commit, the current K/V is written into slot
//     pos = min(lengths[b], PPS*PS - 1) of its page, in place.  The write
//     happens after every read of the block, so a row at capacity attends
//     the old value of the clamped slot, as the oracle does.  K4 quantizes
//     it first, per (K/V, group), exactly as quantize_kv does: amax over the
//     stored head dim (pad elements are 0), scale = max(amax, 1e-8) / 127,
//     q = clip(rint(x / scale), -127, 127) with IEEE divisions and
//     round-half-even (no fast math), so the committed bytes equal the
//     plain append's; the scale goes to the scales pool.
//   * no sliding-window mask (the JAX kernel has none either).
//
// Layout (the port's own): pool [L, P, 2, G, PS, D], head dim minor and
// zero-padded to whole 16-byte vectors (D = 8k for bf16/fp32, 16k for
// int8; 60 -> 64), so a token's K row is D contiguous elements (128 bytes at
// D=64 bf16, 64 bytes int8: eight or four 16-byte loads).  Scales (K4)
// [L, P, 2, G, PS] fp32, so a tile's 128 scales are one coalesced read.
// The JAX pool is sequence-minor [L, P, 2, G, D, PS] for the TPU's (8, 128)
// tiling, and its scales pad G to 8.
//
// Bound: bytes.  Each row reads lengths[b] * 2 * G * D pool elements once
// (plus, for K4, lengths[b] * 2 * G fp32 scales: 0.53x K1's bytes at D=64);
// the arithmetic is ~4*N FLOPs per element read (N = 3 at the medium tier).
// Design: one block per (row, group) streams that group's tokens in tiles of
// 128.  Each thread loads one token's K and V rows with 16-byte loads, up to
// 16 in flight at once; q.k runs from registers (one token per thread), and the V
// rows are staged in shared memory (rows padded by 16 bytes: no bank
// conflicts) so p.v (D-wide thread groups, one output dim each) reads no
// device memory.  K4 stages the V scales beside them and folds them into
// the probabilities it stores for p.v.  All N query heads of the group
// share each K/V load.  No split over the sequence yet: at B=32 the grid is
// 256 blocks.  Masked columns (positions >= lengths[b]) are never loaded and
// their probabilities are selected to 0, never multiplied by 0.  K4's
// commit quantizes with one warp per K and V (the amax is a warp reduction).

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int TILE = 128;  // tokens per tile, one per thread for q.k
constexpr int NMAX = 8;    // query heads per KV group
constexpr int DMAX = 128;  // padded head dim
constexpr int NWARPS = THREADS / 32;

// T: pool storage type; Q: type of q, cur and out (T for K1, float for K4)
template <typename T, typename Q>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const Q* __restrict__ q,        // [B, G, N, D]
                    const Q* __restrict__ cur,      // [B, 2, G, D]
                    T* pool,                        // [L, P, 2, G, PS, D]
                    float* scales,                  // [L, P, 2, G, PS] (K4)
                    const int* __restrict__ table,  // [B, PPS]
                    const int* __restrict__ lengths,  // [B]
                    Q* __restrict__ out,            // [B, G, N, D]
                    int G, int N, int D, int P, int PS, int PPS, int layer,
                    float scale, int commit) {
  constexpr bool QUANT = vats::is_int8<T>::value;
  const int b = blockIdx.x / G;
  const int g = blockIdx.x % G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  __shared__ __align__(16) float q_s[NMAX][DMAX];
  __shared__ float p_s[NMAX][TILE];  // probabilities (times v_scale in K4)
  __shared__ float red_s[NMAX][NWARPS];
  __shared__ float vsc_s[TILE];  // V scales of the current tile (K4)
  // V rows of the current tile, D + 16 bytes apart (dynamic: TILE * VS * sizeof(T))
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  T* v_s = reinterpret_cast<T*>(dyn_smem);
  const int VS = D + 16 / (int)sizeof(T);
  __shared__ float m_s[NMAX], l_s[NMAX], alpha_s[NMAX];
  __shared__ float comb_s[NMAX][THREADS];

  const size_t page_elems = (size_t)2 * G * PS * D;
  const size_t v_off = (size_t)G * PS * D;  // V half of a page
  T* pool_l = pool + (size_t)layer * P * page_elems;
  // scales of one page: [2, G, PS]
  float* sc_l = QUANT ? scales + (size_t)layer * P * 2 * G * PS : nullptr;
  const int len = lengths[b];

  for (int i = tid; i < N * D; i += THREADS)
    q_s[i / D][i % D] = vats::to_f(q[(size_t)(b * G + g) * N * D + i]);
  const Q* kc = cur + ((size_t)(b * 2 + 0) * G + g) * D;
  const Q* vc = cur + ((size_t)(b * 2 + 1) * G + g) * D;
  __syncthreads();

  // seed the online softmax with the current token's column
  if (warp == 0) {
    for (int h = 0; h < N; ++h) {
      float part = 0.f;
      for (int d = lane; d < D; d += 32) part += q_s[h][d] * vats::to_f(kc[d]);
      part = vats::warp_sum(part);
      if (lane == 0) {
        m_s[h] = part * scale;
        l_s[h] = 1.f;
      }
    }
  }

  // p.v thread layout: nsplit groups of D threads; thread (split, dd) owns
  // output dim dd of every head, over tokens split, split+nsplit, ...
  const int nsplit = THREADS / D;
  const int split = tid / D;
  const int dd = tid % D;
  const bool pv_active = split < nsplit;
  float acc[NMAX];
#pragma unroll
  for (int h = 0; h < NMAX; ++h)
    acc[h] = (pv_active && split == 0 && h < N) ? vats::to_f(vc[dd]) : 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += TILE) {
    const int ntile = min(TILE, len - t0);
    const bool valid = tid < ntile;
    float s[NMAX];
#pragma unroll
    for (int h = 0; h < NMAX; ++h) s[h] = 0.f;
    if (valid) {
      const int tok = t0 + tid;
      const int page = table[(size_t)b * PPS + tok / PS];
      const size_t row = (size_t)page * page_elems + ((size_t)g * PS + tok % PS) * D;
      const uint4* ksrc = reinterpret_cast<const uint4*>(pool_l + row);
      const uint4* vsrc = reinterpret_cast<const uint4*>(pool_l + row + v_off);
      uint4* vdst = reinterpret_cast<uint4*>(v_s + tid * VS);
      constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
      const int nchunk = D / EPC;
      // up to 8 K and 8 V chunks in flight per thread before any is used
      for (int c0 = 0; c0 < nchunk; c0 += 8) {
        uint4 kraw[8], vraw[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (c0 + j < nchunk) {
            kraw[j] = ksrc[c0 + j];
            vraw[j] = vsrc[c0 + j];
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (c0 + j < nchunk) {
            vdst[c0 + j] = vraw[j];
            float kv[EPC];
            vats::unpack16(kraw[j], kv, (const T*)nullptr);
            const int d = (c0 + j) * EPC;
#pragma unroll
            for (int h = 0; h < NMAX; ++h) {
              if (h < N) {
#pragma unroll
                for (int e = 0; e < EPC; ++e) s[h] += q_s[h][d + e] * kv[e];
              }
            }
          }
        }
      }
      if constexpr (QUANT) {
        const size_t sc_row = ((size_t)page * 2 * G + g) * PS + tok % PS;
        const float ksc = sc_l[sc_row];
        vsc_s[tid] = sc_l[sc_row + (size_t)G * PS];
#pragma unroll
        for (int h = 0; h < NMAX; ++h) s[h] *= ksc;
      }
#pragma unroll
      for (int h = 0; h < NMAX; ++h) s[h] *= scale;
    }
    // tile max per head -> new running max and the rescale factor
#pragma unroll
    for (int h = 0; h < NMAX; ++h) {
      if (h < N) {
        float v = vats::warp_max(valid ? s[h] : -INFINITY);
        if (lane == 0) red_s[h][warp] = v;
      }
    }
    __syncthreads();
    if (tid < N) {
      float mx = red_s[tid][0];
      for (int w = 1; w < NWARPS; ++w) mx = fmaxf(mx, red_s[tid][w]);
      const float m_old = m_s[tid];
      const float m_new = fmaxf(m_old, mx);
      alpha_s[tid] = expf(m_old - m_new);
      m_s[tid] = m_new;
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < NMAX; ++h) {
      if (h < N) {
        const float p = valid ? expf(s[h] - m_s[h]) : 0.f;
        p_s[h][tid] = (QUANT && valid) ? p * vsc_s[tid] : p;
        const float sum = vats::warp_sum(p);
        if (lane == 0) red_s[h][warp] = sum;
      }
    }
    __syncthreads();
    if (tid < N) {
      float sum = 0.f;
      for (int w = 0; w < NWARPS; ++w) sum += red_s[tid][w];
      l_s[tid] = alpha_s[tid] * l_s[tid] + sum;
    }
    if (pv_active) {
#pragma unroll
      for (int h = 0; h < NMAX; ++h) acc[h] *= (h < N) ? alpha_s[h] : 0.f;
      for (int t = split; t < ntile; t += nsplit) {
        const float vv = vats::to_f(v_s[t * VS + dd]);
#pragma unroll
        for (int h = 0; h < NMAX; ++h)
          if (h < N) acc[h] += p_s[h][t] * vv;
      }
    }
    __syncthreads();  // p_s, v_s, vsc_s and red_s are rewritten by the next tile
  }

  if (pv_active) {
#pragma unroll
    for (int h = 0; h < NMAX; ++h)
      if (h < N) comb_s[h][tid] = acc[h];
  }
  __syncthreads();
  for (int i = tid; i < N * D; i += THREADS) {
    const int h = i / D;
    const int d = i % D;
    float sum = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) sum += comb_s[h][sp * D + d];
    float l = l_s[h];
    l = (l == 0.f) ? 1.f : l;
    out[(size_t)(b * G + g) * N * D + i] = vats::from_f<Q>(sum / l);
  }

  if (commit) {
    // every read of this block's pages finished before the barrier above
    const int cap = PPS * PS;
    const int pos = len < cap - 1 ? len : cap - 1;
    const int page = table[(size_t)b * PPS + pos / PS];
    const size_t row = (size_t)page * page_elems + ((size_t)g * PS + pos % PS) * D;
    if constexpr (QUANT) {
      // warp 0 quantizes K, warp 1 V; D <= 128 is at most 4 values a lane
      if (warp < 2) {
        const Q* src = warp == 0 ? kc : vc;
        float x[DMAX / 32];
        float amax = 0.f;
#pragma unroll
        for (int j = 0; j < DMAX / 32; ++j) {
          const int d = lane + 32 * j;
          x[j] = d < D ? vats::to_f(src[d]) : 0.f;
          amax = fmaxf(amax, fabsf(x[j]));
        }
        amax = vats::warp_max(amax);
        const float qs = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
        T* dst = pool_l + row + (warp == 0 ? 0 : v_off);
#pragma unroll
        for (int j = 0; j < DMAX / 32; ++j) {
          const int d = lane + 32 * j;
          if (d < D) {
            const float r = fminf(fmaxf(rintf(__fdiv_rn(x[j], qs)), -127.f), 127.f);
            dst[d] = vats::from_f<T>(r);
          }
        }
        if (lane == 0)
          sc_l[((size_t)page * 2 * G + (size_t)warp * G + g) * PS + pos % PS] = qs;
      }
    } else {
      for (int d = tid; d < D; d += THREADS) {
        pool_l[row + d] = vats::from_f<T>(vats::to_f(kc[d]));
        pool_l[row + v_off + d] = vats::from_f<T>(vats::to_f(vc[d]));
      }
    }
  }
}

template <typename T, typename Q>
int launch(const void* q, const void* cur, void* pool, void* scales,
           const void* table, const void* lengths, void* out, int B, int G,
           int N, int D, int P, int PS, int PPS, int layer, float scale,
           int commit, void* stream) {
  constexpr int GRANULE = 16 / sizeof(T) > 8 ? 16 / sizeof(T) : 8;
  if (N > NMAX || D > DMAX || D % GRANULE != 0) return (int)cudaErrorInvalidValue;
  if (vats::is_int8<T>::value && scales == nullptr) return (int)cudaErrorInvalidValue;
  const int smem = TILE * (D + 16 / (int)sizeof(T)) * (int)sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  paged_decode_kernel<T, Q><<<B * G, THREADS, smem, (cudaStream_t)stream>>>(
      (const Q*)q, (const Q*)cur, (T*)pool, (float*)scales, (const int*)table,
      (const int*)lengths, (Q*)out, G, N, D, P, PS, PPS, layer, scale, commit);
  return (int)cudaGetLastError();
}

}  // namespace

#define VATS_DECODE_ENTRY(NAME, T, Q)                                           \
  extern "C" int NAME(const void* q, const void* cur, void* pool, void* scales, \
                      const void* table, const void* lengths, void* out, int B, \
                      int G, int N, int D, int P, int PS, int PPS, int layer,   \
                      float scale, int commit, void* stream) {                  \
    return launch<T, Q>(q, cur, pool, scales, table, lengths, out, B, G, N, D,  \
                        P, PS, PPS, layer, scale, commit, stream);              \
  }

VATS_DECODE_ENTRY(vats_paged_decode_bf16, __nv_bfloat16, __nv_bfloat16)
VATS_DECODE_ENTRY(vats_paged_decode_f32, float, float)
VATS_DECODE_ENTRY(vats_paged_decode_int8, int8_t, float)
