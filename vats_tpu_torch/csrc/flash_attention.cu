// K2 and K2': flash attention forward (online softmax, the [T, S] scores
// never leave the chip's registers).
//
// Replaces vats_tpu/ops/flash_attention.py:_fwd_kernel (K2, driven by
// _flash_forward and entered through flash_attention) and _fwd_kernel_lse
// (K2', the training forward under _flash_fwd_rule): one body, whose LSE
// template flag also stores each row's logsumexp, fp32 [B, Hq, T], with the
// sentinel 1e30 for a row that attends no key (the JAX kernel's rule, so the
// backward's exp(s - lse) is 0 on such a row).
//
// Semantics (identical to the JAX kernel):
//   * q [B, T, Hq, D], k/v [B, S, G, D] (the public layouts; head dim
//     zero-padded by the wrapper to D in {32, 64, 128}, which is exact);
//     query head h reads KV group h / (Hq / G), K/V are never repeated.
//   * key j is attended by query i (absolute position i + q_pos_offset) iff
//     kv_valid[b, j], and causal ? j <= pos : (right_window < 0 || j - pos
//     <= right_window), and (left_window < 0 || pos - j <= left_window), and,
//     with segment ids, q_seg[b, i] == kv_seg[b, j].
//   * softmax statistics in fp32; a row with no attended key outputs 0.
//   * whole key tiles outside the block's causal / window range are skipped.
//
// Bound: operations at long sequences (4*T*S*D/2 FLOPs per causal head),
// bytes at short ones.  This first version runs its products on the CUDA
// cores in fp32 (no tensor cores yet): one thread owns one query row, keeps
// q and the output accumulator in registers, and streams K/V tiles through
// shared memory, where every thread of the block reads the same key (a
// broadcast, no bank conflicts).  The JAX kernel's sequential KV grid axis
// becomes the loop over key tiles inside the block.  Scores are handled in
// chunks of 16 keys so the running max is rescaled once per chunk.  Masked
// keys are selected away (their score is never computed), never multiplied
// by zero.

#include "common.cuh"

namespace {

constexpr int BQ = 128;  // query rows per block, one per thread
constexpr int CH = 16;   // keys per online-softmax update

template <typename T, int D, bool LSE>
__global__ void __launch_bounds__(BQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kv_valid,
                 const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                 T* __restrict__ out, float* __restrict__ lse, int Tq, int S,
                 int Hq, int G, float scale,
                 int causal, int left_window, int right_window,
                 int q_pos_offset, int use_segids) {
  constexpr int BK = D <= 64 ? 64 : 32;  // keys per shared-memory tile
  const int qblk = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (Hq / G);
  const int tid = threadIdx.x;
  const int qi = qblk * BQ + tid;
  const bool row_ok = qi < Tq;
  const int qpos = qi + q_pos_offset;

  __shared__ __align__(16) float k_s[BK][D];
  __shared__ __align__(16) float v_s[BK][D];
  __shared__ int valid_s[BK];
  __shared__ int seg_s[BK];

  float qr[D];
  float o[D];
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = 0.f;
  if (row_ok) {
    const T* qp = q + ((size_t)(b * Tq + qi) * Hq + h) * D;
#pragma unroll
    for (int d = 0; d < D; d += 8) vats::load8(qp + d, qr + d);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = 0.f;
  }
  const int qseg = (use_segids && row_ok) ? q_seg[(size_t)b * Tq + qi] : 0;
  float m = -INFINITY;
  float l = 0.f;

  // key range any row of this block can attend
  const int q_first = qblk * BQ + q_pos_offset;
  const int q_last = min(qblk * BQ + BQ, Tq) - 1 + q_pos_offset;
  int k_hi = S;
  if (causal) k_hi = min(S, q_last + 1);
  else if (right_window >= 0) k_hi = min(S, q_last + right_window + 1);
  int k_lo = 0;
  if (left_window >= 0) k_lo = max(0, q_first - left_window);
  k_lo = (k_lo / BK) * BK;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < BK * D / 8; i += BQ) {
      const int j = (i * 8) / D;
      const int d = (i * 8) % D;
      const int key = k0 + j;
      if (key < S) {
        const size_t off = ((size_t)(b * S + key) * G + g) * D + d;
        vats::load8(k + off, &k_s[j][d]);
        vats::load8(v + off, &v_s[j][d]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          k_s[j][d + e] = 0.f;
          v_s[j][d + e] = 0.f;
        }
      }
    }
    for (int j = tid; j < BK; j += BQ) {
      const int key = k0 + j;
      valid_s[j] = key < S ? kv_valid[(size_t)b * S + key] : 0;
      seg_s[j] = (use_segids && key < S) ? kv_seg[(size_t)b * S + key] : 0;
    }
    __syncthreads();
    if (!row_ok) continue;

    for (int c = 0; c < BK; c += CH) {
      float s[CH];
      bool ok[CH];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const int j = c + jj;
        const int key = k0 + j;
        bool a = valid_s[j] != 0;
        if (causal) a = a && key <= qpos;
        else if (right_window >= 0) a = a && (key - qpos) <= right_window;
        if (left_window >= 0) a = a && (qpos - key) <= left_window;
        if (use_segids) a = a && seg_s[j] == qseg;
        ok[jj] = a;
        float sv = 0.f;
        if (a) {
          const float4* kr = reinterpret_cast<const float4*>(&k_s[j][0]);
#pragma unroll
          for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 kk = kr[d4];
            sv += qr[4 * d4] * kk.x + qr[4 * d4 + 1] * kk.y +
                  qr[4 * d4 + 2] * kk.z + qr[4 * d4 + 3] * kk.w;
          }
          sv *= scale;
          cmax = fmaxf(cmax, sv);
        }
        s[jj] = sv;
      }
      if (cmax == -INFINITY) continue;  // no attended key in this chunk
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);  // 0 while m is still -inf
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) o[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        if (ok[jj]) {
          const float p = expf(s[jj] - m_new);
          l += p;
          const float4* vr = reinterpret_cast<const float4*>(&v_s[c + jj][0]);
#pragma unroll
          for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 vv = vr[d4];
            o[4 * d4] += p * vv.x;
            o[4 * d4 + 1] += p * vv.y;
            o[4 * d4 + 2] += p * vv.z;
            o[4 * d4 + 3] += p * vv.w;
          }
        }
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float inv = (l == 0.f) ? 1.f : 1.f / l;
    T* op = out + ((size_t)(b * Tq + qi) * Hq + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = vats::from_f<T>(o[d] * inv);
    if constexpr (LSE) {
      lse[((size_t)b * Hq + h) * Tq + qi] = (l == 0.f) ? 1e30f : m + logf(l);
    }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const void* kv_valid,
             const void* q_seg, const void* kv_seg, void* out, void* lse, int B,
             int Tq, int S, int Hq, int G, float scale, int causal,
             int left_window, int right_window, int q_pos_offset,
             int use_segids, void* stream) {
  dim3 grid((Tq + BQ - 1) / BQ, Hq, B);
  if (lse != nullptr) {
    flash_fwd_kernel<T, D, true><<<grid, BQ, 0, (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int*)kv_valid,
        (const int*)q_seg, (const int*)kv_seg, (T*)out, (float*)lse, Tq, S, Hq,
        G, scale, causal, left_window, right_window, q_pos_offset, use_segids);
  } else {
    flash_fwd_kernel<T, D, false><<<grid, BQ, 0, (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int*)kv_valid,
        (const int*)q_seg, (const int*)kv_seg, (T*)out, nullptr, Tq, S, Hq, G,
        scale, causal, left_window, right_window, q_pos_offset, use_segids);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kv_valid,
           const void* q_seg, const void* kv_seg, void* out, void* lse, int B,
           int Tq, int S, int Hq, int G, int D, float scale, int causal,
           int left_window, int right_window, int q_pos_offset, int use_segids,
           void* stream) {
  if (Hq % G != 0) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, k, v, kv_valid, q_seg, kv_seg, out, lse, B, Tq, S,
                             Hq, G, scale, causal, left_window, right_window,
                             q_pos_offset, use_segids, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, kv_valid, q_seg, kv_seg, out, lse, B, Tq, S,
                             Hq, G, scale, causal, left_window, right_window,
                             q_pos_offset, use_segids, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, kv_valid, q_seg, kv_seg, out, lse, B, Tq, S,
                              Hq, G, scale, causal, left_window, right_window,
                              q_pos_offset, use_segids, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int vats_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                   const void* kv_valid, const void* q_seg,
                                   const void* kv_seg, void* out, void* lse,
                                   int B, int Tq, int S, int Hq, int G, int D,
                                   float scale,
                                   int causal, int left_window,
                                   int right_window, int q_pos_offset,
                                   int use_segids, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, kv_valid, q_seg, kv_seg, out, lse, B, Tq, S,
                               Hq, G, D, scale, causal, left_window,
                               right_window, q_pos_offset, use_segids, stream);
}

extern "C" int vats_flash_fwd_f32(const void* q, const void* k, const void* v,
                                  const void* kv_valid, const void* q_seg,
                                  const void* kv_seg, void* out, void* lse,
                                  int B, int Tq, int S, int Hq, int G, int D,
                                  float scale,
                                  int causal, int left_window, int right_window,
                                  int q_pos_offset, int use_segids,
                                  void* stream) {
  return launch<float>(q, k, v, kv_valid, q_seg, kv_seg, out, lse, B, Tq, S, Hq, G,
                       D, scale, causal, left_window, right_window,
                       q_pos_offset, use_segids, stream);
}
