// K5a and K5b: flash attention backward.
//
// Replaces vats_tpu/ops/flash_attention.py:_bwd_dkv_kernel (K5a) and
// _bwd_dq_kernel (K5b), run by _flash_bwd_kernels under the custom VJP
// _flash_bwd_rule.  Both rebuild the softmax tile by tile from the saved row
// logsumexp (p = exp(s - lse), s = scale * q.k) and take di = sum(do * o)
// from the caller, so a caller that merged lse and di over more keys (ring
// attention) gets its exact slice of the global gradient:
//   dv_j += sum_i p_ij do_i                      (K5a)
//   ds_ij = p_ij (do_i . v_j - di_i) scale
//   dk_j += sum_i ds_ij q_i                      (K5a)
//   dq_i += sum_j ds_ij k_j                      (K5b)
// Masking is the forward's (causal overrides right_window, left/right
// windows, a [B, S] key validity mask, segment ids, q_pos_offset); a masked
// pair has p = 0, and a row that attends nothing has lse = 1e30, so its p is
// 0 as well.  Whole tiles outside the causal / window range are skipped.
// Layouts are the public ones: q/do [B, T, Hq, D], k/v [B, S, G, D] (bf16 or
// fp32), lse/di [B, Hq, T] fp32; dq [B, T, Hq, D], dk/dv [B, S, G, D] fp32,
// dk/dv summed over the KV group's Hq / G query heads.
//
// Bound: operations (14 * T * S * D / 2 FLOPs per causal head pair with the
// recomputed scores in both kernels).  This first version runs on the CUDA
// cores in fp32 (no tensor cores; p and ds stay fp32 where the JAX kernel
// rounds them to the input dtype before its products).  Two threads own one
// row (a query row in K5b, a key row in K5a), each holding alternate float4
// chunks of that row's head dim in registers; the other side streams through
// shared memory in tiles and is read as a broadcast.  A dot product is each
// thread's half plus one shuffle with its partner.  The JAX kernel's
// sequential grid axis (KV tiles for dQ; query heads x query tiles for dK/dV)
// is the loop inside the block, so every output is written once, with no
// atomics, and the result does not depend on scheduling.

#include "common.cuh"

namespace {

constexpr int ROWS = 64;            // rows a block owns
constexpr int THREADS = 2 * ROWS;   // two threads per row

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void axpy4(float4& acc, float s, const float4& x) {
  acc.x += s * x.x;
  acc.y += s * x.y;
  acc.z += s * x.z;
  acc.w += s * x.w;
}

// Is key `key` (absolute position) attended by a query at absolute position
// `qpos`?  Validity and segments are checked by the caller.
__device__ __forceinline__ bool in_range(int qpos, int key, int causal,
                                         int left_window, int right_window) {
  bool a = true;
  if (causal) a = key <= qpos;
  else if (right_window >= 0) a = (key - qpos) <= right_window;
  if (left_window >= 0) a = a && (qpos - key) <= left_window;
  return a;
}

// Stage rows [r0, r0 + TILE) of one head of a [B, N, H, D] tensor into
// shared memory as fp32 (zeros past N).
template <typename T, int D, int TILE>
__device__ __forceinline__ void stage_rows(float (*dst)[D], const T* src, int b,
                                           int r0, int N, int H, int h) {
  for (int i = threadIdx.x; i < TILE * D / 8; i += THREADS) {
    const int j = (i * 8) / D;
    const int d = (i * 8) % D;
    const int row = r0 + j;
    if (row < N) {
      vats::load8(src + ((size_t)(b * N + row) * H + h) * D + d, &dst[j][d]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[j][d + e] = 0.f;
    }
  }
}

// K5b: one block per (query tile, query head, batch row); loops over the
// key tiles the tile can attend.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    const int* __restrict__ kv_valid,
                    const int* __restrict__ q_seg,
                    const int* __restrict__ kv_seg, float* __restrict__ dq,
                    int Tq, int S, int Hq, int G, float scale, int causal,
                    int left_window, int right_window, int q_pos_offset,
                    int use_segids) {
  constexpr int NC = D / 8;                 // float4 chunks per thread
  constexpr int TILE = D <= 64 ? 64 : 32;   // keys per shared-memory tile
  const int qblk = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (Hq / G);
  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int qi = qblk * ROWS + r;
  const bool row_ok = qi < Tq;
  const int qpos = qi + q_pos_offset;

  __shared__ __align__(16) float k_s[TILE][D];
  __shared__ __align__(16) float v_s[TILE][D];
  __shared__ int valid_s[TILE];
  __shared__ int seg_s[TILE];

  float4 qr[NC], dor[NC], acc[NC];
  const size_t row_off = ((size_t)(b * Tq + qi) * Hq + h) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = (2 * c + half) * 4;
    qr[c] = row_ok ? load4(q + row_off + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    dor[c] = row_ok ? load4(dout + row_off + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const size_t stat = ((size_t)b * Hq + h) * Tq + qi;
  const float row_lse = row_ok ? lse[stat] : 0.f;
  const float row_di = row_ok ? di[stat] : 0.f;
  const int qseg = (use_segids && row_ok) ? q_seg[(size_t)b * Tq + qi] : 0;

  // key range any row of this block can attend (as in the forward)
  const int q_first = qblk * ROWS + q_pos_offset;
  const int q_last = min(qblk * ROWS + ROWS, Tq) - 1 + q_pos_offset;
  int k_hi = S;
  if (causal) k_hi = min(S, q_last + 1);
  else if (right_window >= 0) k_hi = min(S, q_last + right_window + 1);
  int k_lo = 0;
  if (left_window >= 0) k_lo = max(0, q_first - left_window);
  k_lo = (k_lo / TILE) * TILE;

  for (int k0 = k_lo; k0 < k_hi; k0 += TILE) {
    __syncthreads();  // the previous tile is no longer read
    stage_rows<T, D, TILE>(k_s, k, b, k0, S, G, g);
    stage_rows<T, D, TILE>(v_s, v, b, k0, S, G, g);
    for (int j = threadIdx.x; j < TILE; j += THREADS) {
      const int key = k0 + j;
      valid_s[j] = key < S ? kv_valid[(size_t)b * S + key] : 0;
      seg_s[j] = (use_segids && key < S) ? kv_seg[(size_t)b * S + key] : 0;
    }
    __syncthreads();

    for (int j = 0; j < TILE; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(&k_s[j][0]);
      const float4* vr = reinterpret_cast<const float4*>(&v_s[j][0]);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        s += dot4(qr[c], kr[2 * c + half]);
        dp += dot4(dor[c], vr[2 * c + half]);
      }
      // every thread of the warp reaches these shuffles (no early exits)
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      bool a = row_ok && valid_s[j] != 0 &&
               in_range(qpos, k0 + j, causal, left_window, right_window);
      if (use_segids) a = a && seg_s[j] == qseg;
      const float p = a ? expf(s * scale - row_lse) : 0.f;
      const float ds = p * (dp - row_di) * scale;
#pragma unroll
      for (int c = 0; c < NC; ++c) axpy4(acc[c], ds, kr[2 * c + half]);
    }
  }

  if (row_ok) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      *reinterpret_cast<float4*>(dq + row_off + (2 * c + half) * 4) = acc[c];
    }
  }
}

// K5a: one block per (key tile, KV group, batch row); loops over the group's
// query heads and, for each, the query tiles that can attend the key tile.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di,
                     const int* __restrict__ kv_valid,
                     const int* __restrict__ q_seg,
                     const int* __restrict__ kv_seg, float* __restrict__ dk,
                     float* __restrict__ dv, int Tq, int S, int Hq, int G,
                     float scale, int causal, int left_window, int right_window,
                     int q_pos_offset, int use_segids) {
  constexpr int NC = D / 8;
  constexpr int TILE = D <= 64 ? 64 : 32;  // query rows per shared-memory tile
  const int kblk = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int ratio = Hq / G;
  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int kj = kblk * ROWS + r;
  const bool col_ok = kj < S;

  __shared__ __align__(16) float q_s[TILE][D];
  __shared__ __align__(16) float do_s[TILE][D];
  __shared__ float lse_s[TILE];
  __shared__ float di_s[TILE];
  __shared__ int seg_s[TILE];

  float4 kr[NC], vr[NC], dka[NC], dva[NC];
  const size_t row_off = ((size_t)(b * S + kj) * G + g) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = (2 * c + half) * 4;
    kr[c] = col_ok ? load4(k + row_off + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    vr[c] = col_ok ? load4(v + row_off + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    dka[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    dva[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const bool key_ok = col_ok && kv_valid[(size_t)b * S + kj] != 0;
  const int kseg = (use_segids && col_ok) ? kv_seg[(size_t)b * S + kj] : 0;

  // query rows (indices, not positions) that can attend any key of the tile
  const int k_first = kblk * ROWS;
  const int k_last = min(kblk * ROWS + ROWS, S) - 1;
  int q_lo = 0;
  if (causal) q_lo = max(0, k_first - q_pos_offset);
  else if (right_window >= 0) q_lo = max(0, k_first - right_window - q_pos_offset);
  int q_hi = Tq;
  if (left_window >= 0) q_hi = min(Tq, k_last + left_window - q_pos_offset + 1);
  q_lo = (q_lo / TILE) * TILE;

  for (int hh = 0; hh < ratio; ++hh) {
    const int h = g * ratio + hh;
    for (int q0 = q_lo; q0 < q_hi; q0 += TILE) {
      __syncthreads();  // the previous tile is no longer read
      stage_rows<T, D, TILE>(q_s, q, b, q0, Tq, Hq, h);
      stage_rows<T, D, TILE>(do_s, dout, b, q0, Tq, Hq, h);
      for (int i = threadIdx.x; i < TILE; i += THREADS) {
        const int row = q0 + i;
        const bool ok = row < Tq;
        const size_t stat = ((size_t)b * Hq + h) * Tq + row;
        lse_s[i] = ok ? lse[stat] : 0.f;
        di_s[i] = ok ? di[stat] : 0.f;
        seg_s[i] = (use_segids && ok) ? q_seg[(size_t)b * Tq + row] : 0;
      }
      __syncthreads();

      for (int i = 0; i < TILE; ++i) {
        const float4* qrow = reinterpret_cast<const float4*>(&q_s[i][0]);
        const float4* drow = reinterpret_cast<const float4*>(&do_s[i][0]);
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          s += dot4(kr[c], qrow[2 * c + half]);
          dp += dot4(vr[c], drow[2 * c + half]);
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        dp += __shfl_xor_sync(0xffffffffu, dp, 1);
        const int row = q0 + i;
        bool a = key_ok && row < Tq &&
                 in_range(row + q_pos_offset, kj, causal, left_window,
                          right_window);
        if (use_segids) a = a && seg_s[i] == kseg;
        const float p = a ? expf(s * scale - lse_s[i]) : 0.f;
        const float ds = p * (dp - di_s[i]) * scale;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          axpy4(dva[c], p, drow[2 * c + half]);
          axpy4(dka[c], ds, qrow[2 * c + half]);
        }
      }
    }
  }

  if (col_ok) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = (2 * c + half) * 4;
      *reinterpret_cast<float4*>(dk + row_off + d) = dka[c];
      *reinterpret_cast<float4*>(dv + row_off + d) = dva[c];
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *di, *kv_valid, *q_seg, *kv_seg;
  void *dq, *dk, *dv;
  int B, Tq, S, Hq, G, D;
  float scale;
  int causal, left_window, right_window, q_pos_offset, use_segids;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dq_d(const Args& a) {
  dim3 grid((a.Tq + ROWS - 1) / ROWS, a.Hq, a.B);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, 0, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.di, (const int*)a.kv_valid,
      (const int*)a.q_seg, (const int*)a.kv_seg, (float*)a.dq, a.Tq, a.S,
      a.Hq, a.G, a.scale, a.causal, a.left_window, a.right_window,
      a.q_pos_offset, a.use_segids);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv_d(const Args& a) {
  dim3 grid((a.S + ROWS - 1) / ROWS, a.G, a.B);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, 0, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.di, (const int*)a.kv_valid,
      (const int*)a.q_seg, (const int*)a.kv_seg, (float*)a.dk, (float*)a.dv,
      a.Tq, a.S, a.Hq, a.G, a.scale, a.causal, a.left_window, a.right_window,
      a.q_pos_offset, a.use_segids);
  return (int)cudaGetLastError();
}

template <typename T, bool DQ>
int launch(const Args& a) {
  if (a.G <= 0 || a.Hq % a.G != 0) return (int)cudaErrorInvalidValue;
  switch (a.D) {
    case 32: return DQ ? launch_dq_d<T, 32>(a) : launch_dkv_d<T, 32>(a);
    case 64: return DQ ? launch_dq_d<T, 64>(a) : launch_dkv_d<T, 64>(a);
    case 128: return DQ ? launch_dq_d<T, 128>(a) : launch_dkv_d<T, 128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* di, const void* kv_valid,
               const void* q_seg, const void* kv_seg, void* dq, void* dk,
               void* dv, int B, int Tq, int S, int Hq, int G, int D,
               float scale, int causal, int left_window, int right_window,
               int q_pos_offset, int use_segids, void* stream) {
  return Args{q, k, v, dout, lse, di, kv_valid, q_seg, kv_seg, dq, dk, dv,
              B, Tq, S, Hq, G, D, scale, causal, left_window, right_window,
              q_pos_offset, use_segids, (cudaStream_t)stream};
}

}  // namespace

#define VATS_BWD_ARGS                                                       \
  const void *q, const void *k, const void *v, const void *dout,            \
      const void *lse, const void *di, const void *kv_valid,                \
      const void *q_seg, const void *kv_seg
#define VATS_BWD_SCALARS                                                    \
  int B, int Tq, int S, int Hq, int G, int D, float scale, int causal,      \
      int left_window, int right_window, int q_pos_offset, int use_segids,  \
      void *stream

extern "C" int vats_flash_bwd_dq_bf16(VATS_BWD_ARGS, void* dq, VATS_BWD_SCALARS) {
  return launch<__nv_bfloat16, true>(make_args(
      q, k, v, dout, lse, di, kv_valid, q_seg, kv_seg, dq, nullptr, nullptr, B,
      Tq, S, Hq, G, D, scale, causal, left_window, right_window, q_pos_offset,
      use_segids, stream));
}

extern "C" int vats_flash_bwd_dq_f32(VATS_BWD_ARGS, void* dq, VATS_BWD_SCALARS) {
  return launch<float, true>(make_args(
      q, k, v, dout, lse, di, kv_valid, q_seg, kv_seg, dq, nullptr, nullptr, B,
      Tq, S, Hq, G, D, scale, causal, left_window, right_window, q_pos_offset,
      use_segids, stream));
}

extern "C" int vats_flash_bwd_dkv_bf16(VATS_BWD_ARGS, void* dk, void* dv,
                                       VATS_BWD_SCALARS) {
  return launch<__nv_bfloat16, false>(make_args(
      q, k, v, dout, lse, di, kv_valid, q_seg, kv_seg, nullptr, dk, dv, B, Tq,
      S, Hq, G, D, scale, causal, left_window, right_window, q_pos_offset,
      use_segids, stream));
}

extern "C" int vats_flash_bwd_dkv_f32(VATS_BWD_ARGS, void* dk, void* dv,
                                      VATS_BWD_SCALARS) {
  return launch<float, false>(make_args(
      q, k, v, dout, lse, di, kv_valid, q_seg, kv_seg, nullptr, dk, dv, B, Tq,
      S, Hq, G, D, scale, causal, left_window, right_window, q_pos_offset,
      use_segids, stream));
}
