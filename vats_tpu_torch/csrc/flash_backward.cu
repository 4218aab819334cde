// K5a and K5b: flash attention backward.
//
// Replaces vats_tpu/ops/flash_attention.py:_bwd_dkv_kernel (:230, K5a) and
// _bwd_dq_kernel (:344, K5b), run by _flash_bwd_kernels (:588) under the
// custom VJP _flash_bwd_rule.  Both rebuild the softmax tile by tile from the
// saved row logsumexp (p = exp(s - lse), s = scale * q.k) and take
// di = sum(do * o) from the caller, so a caller that merged lse and di over
// more keys (ring attention) gets its exact slice of the global gradient:
//   dv_j += sum_i p_ij do_i                      (K5a)
//   ds_ij = p_ij (do_i . v_j - di_i) scale
//   dk_j += sum_i ds_ij q_i                      (K5a)
//   dq_i += sum_j ds_ij k_j                      (K5b)
// Masking is the forward's (causal overrides right_window, left/right
// windows, a [B, S] key validity mask, segment ids, q_pos_offset); a masked
// pair has p = 0 exactly, and a row that attends nothing has lse = 1e30, so
// its p is 0 as well.  Whole tiles outside the causal / window range are
// skipped.  Layouts are the public ones: q/do [B, T, Hq, D], k/v [B, S, G, D]
// (bf16 or fp32), lse/di [B, Hq, T] fp32; dq [B, T, Hq, D], dk/dv
// [B, S, G, D] fp32, dk/dv summed over the KV group's Hq / G query heads.
// The JAX kernel's sequential grid axis (KV tiles for dQ; query heads x query
// tiles for dK/dV) is the loop inside the block, so every output row is
// written once, with no atomics, and the result does not depend on
// scheduling.
//
// Two bodies, chosen statically by dtype (each entry point runs its own body
// or returns the launch error):
//
// vats_flash_bwd_{dq,dkv}_bf16 -- the Hopper body (flash_bwd_{dq,dkv}_wgmma_kernel).
//   Bound at the training shapes (B=16, T=512, Hq=24, G=8, D=64 for hd 60;
//   chip_smoke.py computes it from the inputs): bytes, because the outputs
//   are fp32 (K5a: 96 MB in and out against 5.0 GFLOP, 0.029 vs 0.005 ms;
//   K5b: 112 MB against 3.8 GFLOP); operations at long sequences, where the
//   work grows as T^2 and the bytes as T.  The design serves the operations:
//   * Every product is a wgmma on the tensor cores (bf16 in, fp32 sums); p
//     and ds are rounded to bf16 before their products, as the JAX kernel
//     does (p.astype(do.dtype), ds.astype(q.dtype)).
//   * 384 threads: warp 0 of warpgroup 0 is the producer (setmaxnreg 40),
//     warpgroups 1 and 2 consume 64 rows each (wgmma's M; setmaxnreg 232).
//     The producer loads with TMA through 3-D tensor maps [B, T, H*D] (rows
//     past T or S read as zeros, never the next batch row) into shared
//     memory with the 128-byte swizzle (64-byte at D = 32), and stages the
//     masks' per-tile data beside the tiles; full/empty mbarriers per stage.
//   * K5b (dQ): one CTA per (128 query rows, KV group, batch row), walking
//     the group's query heads: each head's Q and dO are loaded once, into one
//     of two buffers, so the next head's load overlaps this head's work; K
//     and V stream through a 2-stage ring (128 keys, 64 at D = 128 for
//     registers).  Each consumer keeps its rows' lse and di in registers for
//     the head, runs S = Q K^T and dP = dO V^T (SS wgmma, all K-major),
//     forms p = exp2(s scale log2e - lse log2e) and ds = p (dP - di) scale
//     on the accumulator fragments, packs ds to bf16 in place (the
//     accumulator's layout is the A operand's) and runs dQ += ds K (RS wgmma,
//     K read MN-major as the forward reads V).
//   * K5a (dK/dV): one CTA per (128 keys, KV group, batch row); each
//     consumer owns 64 keys, whose K and V rows TMA loads once.  The producer
//     streams (query head of the group, query tile) pairs through a 3-stage
//     ring: Q and dO tiles of 64 rows (32 at D = 128) with their lse, di and
//     segment ids, so each Q/dO tile is loaded once for 128 keys.  The
//     consumer computes the transposed scores, keys as M: S^T = K Q^T and
//     dP^T = V dO^T, then p^T and ds^T with lse/di indexed by the column
//     (query) each fragment element holds, then dV += p^T dO and dK += ds^T Q
//     (RS wgmma, dO and Q read MN-major).  dK and dV stay in registers over
//     every head and query tile of the group.
//   * Masks only on boundary tiles: each consumer classifies a tile as
//     interior (no causal or window edge, every key valid, no segments) or
//     boundary, and a boundary tile masks each fragment element from the
//     (query, key) it holds; a tile wholly outside a consumer's range is
//     skipped by that consumer.
//   * Causal grids start the CTAs with the most tiles first: the tile index
//     is the slowest grid axis, reversed in K5b (the last query tiles see the
//     most keys); K5a keeps index order, since its first key tiles are
//     attended by the most queries.
//
// vats_flash_bwd_{dq,dkv}_f32 -- the CUDA-core body (flash_bwd_{dq,dkv}_f32_kernel),
//   kept for fp32 inputs, which only the tests use: TF32 wgmma would miss the
//   1e-4 tolerances they hold.  Two threads own one row (a query row in K5b,
//   a key row in K5a), each holding alternate float4 chunks of that row's
//   head dim in registers; the other side streams through shared memory in
//   tiles and is read as a broadcast.  A dot product is each thread's half
//   plus one shuffle with its partner.

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// --- fp32: CUDA-core body -----------------------------------------------------

constexpr int ROWS = 64;            // rows a block owns
constexpr int THREADS = 2 * ROWS;   // two threads per row

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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
// shared memory (zeros past N).
template <int D, int TILE>
__device__ __forceinline__ void stage_rows(float (*dst)[D], const float* src, int b,
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
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
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
    stage_rows<D, TILE>(k_s, k, b, k0, S, G, g);
    stage_rows<D, TILE>(v_s, v, b, k0, S, G, g);
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
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
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
      stage_rows<D, TILE>(q_s, q, b, q0, Tq, Hq, h);
      stage_rows<D, TILE>(do_s, dout, b, q0, Tq, Hq, h);
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

// --- bf16: Hopper body (TMA ring, wgmma, warp specialisation) --------------

namespace sm90 = vats::sm90;

constexpr int WG_THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
using Cols = sm90::SwizzledCols<D>;

// K5b shared memory: Q and dO (BM rows) for two query heads, K and V rings
// (BN keys), the key tiles' validity, segment ids and "every key valid"
// flag, the barriers.
template <int D>
struct DqTile : Cols<D> {
  static constexpr int BM = 128;                // query rows: two warpgroups of 64
  static constexpr int BN = D == 128 ? 64 : 128;  // keys per tile
  static constexpr int STAGES = 2;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;
  // offsets from a 1024-byte aligned base
  static constexpr int OFF_DO = 2 * Q_BYTES;
  static constexpr int OFF_K = 4 * Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_VALID = OFF_V + STAGES * KV_BYTES;
  static constexpr int OFF_SEG = OFF_VALID + STAGES * BN * 4;
  static constexpr int OFF_FLAG = OFF_SEG + STAGES * BN * 4;
  static constexpr int OFF_BAR = OFF_FLAG + 16 * STAGES;
  static constexpr int SMEM = OFF_BAR + 8 * (4 + 2 * STAGES) + 1024;  // + alignment slack
};

// K5a shared memory: K and V (BK keys, loaded once), Q and dO rings (BQ
// query rows) with their lse * log2(e), di and segment ids, the two
// consumers' "every key valid" flags, the barriers.
template <int D>
struct DkvTile : Cols<D> {
  static constexpr int BK = 128;                // keys: two warpgroups of 64
  static constexpr int BQ = D == 128 ? 32 : 64;   // query rows per tile
  static constexpr int STAGES = 3;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int QT_BYTES = BQ * D * 2;
  static constexpr int OFF_V = KV_BYTES;
  static constexpr int OFF_Q = 2 * KV_BYTES;
  static constexpr int OFF_DO = OFF_Q + STAGES * QT_BYTES;
  static constexpr int OFF_LSE = OFF_DO + STAGES * QT_BYTES;
  static constexpr int OFF_DI = OFF_LSE + STAGES * BQ * 4;
  static constexpr int OFF_SEG = OFF_DI + STAGES * BQ * 4;
  static constexpr int OFF_FLAG = OFF_SEG + STAGES * BQ * 4;
  static constexpr int OFF_BAR = OFF_FLAG + 16;
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// Pack a 64 x N fp32 accumulator into N / 16 register A operands (bf16).
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = sm90::pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
  }
}

// d[64 x N] = a[64 x D] * b[N x D]^T over D in steps of 16 columns: a is a
// warpgroup's 64 rows of a tile of ``a_rows`` rows, b a tile of N rows, both
// stored as column chunks of one swizzle span.
template <int D, int N>
__device__ __forceinline__ void gemm_nt(float (&d)[N / 2], uint32_t a, int a_rows, uint32_t b) {
  using C = Cols<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk * 16 % C::CW) * 2;
    const uint32_t chunk = kk * 16 / C::CW;
    sm90::wgmma_ss<N>(d,
                      sm90::make_desc(a + chunk * a_rows * C::SW + col, 16, 8 * C::SW, C::SW),
                      sm90::make_desc(b + chunk * N * C::SW + col, 16, 8 * C::SW, C::SW),
                      kk > 0);
  }
}

// d[64 x D] += a[64 x N] * b[N x D]: a from registers, b a tile of N rows
// read MN-major (its rows are the K dimension).
template <int D, int N>
__device__ __forceinline__ void gemm_rs(float (&d)[D / 2], const uint32_t (&a)[N / 16][4],
                                        uint32_t b) {
  using C = Cols<D>;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    sm90::wgmma_rs<D>(d, a[kk],
                      sm90::make_desc(b + kk * 16 * C::SW, N * C::SW, 8 * C::SW, C::SW));
}

// Does any query in positions [q_first, q_last] attend any key in
// [k_first, k_last]?  (validity and segments apart)
__device__ __forceinline__ bool any_pair(int q_first, int q_last, int k_first, int k_last,
                                         int causal, int left_window, int right_window) {
  bool any = q_first <= q_last && k_first <= k_last;
  if (causal) any = any && k_first <= q_last;
  else if (right_window >= 0) any = any && k_first - q_last <= right_window;
  if (left_window >= 0) any = any && q_first - k_last <= left_window;
  return any;
}

// Does every query in [q_first, q_last] attend every key in [k_first, k_last]?
__device__ __forceinline__ bool all_pairs(int q_first, int q_last, int k_first, int k_last,
                                          int causal, int left_window, int right_window) {
  bool all = true;
  if (causal) all = k_last <= q_first;
  else if (right_window >= 0) all = k_last - q_first <= right_window;
  if (left_window >= 0) all = all && q_last - k_first <= left_window;
  return all;
}

// K5b: dQ for 128 query rows of every query head of one KV group.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ lse, const float* __restrict__ di,
                          const int* __restrict__ kv_valid, const int* __restrict__ q_seg,
                          const int* __restrict__ kv_seg, float* __restrict__ dq, int Tq,
                          int S, int Hq, int G, float scale, int causal, int left_window,
                          int right_window, int q_pos_offset, int use_segids) {
  using C = DqTile<D>;
  constexpr int BM = C::BM, BN = C::BN, STAGES = C::STAGES, SW = C::SW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw);
  int* valid_s = reinterpret_cast<int*>(sbase + C::OFF_VALID);
  int* seg_s = reinterpret_cast<int*>(sbase + C::OFF_SEG);
  int* flag_s = reinterpret_cast<int*>(sbase + C::OFF_FLAG);
  const uint32_t bar = base + C::OFF_BAR;
  // Q and dO of a head go to buffer (head & 1), so the next head's load
  // overlaps this head's work
  auto q_s = [&](int qb) { return base + qb * C::Q_BYTES; };
  auto do_s = [&](int qb) { return base + C::OFF_DO + qb * C::Q_BYTES; };
  auto q_full = [&](int qb) { return bar + 8 * qb; };
  auto q_empty = [&](int qb) { return bar + 8 * (2 + qb); };
  auto k_s = [&](int st) { return base + C::OFF_K + st * C::KV_BYTES; };
  auto v_s = [&](int st) { return base + C::OFF_V + st * C::KV_BYTES; };
  auto full = [&](int st) { return bar + 8 * (4 + st); };
  auto empty = [&](int st) { return bar + 8 * (4 + STAGES + st); };

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int qblk = gridDim.z - 1 - blockIdx.z;  // the rows that see the most keys first
  const int ratio = Hq / G;
  const int q0 = qblk * BM;

  // key tiles any row of this CTA can attend; the rest are never loaded
  const int q_first = q0 + q_pos_offset;
  const int q_last = min(q0 + BM, Tq) - 1 + q_pos_offset;
  int k_hi = S;
  if (causal) k_hi = min(S, q_last + 1);
  else if (right_window >= 0) k_hi = min(S, q_last + right_window + 1);
  int k_lo = 0;
  if (left_window >= 0) k_lo = max(0, q_first - left_window);
  k_lo = (k_lo / BN) * BN;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int qb = 0; qb < 2; ++qb) {
      sm90::mbar_init(q_full(qb), 1);
      sm90::mbar_init(q_empty(qb), 2 * 128);
    }
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(full(st), 2);        // the TMA's arrival + the masks' arrival
      sm90::mbar_init(empty(st), 2 * 128);  // every consumer thread
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one warp issues every load; the rest of its warpgroup idles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int it = 0;  // position in the K/V ring over every head
      for (int hh = 0; hh < ratio; ++hh) {
        const int h = g * ratio + hh;
        const int qb = hh & 1;
        sm90::mbar_wait(q_empty(qb), ((hh >> 1) & 1) ^ 1);
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(q_full(qb), 2 * C::Q_BYTES);
#pragma unroll
          for (int c = 0; c < C::NCH; ++c) {
            sm90::tma_load_3d(q_s(qb) + c * BM * SW, &tm_q, q_full(qb), h * D + c * C::CW, q0,
                              b);
            sm90::tma_load_3d(do_s(qb) + c * BM * SW, &tm_do, q_full(qb), h * D + c * C::CW,
                              q0, b);
          }
        }
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int st = it % STAGES;
          const uint32_t ph = (it / STAGES) & 1;
          const int k0 = k_lo + j * BN;
          sm90::mbar_wait(empty(st), ph ^ 1);
          if (lane == 0) {
            sm90::mbar_arrive_expect_tx(full(st), 2 * C::KV_BYTES);
#pragma unroll
            for (int c = 0; c < C::NCH; ++c) {
              sm90::tma_load_3d(k_s(st) + c * BN * SW, &tm_k, full(st), g * D + c * C::CW, k0,
                                b);
              sm90::tma_load_3d(v_s(st) + c * BN * SW, &tm_v, full(st), g * D + c * C::CW, k0,
                                b);
            }
          }
          int all = 1;
#pragma unroll
          for (int jj = lane; jj < BN; jj += 32) {
            const int key = k0 + jj;
            const int ok = key < S && kv_valid[(size_t)b * S + key] != 0;
            valid_s[st * BN + jj] = ok;
            if (use_segids) seg_s[st * BN + jj] = key < S ? kv_seg[(size_t)b * S + key] : 0;
            all &= ok;
          }
          all = __all_sync(0xffffffffu, all);
          if (lane == 0) flag_s[st] = all;
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(full(st));
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int r0 = q0 + cw * 64 + (t >> 5) * 16 + (lane >> 2);  // rows r0 and r0 + 8
    const int r1 = r0 + 8;
    const int pos0 = r0 + q_pos_offset;
    const int pos1 = r1 + q_pos_offset;
    const int qs0 = (use_segids && r0 < Tq) ? q_seg[(size_t)b * Tq + r0] : 0;
    const int qs1 = (use_segids && r1 < Tq) ? q_seg[(size_t)b * Tq + r1] : 0;
    const int wg_first = q0 + cw * 64 + q_pos_offset;
    const int wg_last = min(q0 + cw * 64 + 64, Tq) - 1 + q_pos_offset;
    const int cq = 2 * (lane & 3);  // this thread's first column in each group of 8
    const float sl2 = scale * LOG2E;

    int it = 0;
    for (int hh = 0; hh < ratio; ++hh) {
      const int h = g * ratio + hh;
      const int qb = hh & 1;
      const size_t stat = ((size_t)b * Hq + h) * Tq;
      // a row past T contributes nothing: exp2(s - inf) = 0
      const float lse0 = r0 < Tq ? lse[stat + r0] * LOG2E : INFINITY;
      const float lse1 = r1 < Tq ? lse[stat + r1] * LOG2E : INFINITY;
      const float di0 = r0 < Tq ? di[stat + r0] : 0.f;
      const float di1 = r1 < Tq ? di[stat + r1] : 0.f;
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      const uint32_t q_wg = q_s(qb) + cw * 64 * SW;
      const uint32_t do_wg = do_s(qb) + cw * 64 * SW;
      sm90::mbar_wait(q_full(qb), (hh >> 1) & 1);

      for (int j = 0; j < n_tiles; ++j, ++it) {
        const int st = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const int k0 = k_lo + j * BN;
        sm90::mbar_wait(full(st), ph);
        if (any_pair(wg_first, wg_last, k0, min(k0 + BN, S) - 1, causal, left_window,
                     right_window)) {
          // S = Q K^T and dP = dO V^T, two groups: p is formed while dP runs
          float s[BN / 2], dp[BN / 2];
          sm90::wgmma_fence();
          gemm_nt<D, BN>(s, q_wg, BM, k_s(st));
          sm90::wgmma_commit();
          gemm_nt<D, BN>(dp, do_wg, BM, v_s(st));
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();
          sm90::fence_regs(s);

          const bool interior = !use_segids && flag_s[st] != 0 &&
                                all_pairs(wg_first, wg_last, k0, k0 + BN - 1, causal,
                                          left_window, right_window);
          const int* vs = valid_s + st * BN;
          const int* ss = seg_s + st * BN;
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) {
            const bool second = (i & 2) != 0;
            float p = sm90::ex2(s[i] * sl2 - (second ? lse1 : lse0));
            if (!interior) {
              const int jj = 8 * (i >> 2) + cq + (i & 1);
              bool a = vs[jj] != 0 && in_range(second ? pos1 : pos0, k0 + jj, causal,
                                               left_window, right_window);
              if (use_segids) a = a && ss[jj] == (second ? qs1 : qs0);
              p = a ? p : 0.f;
            }
            s[i] = p;
          }
          sm90::wgmma_wait<0>();
          sm90::fence_regs(dp);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i)
            s[i] = s[i] * (dp[i] - ((i & 2) ? di1 : di0)) * scale;  // ds

          // dQ += ds K, ds rounded to bf16
          uint32_t da[BN / 16][4];
          pack_a<BN>(da, s);
          sm90::fence_regs(acc);
          sm90::fence_regs(da);
          sm90::wgmma_fence();
          gemm_rs<D, BN>(acc, da, k_s(st));
          sm90::wgmma_commit();
          sm90::wgmma_wait_all();
          sm90::fence_regs(acc);
        }
        sm90::mbar_arrive(empty(st));
      }
      sm90::mbar_arrive(q_empty(qb));  // this head's Q and dO are no longer read

      if (r0 < Tq) {
        float* op = dq + ((size_t)(b * Tq + r0) * Hq + h) * D + cq;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(op + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
      }
      if (r1 < Tq) {
        float* op = dq + ((size_t)(b * Tq + r1) * Hq + h) * D + cq;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(op + 8 * j) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// K5a: dK and dV for 128 keys of one KV group, over the group's query heads.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const float* __restrict__ lse, const float* __restrict__ di,
                           const int* __restrict__ kv_valid, const int* __restrict__ q_seg,
                           const int* __restrict__ kv_seg, float* __restrict__ dk,
                           float* __restrict__ dv, int Tq, int S, int Hq, int G, float scale,
                           int causal, int left_window, int right_window, int q_pos_offset,
                           int use_segids) {
  using C = DkvTile<D>;
  constexpr int BK = C::BK, BQ = C::BQ, STAGES = C::STAGES, SW = C::SW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw);
  float* lse_s = reinterpret_cast<float*>(sbase + C::OFF_LSE);
  float* di_s = reinterpret_cast<float*>(sbase + C::OFF_DI);
  int* seg_s = reinterpret_cast<int*>(sbase + C::OFF_SEG);
  int* flag_s = reinterpret_cast<int*>(sbase + C::OFF_FLAG);
  const uint32_t k_s = base;
  const uint32_t v_s = base + C::OFF_V;
  const uint32_t bar_kv = base + C::OFF_BAR;
  auto q_s = [&](int st) { return base + C::OFF_Q + st * C::QT_BYTES; };
  auto do_s = [&](int st) { return base + C::OFF_DO + st * C::QT_BYTES; };
  auto full = [&](int st) { return bar_kv + 8 * (1 + st); };
  auto empty = [&](int st) { return bar_kv + 8 * (1 + STAGES + st); };

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * BK;  // key tile 0, attended by the most queries, first
  const int ratio = Hq / G;

  // query rows (indices, not positions) that can attend any key of the tile
  const int k_last = min(k0 + BK, S) - 1;
  int q_lo = 0;
  if (causal) q_lo = max(0, k0 - q_pos_offset);
  else if (right_window >= 0) q_lo = max(0, k0 - right_window - q_pos_offset);
  int q_hi = Tq;
  if (left_window >= 0) q_hi = min(Tq, k_last + left_window - q_pos_offset + 1);
  q_lo = (q_lo / BQ) * BQ;
  const int n_qt = q_hi > q_lo ? (q_hi - q_lo + BQ - 1) / BQ : 0;
  const int n_items = ratio * n_qt;  // (query head, query tile) pairs

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_kv, 2);  // the TMA's arrival + the flags' arrival
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(full(st), 2);
      sm90::mbar_init(empty(st), 2 * 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(bar_kv, 2 * C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          sm90::tma_load_3d(k_s + c * BK * SW, &tm_k, bar_kv, g * D + c * C::CW, k0, b);
          sm90::tma_load_3d(v_s + c * BK * SW, &tm_v, bar_kv, g * D + c * C::CW, k0, b);
        }
      }
      // "every key valid" for each consumer's 64 keys
      int ok[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + 32 * i + lane;
        ok[i] = key < S && kv_valid[(size_t)b * S + key] != 0;
      }
      const int all0 = __all_sync(0xffffffffu, ok[0] && ok[1]);
      const int all1 = __all_sync(0xffffffffu, ok[2] && ok[3]);
      if (lane == 0) {
        flag_s[0] = all0;
        flag_s[1] = all1;
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(bar_kv);

      for (int it = 0; it < n_items; ++it) {
        const int st = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const int h = g * ratio + it / n_qt;
        const int q0 = q_lo + (it % n_qt) * BQ;
        sm90::mbar_wait(empty(st), ph ^ 1);
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(full(st), 2 * C::QT_BYTES);
#pragma unroll
          for (int c = 0; c < C::NCH; ++c) {
            sm90::tma_load_3d(q_s(st) + c * BQ * SW, &tm_q, full(st), h * D + c * C::CW, q0, b);
            sm90::tma_load_3d(do_s(st) + c * BQ * SW, &tm_do, full(st), h * D + c * C::CW, q0,
                              b);
          }
        }
        const size_t stat = ((size_t)b * Hq + h) * Tq;
#pragma unroll
        for (int j = lane; j < BQ; j += 32) {
          const int row = q0 + j;
          const bool in = row < Tq;
          // a row past T contributes nothing: exp2(s - inf) = 0
          lse_s[st * BQ + j] = in ? lse[stat + row] * LOG2E : INFINITY;
          di_s[st * BQ + j] = in ? di[stat + row] : 0.f;
          if (use_segids) seg_s[st * BQ + j] = in ? q_seg[(size_t)b * Tq + row] : 0;
        }
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(full(st));
      }
    }
  } else {
    // ---- consumers: 64 keys per warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int kr0 = k0 + cw * 64 + (t >> 5) * 16 + (lane >> 2);  // keys kr0 and kr0 + 8
    const int kr1 = kr0 + 8;
    const bool kv0 = kr0 < S && kv_valid[(size_t)b * S + kr0] != 0;
    const bool kv1 = kr1 < S && kv_valid[(size_t)b * S + kr1] != 0;
    const int ks0 = (use_segids && kr0 < S) ? kv_seg[(size_t)b * S + kr0] : 0;
    const int ks1 = (use_segids && kr1 < S) ? kv_seg[(size_t)b * S + kr1] : 0;
    const int wg_first = k0 + cw * 64;
    const int wg_last = min(k0 + cw * 64 + 64, S) - 1;
    const int cq = 2 * (lane & 3);
    const float sl2 = scale * LOG2E;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const uint32_t k_wg = k_s + cw * 64 * SW;
    const uint32_t v_wg = v_s + cw * 64 * SW;
    sm90::mbar_wait(bar_kv, 0);
    const bool keys_valid = flag_s[cw] != 0;

    for (int it = 0; it < n_items; ++it) {
      const int st = it % STAGES;
      const uint32_t ph = (it / STAGES) & 1;
      const int q0 = q_lo + (it % n_qt) * BQ;
      const int qp_first = q0 + q_pos_offset;
      const int qp_last = min(q0 + BQ, Tq) - 1 + q_pos_offset;
      sm90::mbar_wait(full(st), ph);
      if (any_pair(qp_first, qp_last, wg_first, wg_last, causal, left_window, right_window)) {
        // S^T = K Q^T and dP^T = V dO^T (keys are the rows), two groups: p^T
        // is formed while dP^T runs, ds^T while dV's product runs
        float s[BQ / 2], dp[BQ / 2];
        sm90::wgmma_fence();
        gemm_nt<D, BQ>(s, k_wg, BK, q_s(st));
        sm90::wgmma_commit();
        gemm_nt<D, BQ>(dp, v_wg, BK, do_s(st));
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        sm90::fence_regs(s);

        const bool interior = !use_segids && keys_valid &&
                              all_pairs(qp_first, qp_last, wg_first, wg_last, causal,
                                        left_window, right_window);
        const float* ls = lse_s + st * BQ;
        const float* ds_ = di_s + st * BQ;
        const int* ss = seg_s + st * BQ;
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          const bool second = (i & 2) != 0;
          const int col = 8 * (i >> 2) + cq + (i & 1);  // the query this element holds
          float p = sm90::ex2(s[i] * sl2 - ls[col]);
          if (!interior) {
            bool a = (second ? kv1 : kv0) &&
                     in_range(q0 + col + q_pos_offset, second ? kr1 : kr0, causal,
                              left_window, right_window);
            if (use_segids) a = a && ss[col] == (second ? ks1 : ks0);
            p = a ? p : 0.f;
          }
          s[i] = p;
        }

        // dV += p^T dO, p rounded to bf16
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
        pack_a<BQ>(pa, s);
        sm90::fence_regs(dv_acc);
        sm90::fence_regs(pa);
        sm90::wgmma_fence();
        gemm_rs<D, BQ>(dv_acc, pa, do_s(st));
        sm90::wgmma_commit();

        // dK += ds^T Q, ds rounded to bf16
        sm90::wgmma_wait<1>();  // dP^T
        sm90::fence_regs(dp);
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i)
          dp[i] = s[i] * (dp[i] - ds_[8 * (i >> 2) + cq + (i & 1)]) * scale;  // ds
        pack_a<BQ>(da, dp);
        sm90::fence_regs(dk_acc);
        sm90::fence_regs(da);
        sm90::wgmma_fence();
        gemm_rs<D, BQ>(dk_acc, da, q_s(st));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(pa);  // read by dV's product until here: not reused before
        sm90::fence_regs(dv_acc);
        sm90::fence_regs(dk_acc);
      }
      sm90::mbar_arrive(empty(st));
    }

    if (kr0 < S) {
      const size_t off = ((size_t)(b * S + kr0) * G + g) * D + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(dk + off + 8 * j) =
            make_float2(dk_acc[4 * j], dk_acc[4 * j + 1]);
        *reinterpret_cast<float2*>(dv + off + 8 * j) =
            make_float2(dv_acc[4 * j], dv_acc[4 * j + 1]);
      }
    }
    if (kr1 < S) {
      const size_t off = ((size_t)(b * S + kr1) * G + g) * D + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(dk + off + 8 * j) =
            make_float2(dk_acc[4 * j + 2], dk_acc[4 * j + 3]);
        *reinterpret_cast<float2*>(dv + off + 8 * j) =
            make_float2(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
      }
    }
  }
}

// --- launches -------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *lse, *di, *kv_valid, *q_seg, *kv_seg;
  void *dq, *dk, *dv;
  int B, Tq, S, Hq, G, D;
  float scale;
  int causal, left_window, right_window, q_pos_offset, use_segids;
  cudaStream_t stream;
};

template <int D>
int launch_dq_f32(const Args& a) {
  dim3 grid((a.Tq + ROWS - 1) / ROWS, a.Hq, a.B);
  flash_bwd_dq_f32_kernel<D><<<grid, THREADS, 0, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (const float*)a.dout,
      (const float*)a.lse, (const float*)a.di, (const int*)a.kv_valid,
      (const int*)a.q_seg, (const int*)a.kv_seg, (float*)a.dq, a.Tq, a.S,
      a.Hq, a.G, a.scale, a.causal, a.left_window, a.right_window,
      a.q_pos_offset, a.use_segids);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_f32(const Args& a) {
  dim3 grid((a.S + ROWS - 1) / ROWS, a.G, a.B);
  flash_bwd_dkv_f32_kernel<D><<<grid, THREADS, 0, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (const float*)a.dout,
      (const float*)a.lse, (const float*)a.di, (const int*)a.kv_valid,
      (const int*)a.q_seg, (const int*)a.kv_seg, (float*)a.dk, (float*)a.dv,
      a.Tq, a.S, a.Hq, a.G, a.scale, a.causal, a.left_window, a.right_window,
      a.q_pos_offset, a.use_segids);
  return (int)cudaGetLastError();
}

// The four tensor maps of a bf16 launch: q/do boxes of q_rows rows, k/v
// boxes of kv_rows rows.  Returns a CUDA error code (0 on success).
template <int D>
int make_maps(const Args& a, int q_rows, int kv_rows, CUtensorMap (&m)[4]) {
  using C = Cols<D>;
  sm90::EncodeTiledFn enc = sm90::encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.dout) |
       reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v)) % 16 != 0) {
    return (int)cudaErrorMisalignedAddress;  // TMA reads from 16-byte aligned bases
  }
  // a map of zero rows cannot be made; such a side is never loaded
  const uint64_t t_rows = a.Tq > 0 ? a.Tq : 1, s_rows = a.S > 0 ? a.S : 1;
  const uint64_t qw = (uint64_t)a.Hq * D, kw = (uint64_t)a.G * D;
  if (!sm90::make_map_bf16_3d(enc, &m[0], a.q, qw, t_rows, a.B, C::CW, q_rows, C::SW) ||
      !sm90::make_map_bf16_3d(enc, &m[1], a.dout, qw, t_rows, a.B, C::CW, q_rows, C::SW) ||
      !sm90::make_map_bf16_3d(enc, &m[2], a.k, kw, s_rows, a.B, C::CW, kv_rows, C::SW) ||
      !sm90::make_map_bf16_3d(enc, &m[3], a.v, kw, s_rows, a.B, C::CW, kv_rows, C::SW)) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <int D>
int launch_dq_bf16(const Args& a) {
  using C = DqTile<D>;
  if (a.B == 0 || a.Tq == 0) return 0;
  CUtensorMap m[4];
  if (int rc = make_maps<D>(a, C::BM, C::BN, m)) return rc;
  auto kern = flash_bwd_dq_wgmma_kernel<D>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(a.G, a.B, (a.Tq + C::BM - 1) / C::BM);
  kern<<<grid, WG_THREADS, C::SMEM, a.stream>>>(
      m[0], m[1], m[2], m[3], (const float*)a.lse, (const float*)a.di,
      (const int*)a.kv_valid, (const int*)a.q_seg, (const int*)a.kv_seg, (float*)a.dq, a.Tq,
      a.S, a.Hq, a.G, a.scale, a.causal, a.left_window, a.right_window, a.q_pos_offset,
      a.use_segids);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_bf16(const Args& a) {
  using C = DkvTile<D>;
  if (a.B == 0 || a.S == 0) return 0;
  CUtensorMap m[4];
  if (int rc = make_maps<D>(a, C::BQ, C::BK, m)) return rc;
  auto kern = flash_bwd_dkv_wgmma_kernel<D>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(a.G, a.B, (a.S + C::BK - 1) / C::BK);
  kern<<<grid, WG_THREADS, C::SMEM, a.stream>>>(
      m[0], m[1], m[2], m[3], (const float*)a.lse, (const float*)a.di,
      (const int*)a.kv_valid, (const int*)a.q_seg, (const int*)a.kv_seg, (float*)a.dk,
      (float*)a.dv, a.Tq, a.S, a.Hq, a.G, a.scale, a.causal, a.left_window, a.right_window,
      a.q_pos_offset, a.use_segids);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, D>) for the kernels' head dims.
template <typename F>
int with_head_dim(const Args& a, F f) {
  if (a.G <= 0 || a.Hq % a.G != 0) return (int)cudaErrorInvalidValue;
  switch (a.D) {
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
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
#define VATS_BWD_MAKE_ARGS(dq, dk, dv)                                      \
  make_args(q, k, v, dout, lse, di, kv_valid, q_seg, kv_seg, dq, dk, dv, B, \
            Tq, S, Hq, G, D, scale, causal, left_window, right_window,      \
            q_pos_offset, use_segids, stream)

extern "C" int vats_flash_bwd_dq_bf16(VATS_BWD_ARGS, void* dq, VATS_BWD_SCALARS) {
  const Args a = VATS_BWD_MAKE_ARGS(dq, nullptr, nullptr);
  return with_head_dim(a, [&](auto d) { return launch_dq_bf16<decltype(d)::value>(a); });
}

extern "C" int vats_flash_bwd_dq_f32(VATS_BWD_ARGS, void* dq, VATS_BWD_SCALARS) {
  const Args a = VATS_BWD_MAKE_ARGS(dq, nullptr, nullptr);
  return with_head_dim(a, [&](auto d) { return launch_dq_f32<decltype(d)::value>(a); });
}

extern "C" int vats_flash_bwd_dkv_bf16(VATS_BWD_ARGS, void* dk, void* dv,
                                       VATS_BWD_SCALARS) {
  const Args a = VATS_BWD_MAKE_ARGS(nullptr, dk, dv);
  return with_head_dim(a, [&](auto d) { return launch_dkv_bf16<decltype(d)::value>(a); });
}

extern "C" int vats_flash_bwd_dkv_f32(VATS_BWD_ARGS, void* dk, void* dv,
                                      VATS_BWD_SCALARS) {
  const Args a = VATS_BWD_MAKE_ARGS(nullptr, dk, dv);
  return with_head_dim(a, [&](auto d) { return launch_dkv_f32<decltype(d)::value>(a); });
}
