// K2 and K2': flash attention forward (online softmax, the [T, S] scores
// never leave the chip).
//
// Replaces vats_tpu/ops/flash_attention.py:_fwd_kernel (:67; K2, driven by
// _flash_forward and entered through flash_attention) and _fwd_kernel_lse
// (:207; K2', the training forward under _flash_fwd_rule): one body, whose
// LSE template flag also stores each row's logsumexp, fp32 [B, Hq, T], with
// the sentinel 1e30 for a row that attends no key (the JAX kernel's rule, so
// the backward's exp(s - lse) is 0 on such a row).
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
// Two bodies, chosen statically by dtype (not a fallback: each entry point
// runs its own body or returns the launch error):
//
// vats_flash_fwd_bf16 -- the Hopper body (flash_fwd_wgmma_kernel).
//   Bound at the main shapes (chip_smoke.py computes it from the inputs):
//   bytes at T = 512 (B=8, Hq=24, G=8, hd 60: 31.5 MB in and out against
//   6.05 GFLOP, 0.0094 vs 0.0061 ms), operations at long sequences (T = S =
//   2048, B=2: 24.2 GFLOP, 0.0245 ms against 0.0094 ms of bytes).
//   * One CTA per (128 query rows, q head, batch row); query tiles run in
//     reverse so the longest causal rows start first.  384 threads: warp 0
//     of warpgroup 0 is the producer (setmaxnreg 24), warpgroups 1 and 2
//     are consumers of 64 query rows each (wgmma's M; setmaxnreg 240).
//   * TMA with 3-D tensor maps [B, T, Hq*D] and [B, S, G*D] made on the
//     host (cuTensorMapEncodeTiled, fetched with
//     cudaGetDriverEntryPointByVersion: no -lcuda): rows past T or S are zero
//     fill, never the next batch row.
//     Q is loaded once; K and V go through a ring of 2 stages of 128 keys,
//     each stage a full and an empty mbarrier.  The producer also stages the
//     tile's kv_valid and segment ids and a flag "every key valid".
//   * Shared-memory tiles use the 128-byte swizzle (a D=64 bf16 row is 128
//     bytes; D=128 is two such column chunks; D=32 rows are 64 bytes and use
//     the 64-byte swizzle).  Q: 128 x D, K and V: 2 stages x 128 x D, bf16:
//     80 KB at D=64, 160 KB at D=128.
//   * S = Q K^T: wgmma.m64n128k16, A (Q) and B (K) K-major from shared
//     memory, fp32 accumulators.  P V: A = P from registers (the S
//     accumulator fragment rounded to bf16 in place, its layout is the A
//     operand's), B = V from shared memory in the transposed (MN-major)
//     mode, wgmma.m64nDk16.
//   * Softmax on the fragments: each row lives in one quad of lanes (two
//     rows per thread), max and sum by quad shuffles; exp2 with log2(e)
//     folded into the scale; O rescaled in registers; l summed from the
//     unrounded fp32 p, p rounded to bf16 for P V (the JAX kernel's
//     arithmetic).  A row with no key so far keeps m = -inf and exponent
//     base 0, so nothing is NaN.
//   * Each key tile is classified per consumer warpgroup as the JAX kernel
//     does: interior (no causal or window edge, every key valid, no
//     segments) takes no per-element mask; a boundary tile masks each
//     accumulator element from the (row, key) it holds.
//   * Epilogue: O / l (0 where l == 0) stored as bf16 from registers; LSE
//     m * ln 2 + log l, one fp32 per row.
//
// vats_flash_fwd_f32 -- the CUDA-core body (flash_fwd_f32_kernel), kept for
//   fp32 inputs: TF32 wgmma would miss the 2e-5 tolerances its card tests
//   hold, and fp32 is off the main path (tests only).  One thread owns one
//   query row, keeps q and the output accumulator in registers, and streams
//   K/V tiles through shared memory, where every thread of the block reads
//   the same key (a broadcast).  Scores in chunks of 16 keys, so the running
//   max is rescaled once per chunk; masked keys are selected away.

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// --- fp32: CUDA-core body -----------------------------------------------------

constexpr int BQ = 128;  // query rows per block, one per thread
constexpr int CH = 16;   // keys per online-softmax update

template <int D, bool LSE>
__global__ void __launch_bounds__(BQ)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ kv_valid,
                     const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                     float* __restrict__ out, float* __restrict__ lse, int Tq, int S,
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
    const float* qp = q + ((size_t)(b * Tq + qi) * Hq + h) * D;
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
    float* op = out + ((size_t)(b * Tq + qi) * Hq + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = o[d] * inv;
    if constexpr (LSE) {
      lse[((size_t)b * Hq + h) * Tq + qi] = (l == 0.f) ? 1e30f : m + logf(l);
    }
  }
}

template <int D>
int launch_f32_d(const void* q, const void* k, const void* v, const void* kv_valid,
                 const void* q_seg, const void* kv_seg, void* out, void* lse, int B,
                 int Tq, int S, int Hq, int G, float scale, int causal,
                 int left_window, int right_window, int q_pos_offset,
                 int use_segids, void* stream) {
  dim3 grid((Tq + BQ - 1) / BQ, Hq, B);
  if (lse != nullptr) {
    flash_fwd_f32_kernel<D, true><<<grid, BQ, 0, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const int*)kv_valid,
        (const int*)q_seg, (const int*)kv_seg, (float*)out, (float*)lse, Tq, S, Hq,
        G, scale, causal, left_window, right_window, q_pos_offset, use_segids);
  } else {
    flash_fwd_f32_kernel<D, false><<<grid, BQ, 0, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const int*)kv_valid,
        (const int*)q_seg, (const int*)kv_seg, (float*)out, nullptr, Tq, S, Hq, G,
        scale, causal, left_window, right_window, q_pos_offset, use_segids);
  }
  return (int)cudaGetLastError();
}

// --- bf16: Hopper body (TMA ring, wgmma, warp specialisation) --------------

namespace sm90 = vats::sm90;

constexpr int BM = 128;      // query rows per CTA: two consumer warpgroups of 64
constexpr int BN = 128;      // keys per tile
constexpr int STAGES = 2;    // K/V ring depth
constexpr int THREADS = 384; // producer warpgroup + two consumer warpgroups
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Tile : sm90::SwizzledCols<D> {
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;
  // offsets from a 1024-byte aligned base
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_VALID = OFF_V + STAGES * KV_BYTES;
  static constexpr int OFF_SEG = OFF_VALID + STAGES * BN * 4;
  static constexpr int OFF_FLAG = OFF_SEG + STAGES * BN * 4;
  static constexpr int OFF_BAR = OFF_FLAG + 16 * STAGES;
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

template <int D, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const int* __restrict__ kv_valid, const int* __restrict__ q_seg,
                       const int* __restrict__ kv_seg, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int Tq, int S, int Hq, int G, float scale,
                       int causal, int left_window, int right_window, int q_pos_offset,
                       int use_segids) {
  using C = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw);
  int* valid_s = reinterpret_cast<int*>(sbase + C::OFF_VALID);
  int* seg_s = reinterpret_cast<int*>(sbase + C::OFF_SEG);
  int* flag_s = reinterpret_cast<int*>(sbase + C::OFF_FLAG);
  const uint32_t q_s = base;
  const uint32_t bar_q = base + C::OFF_BAR;
  auto k_s = [&](int st) { return base + C::OFF_K + st * C::KV_BYTES; };
  auto v_s = [&](int st) { return base + C::OFF_V + st * C::KV_BYTES; };
  auto full = [&](int st) { return bar_q + 8 * (1 + st); };
  auto empty = [&](int st) { return bar_q + 8 * (1 + STAGES + st); };

  const int qblk = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (Hq / G);
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
    sm90::mbar_init(bar_q, 1);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(full(st), 2);  // the TMA's arrival + the masks' arrival
      sm90::mbar_init(empty(st), 2 * 128);  // every consumer thread
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one warp issues every load; the rest of its warpgroup idles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
        for (int c = 0; c < C::NCH; ++c)
          sm90::tma_load_3d(q_s + c * BM * C::SW, &tm_q, bar_q, h * D + c * C::CW, q0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const int k0 = k_lo + it * BN;
        sm90::mbar_wait(empty(st), ph ^ 1);
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(full(st), 2 * C::KV_BYTES);
#pragma unroll
          for (int c = 0; c < C::NCH; ++c) {
            sm90::tma_load_3d(k_s(st) + c * BN * C::SW, &tm_k, full(st), g * D + c * C::CW,
                              k0, b);
            sm90::tma_load_3d(v_s(st) + c * BN * C::SW, &tm_v, full(st), g * D + c * C::CW,
                              k0, b);
          }
        }
        int all = 1;
#pragma unroll
        for (int j = lane; j < BN; j += 32) {
          const int key = k0 + j;
          const int ok = key < S && kv_valid[(size_t)b * S + key] != 0;
          valid_s[st * BN + j] = ok;
          if (use_segids) seg_s[st * BN + j] = key < S ? kv_seg[(size_t)b * S + key] : 0;
          all &= ok;
        }
        all = __all_sync(0xffffffffu, all);
        if (lane == 0) flag_s[st] = all;
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(full(st));
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
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
    const int wg_last = min(q0 + cw * 64 + 63, Tq - 1) + q_pos_offset;
    const int cq = 2 * (lane & 3);  // this thread's first column in each group of 8
    const float sl2 = scale * LOG2E;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    const uint32_t q_wg = q_s + cw * 64 * C::SW;
    sm90::mbar_wait(bar_q, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % STAGES;
      const uint32_t ph = (it / STAGES) & 1;
      const int k0 = k_lo + it * BN;
      sm90::mbar_wait(full(st), ph);

      // S = Q K^T over D in steps of 16 columns
      float s[BN / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk * 16 % C::CW) * 2;
        const uint32_t chunk = kk * 16 / C::CW;
        sm90::wgmma_ss_m64n128(
            s, sm90::make_desc(q_wg + chunk * BM * C::SW + col, 16, 8 * C::SW, C::SW),
            sm90::make_desc(k_s(st) + chunk * BN * C::SW + col, 16, 8 * C::SW, C::SW),
            kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(s);

      bool interior = !use_segids && flag_s[st] != 0;
      if (causal) interior = interior && k0 + BN - 1 <= wg_first;
      else if (right_window >= 0) interior = interior && k0 + BN - 1 - wg_first <= right_window;
      if (left_window >= 0) interior = interior && wg_last - k0 <= left_window;

      float mx0 = -INFINITY, mx1 = -INFINITY;
      if (interior) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          s[i] *= sl2;
          if (i & 2) mx1 = fmaxf(mx1, s[i]);
          else mx0 = fmaxf(mx0, s[i]);
        }
      } else {
        const int* vs = valid_s + st * BN;
        const int* ss = seg_s + st * BN;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int jj = 8 * (i >> 2) + cq + (i & 1);
          const int key = k0 + jj;
          const int pos = (i & 2) ? pos1 : pos0;
          bool a = vs[jj] != 0;
          if (causal) a = a && key <= pos;
          else if (right_window >= 0) a = a && key - pos <= right_window;
          if (left_window >= 0) a = a && pos - key <= left_window;
          if (use_segids) a = a && ss[jj] == ((i & 2) ? qs1 : qs0);
          s[i] = a ? s[i] * sl2 : -INFINITY;
          if (i & 2) mx1 = fmaxf(mx1, s[i]);
          else mx0 = fmaxf(mx0, s[i]);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0);
      const float mn1 = fmaxf(m1, mx1);
      // a row with no key yet exponentiates against 0: its masked scores
      // give exp2(-inf) = 0, and the old statistics (all 0) scale by 0
      const float base0 = mn0 == -INFINITY ? 0.f : mn0;
      const float base1 = mn1 == -INFINITY ? 0.f : mn1;
      const float alpha0 = sm90::ex2(m0 - base0);
      const float alpha1 = sm90::ex2(m1 - base1);
      m0 = mn0;
      m1 = mn1;
      l0 *= alpha0;
      l1 *= alpha1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? alpha1 : alpha0;

      // p = exp2(s - m): l from the fp32 values, P V from their bf16 rounding
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        s[i] = sm90::ex2(s[i] - ((i & 2) ? base1 : base0));
        if (i & 2) l1 += s[i];
        else l0 += s[i];
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = sm90::pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = sm90::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = sm90::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = sm90::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P V over the tile's keys in steps of 16
      sm90::fence_regs(o);
      sm90::fence_regs(pa);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        sm90::wgmma_rs<D>(
            o, pa[kk], sm90::make_desc(v_s(st) + kk * 16 * C::SW, BN * C::SW, 8 * C::SW, C::SW));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(o);
      sm90::mbar_arrive(empty(st));
    }

    // epilogue: the quad's partial sums, O / l, the row logsumexp
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
    const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
    if (r0 < Tq) {
      __nv_bfloat16* op = out + ((size_t)(b * Tq + r0) * Hq + h) * D + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
            __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    }
    if (r1 < Tq) {
      __nv_bfloat16* op = out + ((size_t)(b * Tq + r1) * Hq + h) * D + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    if constexpr (LSE) {
      if ((lane & 3) == 0) {
        float* lp = lse + ((size_t)b * Hq + h) * Tq;
        if (r0 < Tq) lp[r0] = l0 == 0.f ? 1e30f : m0 * LN2 + logf(l0);
        if (r1 < Tq) lp[r1] = l1 == 0.f ? 1e30f : m1 * LN2 + logf(l1);
      }
    }
  }
}

template <int D, bool LSE>
int launch_bf16_kernel(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                       const void* kv_valid, const void* q_seg, const void* kv_seg,
                       void* out, void* lse, int B, int Tq, int S, int Hq, int G,
                       float scale, int causal, int left_window, int right_window,
                       int q_pos_offset, int use_segids, cudaStream_t stream) {
  auto kern = flash_fwd_wgmma_kernel<D, LSE>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<D>::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Tq + BM - 1) / BM, Hq, B);
  kern<<<grid, THREADS, Tile<D>::SMEM, stream>>>(
      mq, mk, mv, (const int*)kv_valid, (const int*)q_seg, (const int*)kv_seg,
      (__nv_bfloat16*)out, (float*)lse, Tq, S, Hq, G, scale, causal, left_window,
      right_window, q_pos_offset, use_segids);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16_d(const void* q, const void* k, const void* v, const void* kv_valid,
                  const void* q_seg, const void* kv_seg, void* out, void* lse, int B,
                  int Tq, int S, int Hq, int G, float scale, int causal,
                  int left_window, int right_window, int q_pos_offset,
                  int use_segids, void* stream) {
  using C = Tile<D>;
  if (B == 0 || Tq == 0) return 0;
  sm90::EncodeTiledFn enc = sm90::encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0) {
    return (int)cudaErrorMisalignedAddress;  // TMA reads from 16-byte aligned bases
  }
  const int s_rows = S > 0 ? S : 1;  // S == 0: no tile is loaded, the map only has to exist
  CUtensorMap mq, mk, mv;
  if (!sm90::make_map_bf16_3d(enc, &mq, q, (uint64_t)Hq * D, Tq, B, C::CW, BM, C::SW) ||
      !sm90::make_map_bf16_3d(enc, &mk, k, (uint64_t)G * D, s_rows, B, C::CW, BN, C::SW) ||
      !sm90::make_map_bf16_3d(enc, &mv, v, (uint64_t)G * D, s_rows, B, C::CW, BN, C::SW)) {
    return (int)cudaErrorInvalidValue;
  }
  if (lse != nullptr) {
    return launch_bf16_kernel<D, true>(mq, mk, mv, kv_valid, q_seg, kv_seg, out, lse, B, Tq,
                                       S, Hq, G, scale, causal, left_window, right_window,
                                       q_pos_offset, use_segids, (cudaStream_t)stream);
  }
  return launch_bf16_kernel<D, false>(mq, mk, mv, kv_valid, q_seg, kv_seg, out, nullptr, B,
                                      Tq, S, Hq, G, scale, causal, left_window, right_window,
                                      q_pos_offset, use_segids, (cudaStream_t)stream);
}

// f(std::integral_constant<int, D>) for the kernels' head dims.
template <typename F>
int with_head_dim(int D, F f) {
  switch (D) {
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    default: return (int)cudaErrorInvalidValue;
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
  if (Hq % G != 0) return (int)cudaErrorInvalidValue;
  return with_head_dim(D, [&](auto d) {
    return launch_bf16_d<decltype(d)::value>(q, k, v, kv_valid, q_seg, kv_seg, out, lse, B,
                                             Tq, S, Hq, G, scale, causal, left_window,
                                             right_window, q_pos_offset, use_segids, stream);
  });
}

extern "C" int vats_flash_fwd_f32(const void* q, const void* k, const void* v,
                                  const void* kv_valid, const void* q_seg,
                                  const void* kv_seg, void* out, void* lse,
                                  int B, int Tq, int S, int Hq, int G, int D,
                                  float scale,
                                  int causal, int left_window, int right_window,
                                  int q_pos_offset, int use_segids,
                                  void* stream) {
  if (Hq % G != 0) return (int)cudaErrorInvalidValue;
  return with_head_dim(D, [&](auto d) {
    return launch_f32_d<decltype(d)::value>(q, k, v, kv_valid, q_seg, kv_seg, out, lse, B,
                                            Tq, S, Hq, G, scale, causal, left_window,
                                            right_window, q_pos_offset, use_segids, stream);
  });
}
