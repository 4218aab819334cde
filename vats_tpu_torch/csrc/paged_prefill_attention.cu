// K6: paged tail-prefill attention.  A window of T new tokens a row (a
// serving engine's prompt tail, a speculative verify window) attends, row by
// row, its cached history and itself, reading K and V straight from the page
// pool through the row's page table.
//
// Replaces no TPU kernel: vats_tpu/nn/attention.py attends this branch
// (a cache with history, T > 1) with XLA over all the row's pages gathered
// into a dense buffer, and the port did the same in plain PyTorch (a
// [B, Hq, T, PPS*PS] fp32 score tensor a layer, every page of the table).
// This kernel reads only the pages that hold keys some query of its tile
// may attend.
//
// Semantics (``ops/paged_prefill_attention.py``'s plain version):
//   * q [B, T, Hq, Dp] bf16, roped, head dim zero-padded to the pool's Dp;
//     the pool [NL, P, 2, G, PS, Dp] bf16 (``PagedKVCache``'s layout); the
//     window is already appended, so every key lives in a page.  Query head
//     h reads KV group h / (Hq / G).
//   * query i of row b sits at position pos = lengths[b] + i.  Key p (p <
//     PPS*PS, the table's capacity: no key lies beyond it) is attended iff
//     p <= pos, and p < lengths[b] (cached) or the window mask is set at
//     p - lengths[b] (p < lengths[b] + T), and (left_window < 0 or
//     pos - p <= left_window).
//   * scores from bf16 operands in fp32, online softmax in fp32 (exp2 with
//     log2(e) folded into the scale), the normaliser from the fp32 p, p
//     rounded to bf16 as the operand of P V (K2's arithmetic); output
//     bf16, pad columns 0.  A query with no key attended writes 0, never
//     NaN.
//
// Bound: bytes at the serving shapes (B=8, T=512, Hq 24, G 8, Dp 64, an
// empty history: q and out 12.6 MB each, K/V 8.4 MB, against 6.05 GFLOP of
// causal pairs: 0.0100 ms of bytes, 0.0061 ms of operations), operations
// once the history is long.
//
// Design (K2's body, ``csrc/flash_attention.cu``, fed from pages):
//   * GQA packing: a consumer warpgroup's 64 wgmma rows hold PW = 64 / N
//     window positions times the N = Hq / G query heads of one KV group,
//     position-major (row r: position r / N, head r % N; rows past PW * N
//     stay zero and are never stored), so each K/V tile is loaded once a
//     group, not once a query head.  One CTA: two consumer warpgroups (2 PW
//     positions) and a producer warpgroup; grid (position tile, group,
//     row), position tiles in reverse so the longest causal rows start
//     first.  The consumers load their Q rows with 16-byte loads into the
//     128-byte swizzled layout TMA would write.
//   * Pages: one 3-D tensor map over the whole pool, [NL*P*2*G, PS, Dp],
//     boxes of 128 tokens x 64 columns with the 128-byte swizzle.  A key
//     tile is 128 tokens of one page: the producer reads the row's table
//     entry and loads K and V of (layer, page, group) by TMA; columns past
//     Dp read as zero (out-of-bounds fill), so the kernel's width D is 64
//     for Dp <= 64 and 128 above (96: the multimodal model's).  Two stages of K/V in shared memory, each with a
//     full and an empty mbarrier; the producer stages the tile's key
//     validity and a flag "every key valid" beside it.
//   * Tile skipping: a CTA walks key tiles from its left window's start
//     to min(lengths[b] + its last position + 1, lengths[b] + the window's
//     last set mask position + 1, PPS*PS), so a fresh row's tail of 512
//     tokens reads 1 to 4 pages of its 32, and a padded query walks no
//     further than its row's last valid key.
//   * Tiles with no causal or window edge and every key valid take no
//     per-element mask (K2's classification, per consumer warpgroup).

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace sm90 = vats::sm90;

constexpr int ROWS = 64;      // wgmma rows of a consumer warpgroup
constexpr int BN = 128;       // keys a tile: 128 tokens of one page
constexpr int STAGES = 2;     // K/V ring depth
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int BOX_W = 64;     // TMA box width: one 128-byte swizzle span of bf16
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;  // [B, T, Hq, Dp]
  const int* table;        // [B, PPS]
  const int* lengths;      // [B]
  const uint8_t* mask;     // [B, T] bool, or null: every window position valid
  __nv_bfloat16* out;      // [B, T, Hq, Dp]
  int T, Hq, G, N, Dp, P, PS, PPS, layer, left_window;
  int pw;  // window positions a consumer warpgroup: 64 / N
  float scale;
};

template <int D>
struct Tile : sm90::SwizzledCols<D> {
  static_assert(D == 64 || D == 128, "kernel width");
  static constexpr int QWG_BYTES = ROWS * D * 2;  // one warpgroup's Q rows
  static constexpr int KV_BYTES = BN * D * 2;
  // offsets from a 1024-byte aligned base
  static constexpr int OFF_K = 2 * QWG_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_VALID = OFF_V + STAGES * KV_BYTES;
  static constexpr int OFF_FLAG = OFF_VALID + STAGES * BN * 4;
  static constexpr int OFF_BAR = OFF_FLAG + 16 * STAGES;
  static constexpr int SMEM = OFF_BAR + 8 * 2 * STAGES + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
paged_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tm_kv, const Params p) {
  using C = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int win_end_s;
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw);
  int* valid_s = reinterpret_cast<int*>(sbase + C::OFF_VALID);
  int* flag_s = reinterpret_cast<int*>(sbase + C::OFF_FLAG);
  auto k_s = [&](int st) { return base + C::OFF_K + st * C::KV_BYTES; };
  auto v_s = [&](int st) { return base + C::OFF_V + st * C::KV_BYTES; };
  auto full = [&](int st) { return base + C::OFF_BAR + 8 * st; };
  auto empty = [&](int st) { return base + C::OFF_BAR + 8 * (STAGES + st); };

  const int qblk = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int T = p.T;
  const int len = p.lengths[b];
  const int cap = p.PPS * p.PS;
  const int i0 = qblk * 2 * p.pw;  // the CTA's first window position
  const int i_last = min(i0 + 2 * p.pw, T) - 1;

  if (threadIdx.x == 0) {
    win_end_s = p.mask == nullptr ? T : 0;
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(full(st), 2);         // the TMA's arrival + the masks' arrival
      sm90::mbar_init(empty(st), 2 * 128);  // every consumer thread
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  // the window's valid keys end at its last set mask position
  if (p.mask != nullptr) {
    int last = 0;
    for (int j = threadIdx.x; j < T; j += THREADS)
      if (p.mask[(size_t)b * T + j]) last = j + 1;
    if (last > 0) atomicMax(&win_end_s, last);
  }
  __syncthreads();
  const int kv_end = min(cap, len + win_end_s);  // no key at or past it is valid

  // key tiles any query of this CTA can attend; the rest are never loaded
  const int k_hi = min(kv_end, len + i_last + 1);
  int k_lo = 0;
  if (p.left_window >= 0) k_lo = max(0, len + i0 - p.left_window);
  k_lo = (k_lo / BN) * BN;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BN - 1) / BN : 0;

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one warp issues every load; the rest of its warpgroup idles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const int k0 = k_lo + it * BN;
        sm90::mbar_wait(empty(st), ph ^ 1);
        if (lane == 0) {
          const int page = p.table[(size_t)b * p.PPS + k0 / p.PS];
          // row of (layer, page, K, group) in the map's outer dimension; V is G rows on
          const int kv_row = ((p.layer * p.P + page) * 2) * p.G + g;
          sm90::mbar_arrive_expect_tx(full(st), 2 * C::KV_BYTES);
#pragma unroll
          for (int c = 0; c < C::NCH; ++c) {
            sm90::tma_load_3d(k_s(st) + c * BN * C::SW, &tm_kv, full(st), c * C::CW,
                              k0 % p.PS, kv_row);
            sm90::tma_load_3d(v_s(st) + c * BN * C::SW, &tm_kv, full(st), c * C::CW,
                              k0 % p.PS, kv_row + p.G);
          }
        }
        int all = 1;
#pragma unroll
        for (int j = lane; j < BN; j += 32) {
          const int key = k0 + j;
          const int ok = key < kv_end &&
                         (key < len || p.mask == nullptr || p.mask[(size_t)b * T + key - len]);
          valid_s[st * BN + j] = ok;
          all &= ok;
        }
        all = __all_sync(0xffffffffu, all);
        if (lane == 0) flag_s[st] = all;
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(full(st));
      }
    }
  } else {
    // ---- consumers: PW window positions x N heads in 64 rows a warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int N = p.N;
    const int rows = p.pw * N;               // rows that hold a query
    const int wi0 = i0 + cw * p.pw;          // the warpgroup's first window position
    const uint32_t q_wg = base + cw * C::QWG_BYTES;

    // Q rows into the 128-byte swizzled layout: row r, 16-byte chunk c of a
    // 64-column span lands at r * 128 + ((c ^ (r % 8)) * 16)
    for (int e = t; e < ROWS * (D / 8); e += 128) {
      const int r = e / (D / 8);
      const int c = e % (D / 8);
      const int i = wi0 + r / N;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < rows && i < T && c * 8 < p.Dp) {
        v = *reinterpret_cast<const uint4*>(
            p.q + ((size_t)(b * T + i) * p.Hq + g * N + r % N) * p.Dp + c * 8);
      }
      const uint32_t dst = q_wg + (c / 8) * ROWS * C::SW + r * C::SW + (((c % 8) ^ (r % 8)) * 16);
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x),
                   "r"(v.y), "r"(v.z), "r"(v.w)
                   : "memory");
    }
    sm90::fence_proxy_async();
    sm90::warpgroup_sync(1 + cw);

    const int r0 = (t >> 5) * 16 + (lane >> 2);  // rows r0 and r0 + 8
    const int r1 = r0 + 8;
    const int qi0 = wi0 + r0 / N, qi1 = wi0 + r1 / N;
    const bool live0 = r0 < rows && qi0 < T;
    const bool live1 = r1 < rows && qi1 < T;
    // a row that holds no query attends nothing (its Q is zero, never stored)
    const int pos0 = live0 ? len + qi0 : -1;
    const int pos1 = live1 ? len + qi1 : -1;
    const int wg_first = len + wi0;
    const int wg_last = len + min(wi0 + p.pw - 1, T - 1);
    const int cq = 2 * (lane & 3);  // this thread's first column in each group of 8
    const float sl2 = p.scale * LOG2E;
    const int lw = p.left_window;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

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
            s, sm90::make_desc(q_wg + chunk * ROWS * C::SW + col, 16, 8 * C::SW, C::SW),
            sm90::make_desc(k_s(st) + chunk * BN * C::SW + col, 16, 8 * C::SW, C::SW),
            kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(s);

      bool interior = flag_s[st] != 0 && k0 + BN - 1 <= wg_first;
      if (lw >= 0) interior = interior && wg_last - k0 <= lw;

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
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int jj = 8 * (i >> 2) + cq + (i & 1);
          const int key = k0 + jj;
          const int pos = (i & 2) ? pos1 : pos0;
          bool a = vs[jj] != 0 && key <= pos;
          if (lw >= 0) a = a && pos - key <= lw;
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

    // epilogue: the quad's partial sums, O / l (0 where no key was attended)
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
    const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
    if (live0) {
      __nv_bfloat16* op = p.out + ((size_t)(b * T + qi0) * p.Hq + g * N + r0 % N) * p.Dp + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        if (8 * j < p.Dp)
          *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
              __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    }
    if (live1) {
      __nv_bfloat16* op = p.out + ((size_t)(b * T + qi1) * p.Hq + g * N + r1 % N) * p.Dp + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        if (8 * j < p.Dp)
          *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
              __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

template <int D>
int launch_d(const Params& p, const void* pool, int B, int NL, cudaStream_t stream) {
  sm90::EncodeTiledFn enc = sm90::encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  if (!sm90::make_map_bf16_3d(enc, &map, pool, (uint64_t)p.Dp, (uint64_t)p.PS,
                              (uint64_t)NL * p.P * 2 * p.G, BOX_W, BN, 128)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kern = paged_prefill_wgmma_kernel<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<D>::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((p.T + 2 * p.pw - 1) / (2 * p.pw), p.G, B);
  kern<<<grid, THREADS, Tile<D>::SMEM, stream>>>(map, p);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out [B, T, Hq, Dp] bf16 (contiguous); pool [NL, P, 2, G, PS, Dp] bf16;
// table [B, PPS] int32; lengths [B] int32; mask [B, T] bool or null.
extern "C" int vats_paged_prefill_bf16(const void* q, const void* pool, const void* table,
                                       const void* lengths, const void* mask, void* out,
                                       int B, int T, int Hq, int G, int Dp, int NL, int P,
                                       int PS, int PPS, int layer, int left_window,
                                       float scale, void* stream) {
  if (B == 0 || T == 0) return 0;
  if (G <= 0 || Hq % G != 0 || Hq / G > ROWS || Dp % 16 != 0 || Dp > 128 || PS % BN != 0 ||
      layer < 0 || layer >= NL) {
    return (int)cudaErrorInvalidValue;
  }
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(pool) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0) {
    return (int)cudaErrorMisalignedAddress;  // 16-byte loads, TMA from 16-byte aligned bases
  }
  Params p;
  p.q = (const __nv_bfloat16*)q;
  p.table = (const int*)table;
  p.lengths = (const int*)lengths;
  p.mask = (const uint8_t*)mask;
  p.out = (__nv_bfloat16*)out;
  p.T = T;
  p.Hq = Hq;
  p.G = G;
  p.N = Hq / G;
  p.Dp = Dp;
  p.P = P;
  p.PS = PS;
  p.PPS = PPS;
  p.layer = layer;
  p.left_window = left_window;
  p.pw = ROWS / p.N;
  p.scale = scale;
  if (Dp <= 64) return launch_d<64>(p, pool, B, NL, (cudaStream_t)stream);
  return launch_d<128>(p, pool, B, NL, (cudaStream_t)stream);
}
