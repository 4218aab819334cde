// K1 and K4: paged decode attention with in-place commit of the current
// token, over bf16/fp32 pools (K1) and int8 pools with fp32 scales (K4).
//
// Replaces vats_tpu/ops/decode_attention.py:371 _decode_kernel (built by
// _run_decode_kernel, entered through paged_decode_attention_commit and,
// with commit=0, paged_decode_attention): K1 is its bf16 mode, K4 its
// quantized=True mode.  One body serves both; the storage type T selects
// the mode at compile time.
//
// Semantics (the JAX kernel's numerics; its tiling differs, see below):
//   * one query token per row b with Hq = G*N heads attends over the row's
//     min(lengths[b], PPS*PS) settled tokens, read through page_table[b],
//     plus one extra, always-valid column: the current token's K/V (`cur`),
//     which seeds the fp32 softmax (m = s_cur, l = 1, o = v_cur).
//   * K1: q and cur attend in pool precision (a bf16 pool rounds fp32 q to
//     bf16).  Each 128-token tile takes p = exp(s - m_tile), m_tile the max
//     of its valid columns, and l sums the fp32 p; a bf16 pool rounds p to
//     bf16 before p.v, as the JAX kernel rounds it before its bf16 P.V
//     product.  The JAX kernel rounds p against its running max over its
//     own chunks (a TPU tiling choice), this kernel against its tile's max,
//     so the two agree to the bf16 rounding of p, not bit for bit.  fp32
//     pools keep p in fp32.
//   * K4: q and cur attend in fp32 (bf16 inputs convert exactly); each
//     history score is (q . k_int8) * k_scale * scale; each probability is
//     multiplied by its token's v_scale before p.v and not rounded (the
//     normaliser sums the unscaled probabilities).
//   * the seed and the tiles combine through the LSE in fp32, in tile order:
//     (M, l, o) starts at the seed; eight tiles at a time, M rises to their
//     max m_tile (l and o rescaled by exp(M_old - M)) and each tile adds
//     with weight exp(m_tile - M).  Masked columns are never loaded; their
//     probabilities are selected to 0, never multiplied by 0.
//   * with commit, the current K/V is written into slot
//     pos = min(lengths[b], PPS*PS - 1) of its page, in place, after every
//     read of the row's pages by its group, so a row at capacity attends the
//     old value of the clamped slot, as the oracle does.  Where rows share a
//     slot, the highest row's value is written (the oracle's sequential
//     scatter), whatever the order in which their CTAs finish.  K4 quantizes it
//     first, per (K/V, group), exactly as quantize_kv does: amax over the
//     stored head dim (pad elements are 0), scale = max(amax, 1e-8) / 127,
//     q = clip(rint(x / scale), -127, 127) with IEEE divisions and
//     round-half-even (no fast math), so the committed bytes equal the
//     plain append's; the scale goes to the scales pool.
//   * left_window >= 0 (K1 only; K4 refuses it) keeps the row's keys at
//     positions >= lo = lengths[b] - left_window: CTAs of tiles wholly below
//     lo exit at once, and the first live tile masks its tokens below lo and
//     does not copy them.  left_window = -1 attends every settled token,
//     the same work and bits as a kernel with no window (the JAX kernel
//     has none).
//
// Layout (the port's own): pool [L, P, 2, G, PS, D], head dim minor and
// zero-padded to whole 16-byte vectors (D = 8k for bf16/fp32, 16k for
// int8; 60 -> 64); scales (K4) [L, P, 2, G, PS] fp32.  PS is a multiple of
// 128, so one 128-token tile of one (page, K or V, group) is one contiguous
// block of 128 * D elements (16 KB at D=64 bf16, 8 KB int8) and its scales
// 512 contiguous bytes.  q [B, Hq, hd], k_cur / v_cur [B, G, hd] (any row
// strides, unit last stride) and out [B, Hq, hd] (contiguous) come at their
// logical head dim and in their own dtype (bf16 or fp32); the kernel
// zero-extends hd to D on load, so a call is this one launch.
//
// Bound: bytes.  A call reads each row's min(lengths[b], PPS*PS) settled
// tokens once, 2 * G * D pool elements a token (plus, for K4, 2 * G fp32
// scales).  The arithmetic is ~4 * N FLOPs per element read (N = 3 at the
// medium tier: ~6 FLOP/byte at bf16, far below the H100's ~295), so tensor
// cores would not help: what binds is how many bytes are in flight and how
// many round trips run in series.
//
// Design: the sequence is split over CTAs.  The grid is (tile, group, row),
// PPS*PS/128 tiles a row; a CTA whose tile starts at or past the row's
// history exits at once (tile 0 always runs, so an empty row still has a
// CTA to finish it; under a window, the tile of lo does).  One thread reads the tile's page id and issues 1-D
// bulk copies (cp.async.bulk, completion counted on one mbarrier) of the
// tile's valid K rows, V rows and, for K4, both scale rows, so every tile
// of every row is in flight at once, bounded by shared memory (~34 KB a CTA
// at D=64 bf16: six CTAs an SM).  All N heads of the group share the tile.
// q.k: D/8 lanes a token row (8 head-dim elements a lane, q in registers),
// the dot finished by shuffles; the tile's softmax a warp per head; p.v:
// D/8 lanes a V row, 16-byte reads, summed over the tile by shuffles and
// across warps in shared memory.  Each tile CTA then writes (m, l, o[N, D])
// in fp32 to a workspace [B, G, tiles, N, D + 2], fences, and counts itself
// on a per-(row, group) counter with atomicAdd; the CTA that arrives last
// combines the seed and every tile (in tile order, not arrival order, so
// repeated calls give equal bits), writes the output, does the commit
// (every read of the row's pages by its group has finished by then) and
// resets the counter to 0.  The counters are an int32 buffer the wrapper
// allocates zeroed once per (device, stream) and keeps: a call is one launch
// with no memset.  A CTA that counts past its row's tiles (a counter shared
// with an overlapping call, or left nonzero) traps: the device reports an
// error rather than leave an output uncombined.  Every row, one tile or
// many, takes this path.  The combine sits on the row's critical path,
// so every CTA reads what it would need up front, beside its copies: the
// page ids (the tile's, the commit's), s_cur (from q in registers) and its
// v_cur elements; the combine then merges eight tiles a step per output,
// their loads in flight together (one L2 round trip for up to 8 tiles).
// The body is instantiated for exactly 2, 3 or 4 heads a group (or up to
// 8), so no register set or shuffle is spent on an idle head.

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace sm90 = vats::sm90;

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int TILE = 128;              // tokens a CTA
constexpr int TPWARP = TILE / NWARPS;  // tokens a warp scores
// the p.v partial sums [NWARPS][<= 8 heads][D] fp32 fit over the K tile
static_assert(NWARPS * 8 * 4 <= TILE, "p.v partial sums overflow the K tile");
constexpr int DMAX = 128;  // padded head dim
constexpr int EPL = 8;     // head-dim elements a lane (q.k and p.v)

struct Params {
  const void* q;      // [B, Hq, hd], strides q_sb, q_sh
  const void* k_cur;  // [B, G, hd], strides k_sb, k_sh
  const void* v_cur;  // [B, G, hd], strides v_sb, v_sh
  void* pool;         // [L, P, 2, G, PS, D]
  float* scales;      // [L, P, 2, G, PS] (K4)
  const int* table;   // [B, PPS]
  const int* lengths;  // [B]
  void* out;          // [B, Hq, hd]
  float* work;        // [B, G, tiles, N, D + 2]: m, l, o per (tile, head)
  int* counters;      // [>= B * G], zero between calls
  long long q_sb, q_sh, k_sb, k_sh, v_sb, v_sh;
  int G, N, hd, D, P, PS, PPS, layer, tiles;
  float scale;
  int commit;
  int left_window;  // -1: none
};

// Precision in which q and the current token attend: the pool's for K1,
// fp32 for K4.
template <typename T> struct AttendType { using type = T; };
template <> struct AttendType<int8_t> { using type = float; };

template <typename T>
__device__ __forceinline__ float attend(float x) {
  return vats::to_f(vats::from_f<typename AttendType<T>::type>(x));
}

// Eight consecutive stored elements as floats (16-byte aligned for bf16,
// 32-byte for fp32, 8-byte for int8).
__device__ __forceinline__ void load_row8(const __nv_bfloat16* p, float* out) {
  vats::load8(p, out);
}
__device__ __forceinline__ void load_row8(const float* p, float* out) { vats::load8(p, out); }
__device__ __forceinline__ void load_row8(const int8_t* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < EPL; ++i) out[i] = (float)v[i];
}

// T: pool storage type; Q: type of q, cur and out; NH: heads a group, at most
// (N itself for 2, 3 or 4)
template <typename T, typename Q, int NH>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(const Params p) {
  constexpr bool QUANT = vats::is_int8<T>::value;
  const int tile = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.G, N = p.N, D = p.D, hd = p.hd, PS = p.PS;
  const int cap = p.PPS * PS;
  const int t0 = tile * TILE;
  // the tile's page id is read alongside the length (the table covers
  // every tile), not after it
  const int page = tid == 0 ? p.table[(size_t)b * p.PPS + t0 / PS] : 0;
  const int len = max(p.lengths[b], 0);
  const int hist = min(len, cap);
  const int row_tiles = max(1, (hist + TILE - 1) / TILE);
  // the window's first key and its tile, which always runs (tile 0 without
  // a window, so an empty row still has a CTA to finish it)
  const int lo = p.left_window >= 0 ? min(max(len - p.left_window, 0), hist) : 0;
  const int first_tile = min(lo / TILE, row_tiles - 1);
  if (tile < first_tile || (tile > first_tile && t0 >= hist)) return;  // nothing to attend
  const int ntok = max(0, min(TILE, hist - t0));
  const int skip = max(0, min(lo - t0, ntok));  // tokens [skip, ntok) attend

  extern __shared__ __align__(128) unsigned char smem[];
  const int tile_bytes = TILE * D * (int)sizeof(T);
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = reinterpret_cast<T*>(smem + tile_bytes);
  float* sc_s = reinterpret_cast<float*>(smem + 2 * tile_bytes);  // [2][TILE] (K4)
  float* p_s = sc_s + (QUANT ? 2 * TILE : 0);                      // [NH][TILE]
  // [NWARPS][NH][D] partial p.v sums, over k_s once q.k has read it
  float* red_s = reinterpret_cast<float*>(smem);
  __shared__ __align__(8) uint64_t bar;
  __shared__ float m_s[NH], l_s[NH], scur_s[NH];
  __shared__ int last_s, cpage_s;

  const size_t page_elems = (size_t)2 * G * PS * D;
  const size_t half = (size_t)G * PS * D;  // V half of a page
  T* pool_l = reinterpret_cast<T*>(p.pool) + (size_t)p.layer * p.P * page_elems;
  float* sc_l = QUANT ? p.scales + (size_t)p.layer * p.P * 2 * G * PS : nullptr;
  const uint32_t bar_a = sm90::smem_u32(&bar);

  if (ntok > skip) {
    if (tid == 0) {
      sm90::mbar_init(bar_a, 1);
      sm90::fence_barrier_init();
    }
    __syncthreads();
    if (tid == 0) {
      const int off = t0 % PS + skip;
      const T* src = pool_l + (size_t)page * page_elems + ((size_t)g * PS + off) * D;
      const uint32_t bytes = (uint32_t)((ntok - skip) * D * (int)sizeof(T));
      // scale rows rounded up to whole 16 bytes (still inside the page)
      const uint32_t sc_bytes = QUANT ? (uint32_t)(((ntok + 3) & ~3) * 4) : 0u;
      sm90::mbar_arrive_expect_tx(bar_a, 2 * bytes + 2 * sc_bytes);
      sm90::bulk_load(sm90::smem_u32(k_s + (size_t)skip * D), src, bytes, bar_a);
      sm90::bulk_load(sm90::smem_u32(v_s + (size_t)skip * D), src + half, bytes, bar_a);
      if constexpr (QUANT) {
        const float* ssrc = sc_l + ((size_t)page * 2 * G + g) * PS + off;
        sm90::bulk_load(sm90::smem_u32(sc_s), ssrc, sc_bytes, bar_a);
        sm90::bulk_load(sm90::smem_u32(sc_s + TILE), ssrc + (size_t)G * PS, sc_bytes, bar_a);
      }
    }
  }

  // the commit's page (used by the row's last CTA), read while the copies fly
  const int pos = min(len, cap - 1);
  if (p.commit && tid == 0) cpage_s = p.table[(size_t)b * p.PPS + pos / PS];
  // Rows may share a commit slot (the serving engine parks idle rows on one
  // scratch page): the highest such row writes it, as a loop over the rows
  // in order would, so the pool never depends on which CTA ends last.
  // Whether a higher row commits here is also read while the copies fly.
  int later = 0;
  if (p.commit) {
    const int cpage = p.table[(size_t)b * p.PPS + pos / PS];
    for (int r = b + 1 + tid; r < (int)gridDim.z; r += THREADS) {
      const int rpos = min(max(p.lengths[r], 0), cap - 1);
      later |= rpos % PS == pos % PS && p.table[(size_t)r * p.PPS + rpos / PS] == cpage;
    }
  }

  // lpt lanes a token row, EPL head-dim elements a lane: lane `sub` of a
  // row holds elements [sub * EPL, sub * EPL + EPL) of every head's q
  const int nch = D / EPL;
  const int lpt = nch <= 1 ? 1 : nch <= 2 ? 2 : nch <= 4 ? 4 : nch <= 8 ? 8 : 16;
  const int sub = lane & (lpt - 1);
  const bool has_ch = sub < nch;
  const Q* qp = reinterpret_cast<const Q*>(p.q) + b * p.q_sb + (long long)g * N * p.q_sh;
  const Q* kc = reinterpret_cast<const Q*>(p.k_cur) + b * p.k_sb + (long long)g * p.k_sh;
  const Q* vc = reinterpret_cast<const Q*>(p.v_cur) + b * p.v_sb + (long long)g * p.v_sh;
  float qr[NH][EPL], kcr[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int d = sub * EPL + e;
    kcr[e] = d < hd ? attend<T>(vats::to_f(kc[d])) : 0.f;
  }
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = sub * EPL + e;
      qr[h][e] = (h < N && d < hd) ? attend<T>(vats::to_f(qp[h * p.q_sh + d])) : 0.f;
    }
  // the seed: s_cur = q . k_cur * scale (warp 0's first row group), and
  // the v_cur elements of the outputs this thread may write
  if (warp == 0) {
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      float sp = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) sp = fmaf(qr[h][e], kcr[e], sp);
      for (int o = lpt >> 1; o > 0; o >>= 1) sp += __shfl_xor_sync(0xffffffffu, sp, o);
      if (lane == 0 && h < N) scur_s[h] = sp * p.scale;
    }
  }
  float vcr[NH];  // output i = tid + k * THREADS is (head i / hd, dim i % hd)
#pragma unroll
  for (int k = 0; k < NH; ++k) {
    const int i = tid + k * THREADS;
    vcr[k] = i < N * hd ? attend<T>(vats::to_f(vc[i % hd])) : 0.f;
  }

  if (ntok > skip) {
    sm90::mbar_wait(bar_a, 0);
    // q.k: warp w scores tokens [w * TPWARP, (w + 1) * TPWARP), 32 / lpt a step
    const int tpw = 32 / lpt;
    for (int base = warp * TPWARP; base < (warp + 1) * TPWARP; base += tpw) {
      const int tok = base + lane / lpt;
      const bool mine = tok >= skip && tok < ntok;
      float acc[NH];
#pragma unroll
      for (int h = 0; h < NH; ++h) acc[h] = 0.f;
      if (mine && has_ch) {
        float kv[EPL];
        load_row8(k_s + (size_t)tok * D + sub * EPL, kv);
#pragma unroll
        for (int h = 0; h < NH; ++h)
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[h] = fmaf(qr[h][e], kv[e], acc[h]);
      }
      for (int o = lpt >> 1; o > 0; o >>= 1)
#pragma unroll
        for (int h = 0; h < NH; ++h) acc[h] += __shfl_xor_sync(0xffffffffu, acc[h], o);
      if (sub == 0 && mine) {
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          if (h < N) {
            float s = acc[h];
            if constexpr (QUANT) s *= sc_s[tok];
            p_s[h * TILE + tok] = s * p.scale;
          }
        }
      }
    }
  }
  __syncthreads();

  // the tile's softmax, a warp per head: m_tile, l (fp32 p), stored p
  for (int h = warp; h < N; h += NWARPS) {
    float sv[TILE / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < TILE / 32; ++j) {
      const int tok = lane + 32 * j;
      const bool valid = tok >= skip && tok < ntok;
      sv[j] = valid ? p_s[h * TILE + tok] : -INFINITY;
      mx = fmaxf(mx, sv[j]);
    }
    mx = vats::warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < TILE / 32; ++j) {
      const int tok = lane + 32 * j;
      const bool valid = tok >= skip && tok < ntok;
      const float pr = valid ? expf(sv[j] - mx) : 0.f;
      sum += pr;
      float pm = pr;
      if constexpr (std::is_same<T, __nv_bfloat16>::value)
        pm = __bfloat162float(__float2bfloat16(pr));  // the bf16 P.V operand
      if constexpr (QUANT) pm = valid ? pr * sc_s[TILE + tok] : 0.f;
      p_s[h * TILE + tok] = pm;
    }
    sum = vats::warp_sum(sum);
    if (lane == 0) {
      m_s[h] = mx;
      l_s[h] = sum;
    }
  }
  __syncthreads();

  // p.v: thread (row group, sub) walks V rows tid / lpt, + THREADS / lpt, ...
  float o[NH][EPL];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[h][e] = 0.f;
  if (has_ch) {
    for (int tok = skip + tid / lpt; tok < ntok; tok += THREADS / lpt) {
      float vv[EPL];
      load_row8(v_s + (size_t)tok * D + sub * EPL, vv);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        if (h < N) {
          const float pr = p_s[h * TILE + tok];
#pragma unroll
          for (int e = 0; e < EPL; ++e) o[h][e] = fmaf(pr, vv[e], o[h][e]);
        }
      }
    }
  }
  // sum over the warp's row groups (lanes lpt, 2 lpt, ... apart), then
  // across warps in shared memory, warp by warp
  for (int off = lpt; off < 32; off <<= 1)
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int e = 0; e < EPL; ++e) o[h][e] += __shfl_xor_sync(0xffffffffu, o[h][e], off);
  if (lane < lpt && has_ch) {
#pragma unroll
    for (int h = 0; h < NH; ++h)
      if (h < N)
#pragma unroll
        for (int e = 0; e < EPL; ++e) red_s[(warp * NH + h) * D + sub * EPL + e] = o[h][e];
  }
  __syncthreads();

  const int W = D + 2;  // floats a (tile, head) record: m, l, o[D]
  float* wrow = p.work + ((size_t)b * G + g) * p.tiles * N * W;
  float* rec = wrow + (size_t)tile * N * W;
  for (int i = tid; i < N * D; i += THREADS) {
    const int h = i / D, d = i % D;
    float s = red_s[h * D + d];
    for (int w = 1; w < NWARPS; ++w) s += red_s[(w * NH + h) * D + d];
    rec[h * W + 2 + d] = s;
  }
  if (tid < N) {
    rec[tid * W] = m_s[tid];
    rec[tid * W + 1] = l_s[tid];
  }
  __threadfence();
  const bool later_writer = __syncthreads_or(later) != 0;
  if (tid == 0) {
    const int arrived = atomicAdd(p.counters + (size_t)b * G + g, 1);
    const int live = row_tiles - first_tile;
    if (arrived >= live) __trap();  // the counter is not this call's alone
    last_s = arrived == live - 1;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  // the row's last CTA: the seed and the tiles through the LSE, in tile
  // order, eight tiles a step: each output keeps (M, l, o) from the seed
  // (s_cur, 1, v_cur), and a step loads its tiles' (m, l, o) at once,
  // raises M to their max and adds them with weights exp(m - M).  One
  // fixed order: repeated calls give equal bits.
  Q* out = reinterpret_cast<Q*>(p.out) + ((size_t)b * G + g) * N * hd;
#pragma unroll
  for (int k = 0; k < NH; ++k) {
    const int i = tid + k * THREADS;
    if (i < N * hd) {
      const int h = i / hd, d = i % hd;
      float mx = scur_s[h], l = 1.f, acc = vcr[k];
      for (int step = first_tile; step < row_tiles; step += 8) {
        float mt[8], lt[8], ot[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int t = step + j;
          mt[j] = -INFINITY;
          lt[j] = ot[j] = 0.f;
          if (t < row_tiles) {
            const float* r = wrow + ((size_t)t * N + h) * W;
            mt[j] = __ldcg(r);
            lt[j] = __ldcg(r + 1);
            ot[j] = __ldcg(r + 2 + d);
          }
        }
        float m_new = mx;
#pragma unroll
        for (int j = 0; j < 8; ++j) m_new = fmaxf(m_new, mt[j]);
        const float alpha = expf(mx - m_new);
        l *= alpha;
        acc *= alpha;
        mx = m_new;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float w = expf(mt[j] - mx);  // 0 past the row's tiles
          l += w * lt[j];
          acc += w * ot[j];
        }
      }
      out[i] = vats::from_f<Q>(acc / l);
    }
  }

  if (p.commit && !later_writer) {
    // every CTA of this (row, group) has read its tile (their bulk copies
    // completed before they arrived), so the slot may change now
    const int cpage = cpage_s;
    T* dst = pool_l + (size_t)cpage * page_elems + ((size_t)g * PS + pos % PS) * D;
    if constexpr (QUANT) {
      // warp 0 quantizes K, warp 1 V; D <= 128 is at most 4 values a lane
      if (warp < 2) {
        const Q* src = warp == 0 ? kc : vc;
        float x[DMAX / 32];
        float amax = 0.f;
#pragma unroll
        for (int j = 0; j < DMAX / 32; ++j) {
          const int d = lane + 32 * j;
          x[j] = d < hd ? vats::to_f(src[d]) : 0.f;
          amax = fmaxf(amax, fabsf(x[j]));
        }
        amax = vats::warp_max(amax);
        const float qs = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
        T* row = dst + (warp == 0 ? 0 : half);
#pragma unroll
        for (int j = 0; j < DMAX / 32; ++j) {
          const int d = lane + 32 * j;
          if (d < D)
            row[d] = vats::from_f<T>(fminf(fmaxf(rintf(__fdiv_rn(x[j], qs)), -127.f), 127.f));
        }
        if (lane == 0)
          sc_l[((size_t)cpage * 2 * G + (size_t)warp * G + g) * PS + pos % PS] = qs;
      }
    } else {
      for (int d = tid; d < D; d += THREADS) {
        dst[d] = vats::from_f<T>(d < hd ? vats::to_f(kc[d]) : 0.f);
        dst[half + d] = vats::from_f<T>(d < hd ? vats::to_f(vc[d]) : 0.f);
      }
    }
  }
  if (tid == 0) p.counters[(size_t)b * G + g] = 0;  // ready for the next call
}

template <typename T, typename Q, int NH>
int launch_typed(const Params& p, int B, cudaStream_t stream) {
  const int smem = 2 * TILE * p.D * (int)sizeof(T) +
                   (vats::is_int8<T>::value ? 2 * TILE * 4 : 0) + NH * TILE * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<T, Q, NH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(p.tiles, p.G, B);
  paged_decode_kernel<T, Q, NH><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// the body for exactly N heads a group where N is 2, 3 or 4 (no idle
// register sets), else for at most 8
template <typename T, typename Q>
int launch_heads(const Params& p, int B, cudaStream_t s) {
  switch (p.N) {
    case 1:
    case 2: return launch_typed<T, Q, 2>(p, B, s);
    case 3: return launch_typed<T, Q, 3>(p, B, s);
    case 4: return launch_typed<T, Q, 4>(p, B, s);
    default: return launch_typed<T, Q, 8>(p, B, s);
  }
}

template <typename T>
int launch(const void* q, const void* k_cur, const void* v_cur, void* pool, void* scales,
           const void* table, const void* lengths, void* out, void* work, void* counters,
           int io_bf16, int B, int G, int N, int hd, int D, int P, int PS, int PPS, int layer,
           long long q_sb, long long q_sh, long long k_sb, long long k_sh, long long v_sb,
           long long v_sh, float scale, int commit, int left_window, void* stream) {
  constexpr int GRANULE = 16 / sizeof(T) > 8 ? 16 / sizeof(T) : 8;
  if (N < 1 || N > 8 || D > DMAX || D % GRANULE != 0 || hd < 1 || hd > D ||
      PS % TILE != 0 || PPS < 1 || B < 1 || B > 65535 || G < 1 || G > 65535)
    return (int)cudaErrorInvalidValue;
  if (vats::is_int8<T>::value && scales == nullptr) return (int)cudaErrorInvalidValue;
  if (left_window < -1 || (vats::is_int8<T>::value && left_window >= 0))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k_cur = k_cur;
  p.v_cur = v_cur;
  p.pool = pool;
  p.scales = (float*)scales;
  p.table = (const int*)table;
  p.lengths = (const int*)lengths;
  p.out = out;
  p.work = (float*)work;
  p.counters = (int*)counters;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.G = G;
  p.N = N;
  p.hd = hd;
  p.D = D;
  p.P = P;
  p.PS = PS;
  p.PPS = PPS;
  p.layer = layer;
  p.tiles = PPS * PS / TILE;
  p.scale = scale;
  p.commit = commit;
  p.left_window = left_window;
  const cudaStream_t s = (cudaStream_t)stream;
  return io_bf16 ? launch_heads<T, __nv_bfloat16>(p, B, s) : launch_heads<T, float>(p, B, s);
}

}  // namespace

// q, k_cur, v_cur and out are bf16 when io_bf16, else fp32; strides in elements.
#define VATS_DECODE_ENTRY(NAME, T)                                                       \
  extern "C" int NAME(const void* q, const void* k_cur, const void* v_cur, void* pool,   \
                      void* scales, const void* table, const void* lengths, void* out,   \
                      void* work, void* counters, int io_bf16, int B, int G, int N,      \
                      int hd, int D, int P, int PS, int PPS, int layer, long long q_sb,  \
                      long long q_sh, long long k_sb, long long k_sh, long long v_sb,    \
                      long long v_sh, float scale, int commit, int left_window,          \
                      void* stream) {                                                    \
    return launch<T>(q, k_cur, v_cur, pool, scales, table, lengths, out, work, counters, \
                     io_bf16, B, G, N, hd, D, P, PS, PPS, layer, q_sb, q_sh, k_sb, k_sh, \
                     v_sb, v_sh, scale, commit, left_window, stream);                    \
  }

VATS_DECODE_ENTRY(vats_paged_decode_bf16, __nv_bfloat16)
VATS_DECODE_ENTRY(vats_paged_decode_f32, float)
VATS_DECODE_ENTRY(vats_paged_decode_int8, int8_t)
