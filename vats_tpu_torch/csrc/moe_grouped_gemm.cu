// K7: the grouped expert GEMM of lossless MoE serving, over the routed rows.
//
// Replaces no TPU kernel: vats_tpu/nn/moe.py dispatches tokens into [E, C, d]
// buffers (one-hot einsums, or a sort) and leaves the expert products to
// XLA's batched matmul.  At lossless capacity C = n, so every expert's buffer
// holds every token of the call and the products run over E·n rows, of which
// n·k were routed (8x the routed work at 64 experts top-8, 4x at 8 top-2).
// This library runs the experts over the n·k routed rows alone.
//
// A layer forward is five launches, all reading the routing from the device
// (no host sync and static shapes, so a captured step replays correctly
// under any routing):
//   * plan (moe_route_plan_kernel): a stable counting sort of the n·k
//     slot-major assignments s = j·n + t (slot j of token t) by expert:
//     counts [E]; for each sorted row r its token and routing weight; for
//     each assignment s its row (inv).  Rows lie expert by expert, each
//     expert's in slot-major order (torch.argsort(stable=True)'s order).
//   * gather: x_rows[r] = x[token[r]].
//   * K7 (moe_grouped_wgmma_kernel), twice:
//       K7a  h[r] = silu(x_rows[r] Wg[e]) * (x_rows[r] Wu[e]), the SiLU and
//            the product on the fp32 accumulators, h rounded once to bf16;
//       K7b  y[r] = w[r] * (h[r] Wd[e]), the weight on the fp32 accumulator,
//            y rounded once to bf16.
//   * combine: out[t] = sum over j of y[inv[j·n + t]] in fp32, j in slot
//     order, rounded once to bf16 (no atomics: eager and replay bit-equal).
//
// Bound: a decode step (tens of rows an expert) reads every routed expert's
// weights once: bytes (code_chat_8k: 64 experts of 3 x 2304 x 896 bf16, 793 MB
// a layer).  A prefill (hundreds to thousands of rows an expert) is bound by
// the 6·d·f operations a routed row.
//
// Design:
//   * Rows: no padding.  A row tile of BM rows starts at an expert's first row
//     plus a multiple of BM; rows past the expert's last belong to the next
//     expert (or lie past the buffer, read as zeros) and are computed but never
//     stored.  Tiles at most ceil(n·k / BM) + E, a static bound.
//   * Schedule: each CTA reads the counts into shared memory and takes the
//     prefix sums of rows and row tiles; a work unit is (row tile, column
//     tile), row-tile-major, so the units in flight share an expert's weights
//     (in L2) and, at decode, stream each weight tile once.  Persistent grid:
//     each CTA walks units blockIdx.x, + gridDim.x, ... up to the count the
//     routing gives; the producer runs ahead into the next unit while the
//     consumers store the last.
//   * Operands by TMA through a ring of STAGES: A (x_rows or h, K-major) in
//     boxes of ABOX rows, only as many as the tile has routed rows; B (the
//     expert's [K, N] weight, N contiguous, MN-major) in chunks of 64 columns
//     x 64 K, 128-byte swizzle.  K7a's B tile is gate's chunks then up's at
//     the same columns, so one wgmma m64n(64·NCH) yields both halves.
//   * Two tile shapes, chosen from the rows an expert (n·k / E):
//       small (decode): one consumer warpgroup (BM 64), NCH 2 (K7a: 64
//         columns of gate and of up) or 1 (K7b: 64 columns), A in boxes of
//         16 rows, two CTAs a SM, many units to spread the weights over the
//         SMs;
//       large (prefill): two consumer warpgroups (BM 128), NCH 4 (K7a: 128
//         columns of gate and of up; K7b: 256 columns), one CTA a SM.
//   * K not a multiple of 64 (d 1440): the last stage's columns past K read
//     as zeros from both operands; column chunks wholly past N are not
//     loaded, and their columns are not stored.

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace sm90 = vats::sm90;

constexpr int BK = 64;    // K a stage: one 128-byte swizzle span of bf16
constexpr int SW = 128;   // swizzle span, bytes
constexpr int MAX_E = 256;
constexpr int PLAN_THREADS = 512;
constexpr int PLAN_MAX_NK = 192 * 1024;  // assignments a plan (one byte each in shared memory)

struct GemmParams {
  const int* counts;   // [E] routed rows of each expert
  const float* row_w;  // [R] routing weight of each row (K7b), or null
  __nv_bfloat16* out;  // [R, N]
  int E, R, N, k_steps, n_tiles;
};

template <int WG, int NCH, bool SWIGLU, int ABOX, int STAGES>
struct Cfg {
  static constexpr int BM = 64 * WG;
  static constexpr int THREADS = 128 * (WG + 1);
  static constexpr int BN_OUT = SWIGLU ? NCH / 2 * 64 : NCH * 64;  // output columns a tile
  static constexpr int A_BYTES = BM * SW;      // BM rows x 64 bf16
  static constexpr int CH_BYTES = BK * SW;     // one 64-column chunk of B
  static constexpr int B_BYTES = NCH * CH_BYTES;
  static constexpr int OFF_B = STAGES * A_BYTES;
  static constexpr int OFF_BAR = OFF_B + STAGES * B_BYTES;
  static constexpr int SMEM = OFF_BAR + 16 * STAGES + 1024;  // + alignment slack
  static constexpr int ACC = NCH * 32;  // fp32 accumulators a thread
  static_assert(!SWIGLU || NCH % 2 == 0, "gate and up chunks");
  static_assert(64 % ABOX == 0, "A boxes");
};

// the expert of row tile mt: the largest e with tstart[e] <= mt (experts
// without rows share the next one's start)
__device__ __forceinline__ int find_expert(const int* tstart, int E, int mt) {
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tstart[mid] <= mt) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

template <int WG, int NCH, bool SWIGLU, int ABOX, int STAGES>
__global__ void __launch_bounds__(128 * (WG + 1), WG == 1 ? 2 : 1)
moe_grouped_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                         const __grid_constant__ CUtensorMap tm_b0,
                         const __grid_constant__ CUtensorMap tm_b1, const GemmParams p) {
  using C = Cfg<WG, NCH, SWIGLU, ABOX, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int cnt_s[MAX_E];
  __shared__ int rstart[MAX_E];     // first row of each expert
  __shared__ int tstart[MAX_E + 1];  // first row tile of each expert; [E]: the total
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  auto a_s = [&](int st) { return base + st * C::A_BYTES; };
  auto b_s = [&](int st) { return base + C::OFF_B + st * C::B_BYTES; };
  auto full = [&](int st) { return base + C::OFF_BAR + 8 * st; };
  auto empty = [&](int st) { return base + C::OFF_BAR + 8 * (STAGES + st); };
  const int E = p.E;

  if (threadIdx.x < 32) {
    // prefix sums of rows and row tiles over the experts, lane l taking a
    // run of consecutive experts
    const int lane = threadIdx.x;
    const int per = (E + 31) / 32;
    int c_sum = 0, t_sum = 0;
    for (int i = 0; i < per; ++i) {
      const int e = lane * per + i;
      if (e < E) {
        const int c = p.counts[e];
        cnt_s[e] = c;
        c_sum += c;
        t_sum += (c + C::BM - 1) / C::BM;
      }
    }
    int c_inc = c_sum, t_inc = t_sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(0xffffffffu, c_inc, o);
      const int b = __shfl_up_sync(0xffffffffu, t_inc, o);
      if (lane >= o) {
        c_inc += a;
        t_inc += b;
      }
    }
    int c_run = c_inc - c_sum, t_run = t_inc - t_sum;
    for (int i = 0; i < per; ++i) {
      const int e = lane * per + i;
      if (e < E) {
        rstart[e] = c_run;
        tstart[e] = t_run;
        c_run += cnt_s[e];
        t_run += (cnt_s[e] + C::BM - 1) / C::BM;
      }
    }
    if (lane == 31) tstart[E] = t_inc;
  }
  if (threadIdx.x == 32) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(full(st), 1);             // the producer's arrival (+ the TMA bytes)
      sm90::mbar_init(empty(st), WG * 128);     // every consumer thread
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  const int total = tstart[E] * p.n_tiles;

  // a unit's expert, first row and routed rows
  auto unit = [&](int u, int& e, int& row0, int& rows, int& nt) {
    const int mt = u / p.n_tiles;
    nt = u - mt * p.n_tiles;
    e = find_expert(tstart, E, mt);
    const int j = mt - tstart[e];
    row0 = rstart[e] + j * C::BM;
    rows = min(C::BM, cnt_s[e] - j * C::BM);
  };

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every load
    if constexpr (WG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < total; u += gridDim.x) {
        int e, row0, rows, nt;
        unit(u, e, row0, rows, nt);
        const int nbox = (rows + ABOX - 1) / ABOX;
        int col[NCH];
        uint32_t bytes = nbox * ABOX * SW;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          col[c] = SWIGLU ? (nt * (NCH / 2) + c % (NCH / 2)) * 64 : (nt * NCH + c) * 64;
          if (col[c] < p.N) bytes += C::CH_BYTES;
        }
        for (int ks = 0; ks < p.k_steps; ++ks, ++it) {
          const int st = it % STAGES;
          const uint32_t ph = (it / STAGES) & 1;
          sm90::mbar_wait(empty(st), ph ^ 1);
          sm90::mbar_arrive_expect_tx(full(st), bytes);
          for (int b = 0; b < nbox; ++b)
            sm90::tma_load_3d(a_s(st) + b * ABOX * SW, &tm_a, full(st), ks * BK,
                              row0 + b * ABOX, 0);
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            if (col[c] >= p.N) continue;
            const CUtensorMap* m = (SWIGLU && c >= NCH / 2) ? &tm_b1 : &tm_b0;
            sm90::tma_load_3d(b_s(st) + c * C::CH_BYTES, m, full(st), col[c], ks * BK, e);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw computes rows [64 cw, 64 cw + 64) of a tile
    if constexpr (WG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int r0 = cw * 64 + (t >> 5) * 16 + (lane >> 2);  // tile rows r0 and r0 + 8
    const int cq = 2 * (lane & 3);  // this thread's first column in each group of 8
    int it = 0;
    for (int u = blockIdx.x; u < total; u += gridDim.x) {
      int e, row0, rows, nt;
      unit(u, e, row0, rows, nt);
      const bool active = cw * 64 < rows;  // the warpgroup's rows hold a routed row
      float acc[C::ACC];
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int ks = 0; ks < p.k_steps; ++ks, ++it) {
        const int st = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        sm90::mbar_wait(full(st), ph);
        if (active) {
          sm90::fence_regs(acc);
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            sm90::wgmma_ss_t<NCH * 64>(
                acc, sm90::make_desc(a_s(st) + cw * 64 * SW + kk * 32, 16, 8 * SW, SW),
                sm90::make_desc(b_s(st) + kk * 16 * SW, C::CH_BYTES, 8 * SW, SW), 1);
          }
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();  // the previous stage's products are done
          sm90::fence_regs(acc);
        }
        if (prev >= 0) sm90::mbar_arrive(empty(prev));
        prev = st;
      }
      if (active) {
        sm90::wgmma_wait_all();
        sm90::fence_regs(acc);
      }
      if (prev >= 0) sm90::mbar_arrive(empty(prev));
      if (!active) continue;

      const bool live0 = r0 < rows;
      const bool live1 = r0 + 8 < rows;
      __nv_bfloat16* out0 = p.out + (size_t)(row0 + r0) * p.N + nt * C::BN_OUT + cq;
      __nv_bfloat16* out1 = out0 + (size_t)8 * p.N;
      const int col0 = nt * C::BN_OUT + cq;
      if constexpr (SWIGLU) {
        constexpr int UP = C::BN_OUT / 8;  // up's first group of 8 columns in acc
#pragma unroll
        for (int j = 0; j < C::BN_OUT / 8; ++j) {
          if (col0 + 8 * j >= p.N) continue;
          const float* g = acc + 4 * j;
          const float* v = acc + 4 * (j + UP);
          if (live0)
            *reinterpret_cast<__nv_bfloat162*>(out0 + 8 * j) =
                __floats2bfloat162_rn(silu(g[0]) * v[0], silu(g[1]) * v[1]);
          if (live1)
            *reinterpret_cast<__nv_bfloat162*>(out1 + 8 * j) =
                __floats2bfloat162_rn(silu(g[2]) * v[2], silu(g[3]) * v[3]);
        }
      } else {
        const float w0 = live0 ? p.row_w[row0 + r0] : 0.f;
        const float w1 = live1 ? p.row_w[row0 + r0 + 8] : 0.f;
#pragma unroll
        for (int j = 0; j < C::BN_OUT / 8; ++j) {
          if (col0 + 8 * j >= p.N) continue;
          const float* a = acc + 4 * j;
          if (live0)
            *reinterpret_cast<__nv_bfloat162*>(out0 + 8 * j) =
                __floats2bfloat162_rn(a[0] * w0, a[1] * w0);
          if (live1)
            *reinterpret_cast<__nv_bfloat162*>(out1 + 8 * j) =
                __floats2bfloat162_rn(a[2] * w1, a[3] * w1);
        }
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

template <int WG, int NCH, bool SWIGLU, int ABOX, int STAGES>
int launch_gemm(const void* a, const void* b0, const void* b1, const GemmParams& p, int K,
                cudaStream_t stream) {
  using C = Cfg<WG, NCH, SWIGLU, ABOX, STAGES>;
  sm90::EncodeTiledFn enc = sm90::encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap ma, mb0, mb1;
  if (!sm90::make_map_bf16_3d(enc, &ma, a, (uint64_t)K, (uint64_t)p.R, 1, 64, ABOX, SW) ||
      !sm90::make_map_bf16_3d(enc, &mb0, b0, (uint64_t)p.N, (uint64_t)K, (uint64_t)p.E, 64,
                              BK, SW) ||
      !sm90::make_map_bf16_3d(enc, &mb1, b1, (uint64_t)p.N, (uint64_t)K, (uint64_t)p.E, 64,
                              BK, SW)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kern = moe_grouped_wgmma_kernel<WG, NCH, SWIGLU, ABOX, STAGES>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const long units = (long)((p.R + C::BM - 1) / C::BM + p.E) * p.n_tiles;
  const long slots = (long)sm_count() * (WG == 1 ? 2 : 1);
  const int grid = (int)(units < slots ? units : slots);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(ma, mb0, mb1, p);
  return (int)cudaGetLastError();
}

// ---- plan: stable counting sort of the assignments by expert --------------

// Block e places expert e's assignments.  ids: [n, k] int64 (row stride
// idx_stride), w: [n, k] bf16 or fp32 (row stride w_stride).
__global__ void __launch_bounds__(PLAN_THREADS)
moe_route_plan_kernel(const int64_t* idx, int idx_stride, const void* w, int w_stride,
                      int w_bf16, int n, int k, int E, int* counts, int* row_tok,
                      float* row_w, int* inv) {
  extern __shared__ uint8_t ids[];  // [n·k] slot-major expert ids
  __shared__ int cnt[MAX_E];
  __shared__ int warp_n[PLAN_THREADS / 32];
  __shared__ int first;
  const int e = blockIdx.x;
  const int nk = n * k;
  const int tid = threadIdx.x;
  for (int i = tid; i < E; i += PLAN_THREADS) cnt[i] = 0;
  __syncthreads();
  for (int s = tid; s < nk; s += PLAN_THREADS) {
    const int t = s % n, j = s / n;
    const int id = (int)idx[(size_t)t * idx_stride + j];
    ids[s] = (uint8_t)id;
    atomicAdd(&cnt[id], 1);
  }
  __syncthreads();
  if (tid == 0) {
    int acc = 0;
    for (int i = 0; i < e; ++i) acc += cnt[i];
    first = acc;
  }
  if (e == 0)
    for (int i = tid; i < E; i += PLAN_THREADS) counts[i] = cnt[i];

  // each warp a run of whole 32-assignment groups, in order
  const int warp = tid / 32, lane = tid % 32;
  constexpr int NW = PLAN_THREADS / 32;
  const int groups = (nk + 31) / 32;
  const int g0 = (int)((long)groups * warp / NW), g1 = (int)((long)groups * (warp + 1) / NW);
  int mine = 0;
  for (int g = g0; g < g1; ++g) {
    const int s = g * 32 + lane;
    mine += __popc(__ballot_sync(0xffffffffu, s < nk && ids[s] == e));
  }
  if (lane == 0) warp_n[warp] = mine;
  __syncthreads();
  int pos = first;
  for (int i = 0; i < warp; ++i) pos += warp_n[i];
  for (int g = g0; g < g1; ++g) {
    const int s = g * 32 + lane;
    const bool m = s < nk && ids[s] == e;
    const unsigned bal = __ballot_sync(0xffffffffu, m);
    if (m) {
      const int r = pos + __popc(bal & ((1u << lane) - 1u));
      const int t = s % n, j = s / n;
      row_tok[r] = t;
      const size_t wi = (size_t)t * w_stride + j;
      row_w[r] = w_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(w)[wi])
                        : reinterpret_cast<const float*>(w)[wi];
      inv[s] = r;
    }
    pos += __popc(bal);
  }
}

// ---- gather: x_rows[r] = x[row_tok[r]], a warp a row -----------------------

__global__ void __launch_bounds__(256)
moe_gather_rows_kernel(const __nv_bfloat16* x, const int* row_tok, __nv_bfloat16* out, int R,
                       int d) {
  const int r = blockIdx.x * 8 + threadIdx.x / 32;
  if (r >= R) return;
  const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)row_tok[r] * d);
  uint4* dst = reinterpret_cast<uint4*>(out + (size_t)r * d);
  for (int c = threadIdx.x % 32; c < d / 8; c += 32) dst[c] = src[c];
}

// ---- combine: out[t] = sum_j y[inv[j·n + t]], fp32, j in order -------------

__global__ void moe_combine_kernel(const __nv_bfloat16* y, const int* inv,
                                   __nv_bfloat16* out, int n, int k, int d) {
  const int t = blockIdx.x;
  for (int c = threadIdx.x * 8; c < d; c += blockDim.x * 8) {
    float acc[8], v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int j = 0; j < k; ++j) {
      vats::load8(y + (size_t)inv[(size_t)j * n + t] * d + c, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += v[i];
    }
    uint4 o;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    *reinterpret_cast<uint4*>(out + (size_t)t * d + c) = o;
  }
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace

// indices [n, k] int64 (row stride idx_stride, ids in [0, E)); weights [n, k]
// bf16 (w_bf16) or fp32 (row stride w_stride); counts [E] int32; row_tok,
// inv [n·k] int32; row_w [n·k] fp32.
extern "C" int vats_moe_route_plan(const void* idx, int idx_stride, const void* w,
                                   int w_stride, int w_bf16, int n, int k, int E, void* counts,
                                   void* row_tok, void* row_w, void* inv, void* stream) {
  if (E <= 0 || E > MAX_E || n < 0 || k <= 0 || (long)n * k > PLAN_MAX_NK)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      moe_route_plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PLAN_MAX_NK);
  if (attr != cudaSuccess) return (int)attr;
  moe_route_plan_kernel<<<E, PLAN_THREADS, n * k, (cudaStream_t)stream>>>(
      (const int64_t*)idx, idx_stride, w, w_stride, w_bf16, n, k, E, (int*)counts,
      (int*)row_tok, (float*)row_w, (int*)inv);
  return (int)cudaGetLastError();
}

// x [*, d] bf16; row_tok [R] int32; out [R, d] bf16; d a multiple of 8.
extern "C" int vats_moe_gather_rows(const void* x, const void* row_tok, void* out, int R, int d,
                                    void* stream) {
  if (R == 0) return 0;
  if (d % 8 != 0 || misaligned(x) || misaligned(out)) return (int)cudaErrorInvalidValue;
  moe_gather_rows_kernel<<<(R + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int*)row_tok, (__nv_bfloat16*)out, R, d);
  return (int)cudaGetLastError();
}

// a [R, K] bf16 rows laid out expert by expert (counts [E] int32 on the
// device); b0, b1 [E, K, N] bf16 (swiglu: gate and up; else b0 the down
// projection and b1 unused); row_w [R] fp32 (not swiglu); out [R, N] bf16.
// The small tiles take at most 64 rows an expert on average (R <= 64 E).
extern "C" int vats_moe_grouped_gemm(const void* a, const void* b0, const void* b1,
                                     const void* counts, const void* row_w, void* out, int R,
                                     int K, int N, int E, int swiglu, void* stream) {
  if (R == 0) return 0;
  if (E <= 0 || E > MAX_E || K % 8 != 0 || N % 8 != 0 || K <= 0 || N <= 0 ||
      (!swiglu && row_w == nullptr))
    return (int)cudaErrorInvalidValue;
  if (misaligned(a) || misaligned(b0) || misaligned(b1) || misaligned(out))
    return (int)cudaErrorMisalignedAddress;  // TMA from 16-byte aligned bases
  const bool small = R <= 64 * E;
  GemmParams p;
  p.counts = (const int*)counts;
  p.row_w = (const float*)row_w;
  p.out = (__nv_bfloat16*)out;
  p.E = E;
  p.R = R;
  p.N = N;
  p.k_steps = (K + BK - 1) / BK;
  cudaStream_t st = (cudaStream_t)stream;
  if (swiglu) {
    p.n_tiles = (N + (small ? 63 : 127)) / (small ? 64 : 128);
    return small ? launch_gemm<1, 2, true, 16, 4>(a, b0, b1, p, K, st)
                 : launch_gemm<2, 4, true, 64, 4>(a, b0, b1, p, K, st);
  }
  p.n_tiles = (N + (small ? 63 : 255)) / (small ? 64 : 256);
  return small ? launch_gemm<1, 1, false, 16, 6>(a, b0, b0, p, K, st)
               : launch_gemm<2, 4, false, 64, 4>(a, b0, b0, p, K, st);
}

// y [n·k, d] bf16; inv [n·k] int32 (slot-major); out [n, d] bf16.
extern "C" int vats_moe_combine(const void* y, const void* inv, void* out, int n, int k, int d,
                                void* stream) {
  if (n == 0) return 0;
  if (d % 8 != 0 || misaligned(y) || misaligned(out)) return (int)cudaErrorInvalidValue;
  const int lanes = ((d / 8 + 31) / 32) * 32;
  const int threads = lanes < 512 ? lanes : 512;
  moe_combine_kernel<<<n, threads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)y, (const int*)inv, (__nv_bfloat16*)out, n, k, d);
  return (int)cudaGetLastError();
}
