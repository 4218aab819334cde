// K9: absorbed multi-head latent attention (MLA) decode over a paged latent
// pool.
//
// Replaces no kernel of vats_tpu, which has no latent attention.  Added for
// DeepSeek-V2-style models: K1 (decode_attention.cu) takes at most 8 query
// heads a KV group and head dims up to 128, while an absorbed MLA decode
// has 16 query heads on one 576-wide key whose value is its own first 512
// elements.
//
// Semantics (ops/mla_decode.py's mla_decode_attention_ref):
//   * row b's query heads q[b, h, 0:576] (bf16; the nope part folded
//     through W_UK, then the roped part) attend the row's first
//     n = min(lengths[b], PPS * PS) latent vectors of layer `layer`, read
//     through page_table[b]: s = q . k * scale over all 576 elements; the
//     value of a key is its first 512 elements.  Out [b, h, 0:512] bf16.
//   * scores and the softmax in fp32; p is rounded to bf16 for p.v (the
//     bf16 P.V operand), against the running max of its CTA's tokens; the
//     normaliser sums the fp32 p.  Partials of a row's chunks combine
//     through the LSE in fp32, in chunk order (repeated calls give equal
//     bits).  A row with nothing to attend gives zeros.
//
// Layout: pool [L, P, PS, 576] bf16, one contiguous 1,152-byte vector a
// token; PS a multiple of 128.  q [B, H, 576] and out [B, H, 512]
// contiguous, H <= 16.
//
// Bound: bytes.  A call reads each row's n latent vectors once (1,152 B a
// token) for 2 * 16 * (576 + 512) FLOPs a token: ~30 FLOP/B, under the
// card's ~295, but above what the CUDA cores sustain, so the products run
// on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate): the
// 16 heads are exactly an mma's 16 rows, and every head reads the same
// keys, so a row's keys are read once for all heads.
//
// Design: grid (chunk, row); a chunk is `chunk_tiles` 128-token tiles of
// one row, and a CTA past its row's last token exits at once.  A CTA (8
// warps) walks its chunk in 64-token stages, two in flight: warp 0 issues
// one 1-D bulk copy (cp.async.bulk) a token row into shared memory rows
// padded to 1,168 bytes (ldmatrix reads them without bank conflicts),
// completion counted on the stage's mbarrier; the next stage's copies fly
// while this one is computed.  Per stage: S = Q K^T (warp w: the stage's
// tokens 8w..8w+7, 36 k-steps over the 576 dims, Q from shared memory);
// the stage's max per head across warps through shared memory, the online
// softmax (exp2, the scale folded with log2 e), p in bf16 to shared memory;
// O += P V (warp w: the value dims 64w..64w+63, V by ldmatrix.trans from
// the same rows the keys came from).  Each CTA ends with (m, l, o[512]) per
// head; a row with one chunk writes its output there, else the CTA writes
// the partial to a workspace [B, chunks, 16, 514] fp32, fences, counts
// itself on the row's counter, and the row's last CTA combines every chunk
// and resets the counter (the counter buffer is K1's, per stream).

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace sm90 = vats::sm90;

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int HEADS = 16;              // query heads: the mma's rows (fewer: zero rows)
constexpr int W = 576;                 // latent width (keys)
constexpr int DV = 512;                // value width: the latent's first DV elements
constexpr int TILE = 128;              // tokens a tile (chunks are whole tiles)
constexpr int SUB = 64;                // tokens a stage
constexpr int ROW = W + 8;             // shared row stride in elements (1,168 B)
constexpr int PROW = SUB + 8;          // P's row stride (144 B)
constexpr int KSTEPS = W / 16;         // k-steps of S
constexpr int DV_WARP = DV / NWARPS;   // value dims a warp in p.v
constexpr int NT = DV_WARP / 8;        // n-tiles a warp in p.v
constexpr int REC = DV + 2;            // floats a (chunk, head) record: m, l, o[DV]
constexpr float LOG2E = 1.4426950408889634f;
static_assert(SUB == 8 * NWARPS, "a warp scores 8 tokens of a stage");
static_assert(KSTEPS % 2 == 0 && NT % 2 == 0, "k-steps and n-tiles go in pairs");

constexpr int SMEM_Q = HEADS * ROW * 2;
constexpr int SMEM_KV = 2 * SUB * ROW * 2;
constexpr int SMEM_P = HEADS * PROW * 2;
constexpr int SMEM = SMEM_Q + SMEM_KV + SMEM_P + NWARPS * HEADS * 4;

struct Params {
  const __nv_bfloat16* q;     // [B, H, W]
  const __nv_bfloat16* pool;  // [L, P, PS, W]
  const int* table;           // [B, PPS]
  const int* lengths;         // [B]
  __nv_bfloat16* out;         // [B, H, DV]
  float* work;                // [B, chunks, HEADS, REC]
  int* counters;              // [>= B], zero between calls
  int H, P, PS, PPS, layer, chunk_tiles, chunks;
  float scale_log2;  // softmax scale * log2(e)
};

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, fp32 out
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS, 1) mla_decode_kernel(const Params p) {
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // an mma fragment's row group and column pair
  const int len = min(max(p.lengths[b], 0), p.PPS * p.PS);
  const int chunk_tok = p.chunk_tiles * TILE;
  const int live = max(1, (len + chunk_tok - 1) / chunk_tok);
  if (chunk >= live) return;  // past the row's last token
  const int c0 = chunk * chunk_tok;
  const int ntok = max(0, min(chunk_tok, len - c0));
  const int nsub = (ntok + SUB - 1) / SUB;

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_Q);
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_Q + SMEM_KV);
  float* red_s = reinterpret_cast<float*>(smem + SMEM_Q + SMEM_KV + SMEM_P);  // [NWARPS][HEADS]
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ int last_s;

  const __nv_bfloat16* pool_l = p.pool + (size_t)p.layer * p.P * p.PS * W;
  // warp 0: the copies of stage j's token rows (a stage lies in one page)
  auto issue = [&](int j) {
    const int stage = j & 1;
    const int t0 = c0 + j * SUB;
    const int nv = min(SUB, len - t0);
    const int page = p.table[(size_t)b * p.PPS + t0 / p.PS];
    const __nv_bfloat16* src = pool_l + ((size_t)page * p.PS + t0 % p.PS) * W;
    const uint32_t bar_a = sm90::smem_u32(&bar[stage]);
    if (lane == 0) {
      sm90::fence_proxy_async();  // the stage's earlier reads come first
      sm90::mbar_arrive_expect_tx(bar_a, (uint32_t)(nv * W * 2));
    }
    __syncwarp();
    for (int r = lane; r < nv; r += 32)
      sm90::bulk_load(sm90::smem_u32(kv_s + (size_t)(stage * SUB + r) * ROW),
                      src + (size_t)r * W, W * 2, bar_a);
  };

  if (tid == 0) {
    sm90::mbar_init(sm90::smem_u32(&bar[0]), 1);
    sm90::mbar_init(sm90::smem_u32(&bar[1]), 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (warp == 0) {
    if (nsub > 0) issue(0);
    if (nsub > 1) issue(1);
  }
  // q into shared memory while the first stages fly; heads past H are zero
  const __nv_bfloat16* qb = p.q + (size_t)b * p.H * W;
  for (int i = tid; i < HEADS * (W / 8); i += THREADS) {
    const int h = i / (W / 8), c = i % (W / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (h < p.H) v = *reinterpret_cast<const uint4*>(qb + (size_t)h * W + c * 8);
    *reinterpret_cast<uint4*>(q_s + h * ROW + c * 8) = v;
  }
  __syncthreads();

  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // heads g and g + 8, log2 units
  float l_run[2] = {0.f, 0.f};              // this thread's columns' share

  const uint32_t a_addr =
      sm90::smem_u32(q_s) + (uint32_t)(((lane & 15) * ROW + (lane >> 4) * 8) * 2);
  const uint32_t p_addr =
      sm90::smem_u32(p_s) + (uint32_t)(((lane & 15) * PROW + (lane >> 4) * 8) * 2);

  for (int j = 0; j < nsub; ++j) {
    const int stage = j & 1;
    const int nv = min(SUB, ntok - j * SUB);
    sm90::mbar_wait(sm90::smem_u32(&bar[stage]), (uint32_t)((j >> 1) & 1));
    __nv_bfloat16* kv = kv_s + (size_t)stage * SUB * ROW;
    if (nv < SUB) {  // rows past the row's last token: zeros, never stale bits
      for (int i = tid; i < (SUB - nv) * (W / 8); i += THREADS) {
        const int r = nv + i / (W / 8), c = i % (W / 8);
        *reinterpret_cast<uint4*>(kv + r * ROW + c * 8) = make_uint4(0u, 0u, 0u, 0u);
      }
      __syncthreads();
    }
    const uint32_t k_base = sm90::smem_u32(kv);

    // S = Q K^T over this warp's 8 tokens
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const uint32_t b_addr =
        k_base + (uint32_t)(((warp * 8 + (lane & 7)) * ROW + (lane >> 3) * 8) * 2);
#pragma unroll 6
    for (int kk = 0; kk < KSTEPS; kk += 2) {
      uint32_t a0[4], a1[4], bb[4];
      ldsm_x4(a_addr + kk * 32, a0);
      ldsm_x4(a_addr + (kk + 1) * 32, a1);
      ldsm_x4(b_addr + kk * 32, bb);
      mma16816(s, a0, bb[0], bb[1]);
      mma16816(s, a1, bb[2], bb[3]);
    }

    // the stage's max per head, across warps
    float sc[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = warp * 8 + 2 * t4 + (e & 1);
      sc[e] = col < nv ? s[e] * p.scale_log2 : -INFINITY;
    }
    float mx0 = fmaxf(sc[0], sc[1]), mx1 = fmaxf(sc[2], sc[3]);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    if (t4 == 0) {
      red_s[warp * HEADS + g] = mx0;
      red_s[warp * HEADS + g + 8] = mx1;
    }
    __syncthreads();
    float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      mt0 = fmaxf(mt0, red_s[w * HEADS + g]);
      mt1 = fmaxf(mt1, red_s[w * HEADS + g + 8]);
    }
    const float mn0 = fmaxf(m_run[0], mt0), mn1 = fmaxf(m_run[1], mt1);
    const float al0 = sm90::ex2(m_run[0] - mn0), al1 = sm90::ex2(m_run[1] - mn1);
    m_run[0] = mn0;
    m_run[1] = mn1;
    const float p0 = sm90::ex2(sc[0] - mn0), p1 = sm90::ex2(sc[1] - mn0);
    const float p2 = sm90::ex2(sc[2] - mn1), p3 = sm90::ex2(sc[3] - mn1);
    l_run[0] = l_run[0] * al0 + p0 + p1;
    l_run[1] = l_run[1] * al1 + p2 + p3;
    *reinterpret_cast<uint32_t*>(p_s + g * PROW + warp * 8 + 2 * t4) = sm90::pack_bf16(p0, p1);
    *reinterpret_cast<uint32_t*>(p_s + (g + 8) * PROW + warp * 8 + 2 * t4) =
        sm90::pack_bf16(p2, p3);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }
    __syncthreads();

    // O += P V over this warp's value dims
    const uint32_t v_addr =
        k_base +
        (uint32_t)((((lane & 7) + ((lane >> 3) & 1) * 8) * ROW + warp * DV_WARP + (lane >> 4) * 8) *
                   2);
#pragma unroll
    for (int kk = 0; kk < SUB / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(p_addr + kk * 32, a);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bb[4];
        ldsm_x4_t(v_addr + (uint32_t)((kk * 16 * ROW + n * 8) * 2), bb);
        mma16816(o[n], a, bb[0], bb[1]);
        mma16816(o[n + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // the stage, P and the maxima are free
    if (warp == 0 && j + 2 < nsub) issue(j + 2);
  }

  // the chunk's l per head: over the column pairs, then the warps
  float l0 = l_run[0], l1 = l_run[1];
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (t4 == 0) {
    red_s[warp * HEADS + g] = l0;
    red_s[warp * HEADS + g + 8] = l1;
  }
  __syncthreads();
  float lt0 = 0.f, lt1 = 0.f;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    lt0 += red_s[w * HEADS + g];
    lt1 += red_s[w * HEADS + g + 8];
  }

  if (live == 1) {  // the row's only chunk: its output
    const float i0 = lt0 > 0.f ? 1.f / lt0 : 0.f, i1 = lt1 > 0.f ? 1.f / lt1 : 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = warp * DV_WARP + n * 8 + 2 * t4;
      if (g < p.H)
        *reinterpret_cast<__nv_bfloat162*>(p.out + ((size_t)b * p.H + g) * DV + d) =
            __floats2bfloat162_rn(o[n][0] * i0, o[n][1] * i0);
      if (g + 8 < p.H)
        *reinterpret_cast<__nv_bfloat162*>(p.out + ((size_t)b * p.H + g + 8) * DV + d) =
            __floats2bfloat162_rn(o[n][2] * i1, o[n][3] * i1);
    }
    return;
  }

  float* wrow = p.work + (size_t)b * p.chunks * HEADS * REC;
  float* rec = wrow + (size_t)chunk * HEADS * REC;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = warp * DV_WARP + n * 8 + 2 * t4;
    rec[g * REC + 2 + d] = o[n][0];
    rec[g * REC + 3 + d] = o[n][1];
    rec[(g + 8) * REC + 2 + d] = o[n][2];
    rec[(g + 8) * REC + 3 + d] = o[n][3];
  }
  if (warp == 0 && t4 == 0) {
    rec[g * REC] = m_run[0];
    rec[g * REC + 1] = lt0;
    rec[(g + 8) * REC] = m_run[1];
    rec[(g + 8) * REC + 1] = lt1;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int arrived = atomicAdd(p.counters + b, 1);
    if (arrived >= live) __trap();  // the counter is not this call's alone
    last_s = arrived == live - 1;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  // the row's last CTA: every chunk through the LSE, in chunk order
  for (int i = tid; i < p.H * DV; i += THREADS) {
    const int h = i / DV, d = i % DV;
    float mx = -INFINITY;
    for (int c = 0; c < live; ++c) mx = fmaxf(mx, __ldcg(wrow + ((size_t)c * HEADS + h) * REC));
    float l = 0.f, acc = 0.f;
    for (int c = 0; c < live; ++c) {
      const float* r = wrow + ((size_t)c * HEADS + h) * REC;
      const float w = sm90::ex2(__ldcg(r) - mx);
      l += w * __ldcg(r + 1);
      acc += w * __ldcg(r + 2 + d);
    }
    p.out[((size_t)b * p.H + h) * DV + d] = __float2bfloat16(l > 0.f ? acc / l : 0.f);
  }
  if (tid == 0) p.counters[b] = 0;  // ready for the next call
}

}  // namespace

extern "C" int vats_mla_decode_bf16(const void* q, const void* pool, const void* table,
                                    const void* lengths, void* out, void* work, void* counters,
                                    int B, int H, int P, int PS, int PPS, int layer,
                                    int chunk_tiles, float scale, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > HEADS || PS % TILE != 0 || PPS < 1 || P < 1 ||
      chunk_tiles < 1 || layer < 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = (const __nv_bfloat16*)q;
  p.pool = (const __nv_bfloat16*)pool;
  p.table = (const int*)table;
  p.lengths = (const int*)lengths;
  p.out = (__nv_bfloat16*)out;
  p.work = (float*)work;
  p.counters = (int*)counters;
  p.H = H;
  p.P = P;
  p.PS = PS;
  p.PPS = PPS;
  p.layer = layer;
  p.chunk_tiles = chunk_tiles;
  p.chunks = (PPS * PS / TILE + chunk_tiles - 1) / chunk_tiles;
  p.scale_log2 = scale * LOG2E;
  cudaError_t err = cudaFuncSetAttribute(mla_decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.chunks, B);
  mla_decode_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
