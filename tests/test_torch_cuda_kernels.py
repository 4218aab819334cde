"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU and ``nvcc``; without them every test here skips.
They cover shapes off the main path (odd head dims, one or eight heads per
group, fp32 pools, windows, offsets) that ``chip_smoke.py`` does not.  This
file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: fp32 kernels against fp32 plain versions 2e-5 (sums in another
order); bf16 outputs one bf16 ulp (rtol 1e-2) plus 2e-3 absolute, as in
chip_smoke.py.  Committed pools and caches must be bit-equal.
"""

import pytest
import torch

from vats_tpu_torch.ops import cache_append as ca
from vats_tpu_torch.ops import decode_attention as da
from vats_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=2e-3, rtol=1e-2)}
# The bf16 flash backward (fp32 gradients): kernel and plain version round
# the same fp32 p and ds to bf16 before their products; sums in another
# order flip a rounding now and then, one bf16 ulp (2^-8) of a p or ds times
# an input of |x| <= ~5 (chip_smoke.py's BWD_ATOL / BWD_RTOL).
BWD_BF16_TOL = dict(atol=4e-3, rtol=1e-2)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's hand-written kernels)")
    return torch.Generator(device="cuda").manual_seed(0)


def rand(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize(
    "dtype,qdtype,g,n,hd,ps,lengths",
    [
        # 384 = capacity: the commit clamps to the last slot
        (torch.bfloat16, torch.bfloat16, 8, 3, 60, 128, [0, 1, 127, 128, 129, 384]),
        # long and ragged: up to 32 tiles a row combined in the kernel, 4096 at capacity
        (torch.bfloat16, torch.bfloat16, 8, 3, 60, 128, [0, 1, 128, 129, 2047, 4096]),
        (torch.bfloat16, torch.bfloat16, 8, 3, 60, 256, [0, 255, 256, 257, 1000]),
        (torch.bfloat16, torch.float32, 8, 3, 60, 128, [0, 129, 700]),  # fp32 q, bf16 pool
        (torch.float32, torch.float32, 2, 1, 12, 128, [5, 200, 0]),
        (torch.bfloat16, torch.bfloat16, 1, 8, 128, 256, [255, 256, 511]),
        (torch.bfloat16, torch.bfloat16, 2, 8, 128, 128, [0, 130, 1500]),
        (torch.float32, torch.float32, 4, 2, 64, 128, [300, 17]),
        (torch.float32, torch.bfloat16, 4, 2, 64, 128, [300, 17]),  # bf16 q, fp32 pool
    ],
)
def test_paged_decode_commit_matches_plain(gen, dtype, qdtype, g, n, hd, ps, lengths):
    """K1 and K1' against the tiled plain version: output (in q's dtype),
    the committed pool bit-equal; K1' writes nothing.  Either side of a
    bf16 pool rounds p to bf16, and their fp32 p differ in the last bits
    (sums in another order), which now and then flips one rounding: an fp32
    output over a bf16 pool is held to the bf16 tolerance."""
    tol = TOL[torch.float32 if dtype == qdtype == torch.float32 else torch.bfloat16]
    b = len(lengths)
    pps = -(-max(lengths + [1]) // ps)
    hdp = -(-hd // 8) * 8
    pool = rand(gen, 3, b * pps, 2, g, ps, hdp, dtype=dtype)
    pool[..., hd:] = 0
    table = torch.randperm(b * pps, generator=gen, device="cuda").to(torch.int32)
    table = table.reshape(b, pps)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = rand(gen, b, g * n, hd, dtype=qdtype)
    kc, vc = rand(gen, b, g, hd, dtype=qdtype), rand(gen, b, g, hd, dtype=qdtype)
    pk, pp = pool.clone(), pool.clone()
    n0 = da.paged_decode_attention_commit.launches
    out = da.paged_decode_attention_commit(q, pk, 2, table, lens, scale=0.2,
                                           k_cur=kc, v_cur=vc)
    ref = da.paged_decode_attention_ref(q, pp[2], table, lens, scale=0.2,
                                        k_cur=kc, v_cur=vc)
    da.PagedKVCache(pp, table, lens).append_token(2, kc, vc)
    torch.cuda.synchronize()
    assert da.paged_decode_attention_commit.launches == n0 + 1
    assert out.dtype == qdtype
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    assert torch.equal(pk, pp)
    # K1' (no commit) writes nothing; it attends the committed pool, whose
    # clamped slot changed for a row at capacity
    before = pk.clone()
    out2 = da.paged_decode_attention(q, pk, 2, table, lens, scale=0.2,
                                     k_cur=kc, v_cur=vc)
    ref2 = da.paged_decode_attention_ref(q, pp[2], table, lens, scale=0.2,
                                         k_cur=kc, v_cur=vc)
    torch.cuda.synchronize()
    assert torch.equal(before, pk)
    torch.testing.assert_close(out2.float(), ref2.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_paged_decode_repeats_bit_equal_and_clamps_past_capacity(gen, dtype):
    """Three calls on the same inputs give equal bits (the per-row counters
    reset, the tiles combine in tile order, not arrival order), as do
    strided q / k_cur / v_cur views; rows past the table's capacity attend
    its whole capacity and commit into the last slot, as the plain version
    does."""
    b, g, n, hd, ps, pps = 5, 8, 3, 60, 128, 6
    lengths = [900, 768, 767, 2000, 129]  # capacity 768: two rows past it
    c = da.PagedKVCache.create(3, b * pps, ps, g, hd, page_size=ps, dtype=dtype,
                               device="cuda")
    hist = rand(gen, 3, b * pps * ps, 2, g, hd)
    if dtype == torch.int8:
        q8, sc = da.quantize_kv(hist)
        c.kv_pages[..., :hd] = q8.reshape(3, b * pps, ps, 2, g, hd).permute(0, 1, 3, 4, 2, 5)
        c.kv_scales[:] = sc.reshape(3, b * pps, ps, 2, g).permute(0, 1, 3, 4, 2)
    else:
        c.kv_pages[..., :hd] = hist.reshape(3, b * pps, ps, 2, g, hd).permute(
            0, 1, 3, 4, 2, 5).to(dtype)
    table = torch.randperm(b * pps, generator=gen, device="cuda").to(torch.int32)
    table = table.reshape(b, pps)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    qkv = rand(gen, b, g * (n + 2), hd, dtype=torch.bfloat16)  # one fused projection
    q, kc, vc = qkv[:, :g * n], qkv[:, g * n:g * (n + 1)], qkv[:, g * (n + 1):]
    assert not q.is_contiguous() and not kc.is_contiguous()
    runs = []
    for _ in range(3):
        pk = c.kv_pages.clone()
        sk = c.kv_scales.clone() if c.quantized else None
        runs.append((da.paged_decode_attention_commit(
            q, pk, 1, table, lens, scale=0.2, k_cur=kc, v_cur=vc, kv_scales=sk), pk, sk))
    torch.cuda.synchronize()
    for out, pk, sk in runs[1:]:
        assert torch.equal(out, runs[0][0]) and torch.equal(pk, runs[0][1])
        assert sk is None or torch.equal(sk, runs[0][2])
    out_c = da.paged_decode_attention_commit(
        q.contiguous(), c.kv_pages.clone(), 1, table, lens, scale=0.2,
        k_cur=kc.contiguous(), v_cur=vc.contiguous(),
        kv_scales=c.kv_scales.clone() if c.quantized else None)
    assert torch.equal(out_c, runs[0][0])
    sc_l = c.kv_scales[1] if c.quantized else None
    ref = da.paged_decode_attention_ref(q, c.kv_pages[1], table, lens, scale=0.2,
                                        k_cur=kc, v_cur=vc, kv_scales=sc_l)
    torch.testing.assert_close(out_c.float(), ref.float(), **TOL[torch.bfloat16])
    da.PagedKVCache(c.kv_pages, table, lens, c.kv_scales).append_token(1, kc, vc)
    assert torch.equal(runs[0][1], c.kv_pages)
    if c.quantized:
        torch.testing.assert_close(runs[0][2], c.kv_scales, rtol=1e-6, atol=0)


def test_paged_decode_on_two_streams_at_once(gen):
    """Calls on two streams that overlap on the card: each stream keeps its
    own per-row counters, so every output equals the same call made alone
    (a shared counter would combine rows before all their tiles arrived)."""
    b, g, n, hd, ps, pps = 6, 8, 3, 60, 128, 8
    pool = rand(gen, 2, b * pps, 2, g, ps, 64, dtype=torch.bfloat16)
    pool[..., hd:] = 0
    table = torch.randperm(b * pps, generator=gen, device="cuda").to(torch.int32)
    table = table.reshape(b, pps)
    lens = torch.tensor([1000, 5, 129, 700, 1024, 300], dtype=torch.int32, device="cuda")
    args = [[rand(gen, b, g * k, hd, dtype=torch.bfloat16) for k in (n, 1, 1)]
            for _ in range(2)]

    def call(q, kc, vc):
        return da.paged_decode_attention(q, pool, 1, table, lens, scale=0.2,
                                         k_cur=kc, v_cur=vc)

    want = [call(*a) for a in args]
    streams = [torch.cuda.Stream() for _ in args]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(call(*args[i]))
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        for out in got:
            assert torch.equal(out, want[i])


@pytest.mark.parametrize(
    "qdtype,g,n,hd,ps,lengths",
    [
        (torch.bfloat16, 8, 3, 60, 128, [0, 1, 127, 128, 129, 384]),  # 384 = capacity
        (torch.bfloat16, 8, 3, 60, 128, [0, 1, 128, 129, 2047, 4096]),  # up to 32 tiles
        (torch.bfloat16, 8, 3, 60, 256, [0, 255, 256, 257, 1000]),
        (torch.float32, 2, 1, 12, 128, [5, 200, 0]),
        (torch.float32, 1, 8, 128, 256, [255, 256, 511]),
        (torch.float32, 2, 8, 128, 128, [0, 130, 1500]),
        (torch.bfloat16, 4, 2, 40, 128, [300, 17]),  # hd 40 pads to 48
    ],
)
def test_paged_decode_int8_commit_matches_plain(gen, qdtype, g, n, hd, ps, lengths):
    """K4 against its plain version: output within fp32 rounding (bf16 cases
    round it once more), the committed int8 pool byte-equal and the scales
    equal to the plain append's (quantize_kv)."""
    b = len(lengths)
    pps = -(-max(lengths + [1]) // ps)
    c = da.PagedKVCache.create(3, b * pps, ps, g, hd, page_size=ps, dtype=torch.int8,
                               device="cuda")
    hist = rand(gen, 3, b * pps * ps, 2, g, hd)
    q8, sc = da.quantize_kv(hist)  # every slot written, stale ones included
    c.kv_pages[..., :hd] = q8.reshape(3, b * pps, ps, 2, g, hd).permute(0, 1, 3, 4, 2, 5)
    c.kv_scales[:] = sc.reshape(3, b * pps, ps, 2, g).permute(0, 1, 3, 4, 2)
    table = torch.randperm(b * pps, generator=gen, device="cuda").to(torch.int32)
    table = table.reshape(b, pps)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = rand(gen, b, g * n, hd, dtype=qdtype)
    kc, vc = rand(gen, b, g, hd, dtype=qdtype), rand(gen, b, g, hd, dtype=qdtype)
    pk, pp = c.kv_pages.clone(), c.kv_pages.clone()
    sk, sp = c.kv_scales.clone(), c.kv_scales.clone()
    n0 = da.paged_decode_attention_commit_int8.launches
    out = da.paged_decode_attention_commit(q, pk, 2, table, lens, scale=0.2,
                                           k_cur=kc, v_cur=vc, kv_scales=sk)
    ref = da.paged_decode_attention_ref(q, pp[2], table, lens, scale=0.2,
                                        k_cur=kc, v_cur=vc, kv_scales=sp[2])
    da.PagedKVCache(pp, table, lens, sp).append_token(2, kc, vc)
    torch.cuda.synchronize()
    assert da.paged_decode_attention_commit_int8.launches == n0 + 1
    assert out.dtype == qdtype
    torch.testing.assert_close(out.float(), ref.float(), **TOL[qdtype])
    assert torch.equal(pk, pp)
    torch.testing.assert_close(sk, sp, rtol=1e-6, atol=0)
    # K4 without the commit writes nothing
    before, before_s = pk.clone(), sk.clone()
    n1 = da.paged_decode_attention_int8.launches
    out2 = da.paged_decode_attention(q, pk, 2, table, lens, scale=0.2, k_cur=kc,
                                     v_cur=vc, kv_scales=sk)
    ref2 = da.paged_decode_attention_ref(q, pp[2], table, lens, scale=0.2, k_cur=kc,
                                         v_cur=vc, kv_scales=sp[2])
    torch.cuda.synchronize()
    assert da.paged_decode_attention_int8.launches == n1 + 1
    assert torch.equal(before, pk) and torch.equal(before_s, sk)
    torch.testing.assert_close(out2.float(), ref2.float(), **TOL[qdtype])


@pytest.mark.parametrize("overlap", [False, True])
def test_int8_engine_on_the_card_matches_the_cpu(gen, overlap):
    """fp32 model, int8 KV pages: the serving engine with prefix caching and
    a preemption gives the same greedy tokens on the card (K4) and on the
    CPU (plain version); with overlap_scheduling the card queues each block
    before it reads the previous one (pinned copies, one stream's order)."""
    from vats_tpu_torch.configs import ModelArgs
    from vats_tpu_torch.inference import ServingEngine
    from vats_tpu_torch.models import TextLM

    cfg = ModelArgs(d_model=64, num_heads=4, query_groups=2, d_ffn=128, num_layers=2,
                    dropout=0.0, vocab_size=128, max_seq_len=512, left_window=-1,
                    num_experts=1, top_k=1, dtype="float32", use_mqa=False,
                    gradient_checkpointing=False)
    gpu = TextLM(cfg, device="cuda", seed=3).eval()
    cpu = TextLM(cfg, device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, assign=True)
    sys_prompt = [(13 * i) % 120 + 1 for i in range(300)]
    stream = [(sys_prompt + [3, 1, 4], 12), ([(5 * i) % 120 + 1 for i in range(122)], 14),
              (sys_prompt + [2, 7, 1, 8], 6), ([7, 7, 23, 45], 5)]
    outs, engines = [], []
    n0 = da.paged_decode_attention_commit_int8.launches
    for model in (gpu, cpu):
        eng = ServingEngine(model, max_batch=2, max_context=512, prefix_caching=True,
                            total_pages=1 + 4, kv_quant="int8", decode_block_steps=2,
                            overlap_scheduling=overlap)
        rids = [eng.submit(p, max_new_tokens=n) for p, n in stream]
        out = eng.run()
        outs.append([out[r] for r in rids])
        engines.append(eng)
    assert engines[0].preemptions >= 1 and engines[0].prefix_cache.hit_tokens > 0
    assert outs[0] == outs[1]
    assert (da.paged_decode_attention_commit_int8.launches - n0
            == cfg.num_layers * engines[0].forwards["decode"])


FLASH_CASES = [
    (torch.bfloat16, 60, dict(causal=True)),
    (torch.float32, 16, dict(causal=True, left_window=33)),
    (torch.float32, 100, dict(causal=False, left_window=40, right_window=9)),
    (torch.float32, 64, dict(causal=False)),
    (torch.float32, 32, dict(causal=True, q_pos_offset=70, s=200)),
    (torch.float32, 64, dict(causal=True, valid=True)),
    (torch.bfloat16, 64, dict(causal=True, segments=True)),
]


@pytest.mark.parametrize("dtype,hd,case", FLASH_CASES)
def test_flash_forward_matches_plain(gen, dtype, hd, case):
    b, t, hq, g = 2, 150, 6, 2
    case = dict(case)
    s = case.pop("s", t)
    q = rand(gen, b, t, hq, hd, dtype=dtype)
    k, v = rand(gen, b, s, g, hd, dtype=dtype), rand(gen, b, s, g, hd, dtype=dtype)
    kw = dict(scale=hd**-0.5, **case)
    if kw.pop("valid", False):
        valid = torch.rand((b, s), generator=gen, device="cuda") > 0.3
        valid[1, :9] = False  # causal rows 0..8 of batch row 1 attend nothing
        kw["kv_valid"] = valid
    if kw.pop("segments", False):
        seg = (torch.arange(t, device="cuda") // 37).expand(b, t).contiguous()
        kw["q_segment_ids"] = kw["kv_segment_ids"] = seg
    n0 = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, **kw)
    ref = fa.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    if "kv_valid" in kw:
        assert bool((out[1, :9] == 0).all())


@pytest.mark.parametrize("dtype,hd,case", FLASH_CASES)
def test_flash_lse_and_backward_match_plain(gen, dtype, hd, case):
    """K2' (output and row logsumexp) and K5a/K5b (dq, dk, dv from the saved
    statistics) against their plain versions; the fp32 backward differs
    only by the order of its sums (1e-4), the bf16 one by the roundings of
    p and ds that a sum in another order flips (BWD_BF16_TOL)."""
    b, t, hq, g = 2, 150, 6, 2
    case = dict(case)
    s = case.pop("s", t)
    q = rand(gen, b, t, hq, hd, dtype=dtype)
    k, v = rand(gen, b, s, g, hd, dtype=dtype), rand(gen, b, s, g, hd, dtype=dtype)
    do = rand(gen, b, t, hq, hd, dtype=dtype)
    kw = dict(scale=hd**-0.5, **case)
    masks = {}
    if kw.pop("valid", False):
        valid = torch.rand((b, s), generator=gen, device="cuda") > 0.3
        valid[1, :9] = False
        masks["kv_valid"] = valid
    if kw.pop("segments", False):
        seg = (torch.arange(t, device="cuda") // 37).expand(b, t).contiguous()
        masks["q_segment_ids"] = masks["kv_segment_ids"] = seg
    n0 = fa.flash_attention_lse.launches
    out, lse = fa.flash_attention_lse(q, k, v, **kw, **masks)
    ref, lse_ref = fa.flash_attention_lse_ref(q, k, v, **kw, **masks)
    torch.cuda.synchronize()
    assert fa.flash_attention_lse.launches == n0 + 1
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    if "kv_valid" in masks:
        assert bool((lse[1, :, :9] == 1e30).all())
    di = (do.float() * ref.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse_ref, di, masks.get("kv_valid"),
            masks.get("q_segment_ids"), masks.get("kv_segment_ids"))
    n1 = (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
    got = fa.flash_attention_bwd(*args, **kw)
    want = fa.flash_attention_bwd_ref(*args, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches) == (n1[0] + 1, n1[1] + 1)
    tol = BWD_BF16_TOL if dtype == torch.bfloat16 else dict(atol=1e-4, rtol=1e-4)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, **tol)


# Edges of the bf16 forward (128-row query tiles, 128-key tiles through a TMA
# ring): T and S off the tile with B = 3, every head dim, one and eight heads
# per group, S > T with an offset, windows across tile edges, a batch row
# with no valid key, and T = S = 2048 (16 key tiles for the last query tile).
FLASH_BF16_EDGES = {
    "ragged_b3": dict(b=3, t=200, s=333, hq=6, g=2, hd=64, kw=dict(causal=False)),
    "ragged_b3_causal": dict(b=3, t=333, s=333, hq=6, g=2, hd=60, kw=dict(causal=True)),
    "d32": dict(b=2, t=300, s=300, hq=4, g=2, hd=32, kw=dict(causal=True)),
    "d128": dict(b=2, t=300, s=300, hq=4, g=2, hd=128, kw=dict(causal=True)),
    "d128_bidirectional": dict(b=2, t=130, s=260, hq=4, g=4, hd=128, kw=dict(causal=False)),
    "one_head_per_group": dict(b=2, t=256, s=256, hq=4, g=4, hd=64, kw=dict(causal=True)),
    "eight_heads_per_group": dict(b=2, t=256, s=256, hq=8, g=1, hd=64,
                                  kw=dict(causal=True)),
    "offset_s_gt_t": dict(b=2, t=100, s=420, hq=6, g=2, hd=64,
                          kw=dict(causal=True, q_pos_offset=320)),
    "left_window_across_tiles": dict(b=2, t=400, s=400, hq=6, g=2, hd=64,
                                     kw=dict(causal=True, left_window=150)),
    "two_sided_window": dict(b=2, t=400, s=400, hq=6, g=2, hd=64,
                             kw=dict(causal=False, left_window=70, right_window=200)),
    "dead_batch_row": dict(b=3, t=200, s=200, hq=6, g=2, hd=64, kw=dict(causal=True),
                           dead_row=1),
    "long_2048": dict(b=2, t=2048, s=2048, hq=6, g=2, hd=64, kw=dict(causal=True)),
}


@pytest.mark.parametrize("name", sorted(FLASH_BF16_EDGES))
def test_flash_bf16_forward_edges(gen, name):
    """K2 and K2' (one body) against the plain version: the output within
    one bf16 ulp, the LSE to fp32 rounding, the same output with and without
    the LSE; a batch row with no valid key gives exactly 0 and 1e30."""
    c = FLASH_BF16_EDGES[name]
    b, t, s, hq, g, hd = (c[x] for x in ("b", "t", "s", "hq", "g", "hd"))
    q = rand(gen, b, t, hq, hd, dtype=torch.bfloat16)
    k = rand(gen, b, s, g, hd, dtype=torch.bfloat16)
    v = rand(gen, b, s, g, hd, dtype=torch.bfloat16)
    kw = dict(scale=hd**-0.5, **c["kw"])
    if "dead_row" in c:
        valid = torch.rand((b, s), generator=gen, device="cuda") > 0.2
        valid[c["dead_row"]] = False
        kw["kv_valid"] = valid
    n0 = (fa.flash_attention.launches, fa.flash_attention_lse.launches)
    out = fa.flash_attention(q, k, v, **kw)
    out_l, lse = fa.flash_attention_lse(q, k, v, **kw)
    ref, lse_ref = fa.flash_attention_lse_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_lse.launches) == (
        n0[0] + 1, n0[1] + 1)
    assert torch.equal(out, out_l)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16])
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    if "dead_row" in c:
        assert bool((out[c["dead_row"]] == 0).all())
        assert bool((lse[c["dead_row"]] == 1e30).all())


# Edges of the bf16 backward (K5b: 128 query rows a CTA, key tiles of 128,
# 64 at D = 128; K5a: 128 keys a CTA, query tiles of 64, 32 at D = 128): the
# forward's edges, and segments.
FLASH_BF16_BWD_EDGES = dict(
    FLASH_BF16_EDGES,
    segments=dict(b=2, t=300, s=300, hq=6, g=2, hd=64, kw=dict(causal=True), segments=True),
)


@pytest.mark.parametrize("name", sorted(FLASH_BF16_BWD_EDGES))
def test_flash_bf16_backward_edges(gen, name):
    """K5a and K5b against the plain backward (which rounds p and ds to bf16
    where the kernels do) from the plain forward's lse and di, one launch
    each; a batch row with no valid key gives dq = 0, and invalid keys dk =
    dv = 0, exactly."""
    c = FLASH_BF16_BWD_EDGES[name]
    b, t, s, hq, g, hd = (c[x] for x in ("b", "t", "s", "hq", "g", "hd"))
    q = rand(gen, b, t, hq, hd, dtype=torch.bfloat16)
    k = rand(gen, b, s, g, hd, dtype=torch.bfloat16)
    v = rand(gen, b, s, g, hd, dtype=torch.bfloat16)
    do = rand(gen, b, t, hq, hd, dtype=torch.bfloat16)
    kw = dict(scale=hd**-0.5, **c["kw"])
    masks = {}
    if "dead_row" in c:
        valid = torch.rand((b, s), generator=gen, device="cuda") > 0.2
        valid[c["dead_row"]] = False
        masks["kv_valid"] = valid
    if c.get("segments"):
        seg = (torch.arange(t, device="cuda") // 45).expand(b, t).contiguous()
        masks["q_segment_ids"] = masks["kv_segment_ids"] = seg
    o, lse = fa.flash_attention_lse_ref(q, k, v, **kw, **masks)
    di = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, di, masks.get("kv_valid"), masks.get("q_segment_ids"),
            masks.get("kv_segment_ids"))
    n0 = (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
    got = fa.flash_attention_bwd(*args, **kw)
    want = fa.flash_attention_bwd_ref(*args, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches) == (n0[0] + 1, n0[1] + 1)
    for a, b_ in zip(got, want):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b_, **BWD_BF16_TOL)
    if "dead_row" in c:
        r = c["dead_row"]
        assert bool((got[0][r] == 0).all())
        assert bool((got[1][~valid] == 0).all()) and bool((got[2][~valid] == 0).all())


def test_flash_attention_autograd_on_the_card(gen):
    """flash_attention with a gradient goes through K2', K5a and K5b and
    gives the plain attention's gradients (fp32, head dim 60 padded)."""
    from vats_tpu_torch.ops.attention_ref import dot_product_attention

    q = rand(gen, 2, 140, 6, 60).requires_grad_()
    k, v = rand(gen, 2, 140, 2, 60).requires_grad_(), rand(gen, 2, 140, 2, 60).requires_grad_()
    kw = dict(scale=0.13, causal=True, left_window=50)
    n0 = (fa.flash_attention_lse.launches, fa.flash_bwd_dkv.launches,
          fa.flash_bwd_dq.launches)
    g1 = torch.autograd.grad((fa.flash_attention(q, k, v, **kw) ** 2).sum(), (q, k, v))
    g2 = torch.autograd.grad((dot_product_attention(q, k, v, **kw) ** 2).sum(), (q, k, v))
    assert (fa.flash_attention_lse.launches, fa.flash_bwd_dkv.launches,
            fa.flash_bwd_dq.launches) == tuple(n + 1 for n in n0)
    for a, b_ in zip(g1, g2):
        torch.testing.assert_close(a, b_, atol=1e-4, rtol=1e-4)


def test_tiny_train_steps_on_the_card_match_the_cpu(gen):
    """Three fp32 train steps (flash attention with K2'/K5, remat 'dots',
    fused CE, bf16 mu, dropout 0: a card generator's masks are not the
    CPU's) on the card against the CPU from the same weights: losses and
    params agree to fp32 rounding (atol 2e-5 on O(1) losses)."""
    from vats_tpu_torch.configs import ModelArgs, TrainingArgs
    from vats_tpu_torch.models import TextLM
    from vats_tpu_torch.train import create_optimizer, create_train_state, make_train_step

    cfg = ModelArgs(d_model=64, num_heads=4, query_groups=2, d_ffn=128, num_layers=2,
                    dropout=0.0, vocab_size=97, max_seq_len=320, left_window=-1,
                    num_experts=4, top_k=2, capacity_factor=1.25, dtype="float32",
                    attention_impl="flash", gradient_checkpointing=True,
                    remat_policy="dots")
    targs = TrainingArgs(grad_accum_steps=1, fused_ce_chunk=64, adam_mu_dtype="bfloat16")
    gpu = TextLM(cfg, device="cuda", seed=3)
    cpu = TextLM(cfg, device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, assign=True)
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(1, 97, (2, 260), generator=g, dtype=torch.int32)
    labels = torch.cat([ids[:, 1:], torch.full((2, 1), -100, dtype=torch.int32)], 1)
    batch = {"input_ids": ids, "labels": labels}
    runs = [(m, create_train_state(m, create_optimizer(targs, 10)), make_train_step(m, targs))
            for m in (gpu, cpu)]
    n0 = fa.flash_attention_lse.launches
    for i in range(3):
        (_, sg, fg), (_, sc, fc) = runs
        sg, mg = fg(sg, {k: v.cuda() for k, v in batch.items()}, 7 + i)
        sc, mc = fc(sc, batch, 7 + i)
        torch.testing.assert_close(mg["loss"].cpu(), mc["loss"], atol=2e-5, rtol=1e-5)
    # per step: one forward and one recompute of each layer's attention
    assert fa.flash_attention_lse.launches == n0 + 3 * 2 * cfg.num_layers
    for a, b_ in zip(gpu.parameters(), cpu.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b_.detach(), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pos", [0, 99, 100, 250])  # S = 100: 100 and 250 clamp
def test_cache_append_matches_plain(gen, dtype, pos):
    k, v = rand(gen, 3, 2, 4, 16, 100, dtype=dtype), rand(gen, 3, 2, 4, 16, 100, dtype=dtype)
    kn, vn = rand(gen, 2, 4, 16, dtype=dtype), rand(gen, 2, 4, 16, dtype=dtype)
    length = torch.tensor(pos, dtype=torch.int32, device="cuda")
    ka, va, kb, vb = k.clone(), v.clone(), k.clone(), v.clone()
    ca.append_token_inplace(ka, va, 1, kn, vn, length)
    ca.append_token_ref(kb, vb, 1, kn, vn, length)
    torch.cuda.synchronize()
    assert torch.equal(ka, kb) and torch.equal(va, vb)


def rotated_ulps(got, want, mantissa_bits):
    """|got - want| in ulps of the model dtype at each element's rotated pair
    magnitude sqrt(r1^2 + r2^2): a rounding difference in the normalised
    pair (n1, n2) reaches both rotated elements, however small one is."""
    got, want = got.float(), want.float()
    pm = torch.sqrt(want[..., 0::2] ** 2 + want[..., 1::2] ** 2).repeat_interleave(2, -1)
    ulp = torch.exp2(torch.floor(torch.log2(pm.clamp(min=2.0 ** -126))) - mantissa_bits)
    return (got - want).abs() / ulp


# The prologue against its plain version (the unfused chain) on the card:
# the same fp32 ops in the same order, but for the sum of squares of the
# QK-norm, whose order differs.  bf16 rounds n before the rotation, so a
# difference shows only where it flips that rounding: one bf16 ulp at the
# pair's magnitude.  fp32 keeps it: the norm moves by an ulp, each of n1, n2
# by up to two, and the rotation sums both (4 fp32 ulps at the pair's
# magnitude).  Without the norm the ops are the same: one ulp.
PROLOGUE_ULPS = {(torch.bfloat16, True): 1, (torch.bfloat16, False): 1,
                 (torch.float32, True): 4, (torch.float32, False): 1}


@pytest.mark.parametrize("b", [1, 16, 32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["dense", "ring", "paged"])
def test_decode_prologue_matches_plain(gen, mode, dtype, b):
    """K3's fused prologue at nlp_medium's heads (24 / 8 of 60, stored as
    64): q and k within PROLOGUE_ULPS of the plain chain, v and every pad
    lane exact, every cache element outside the written column unchanged;
    fused and split projections, with and without the QK-norm."""
    from vats_tpu_torch.nn.rope import rope_inv_freq

    hq, g, hd, hdp, L, S = 24, 8, 60, 64, 3, 544
    inv_freq = rope_inv_freq(hd, 10000.0, device="cuda")
    cache = rand(gen, 2, L, b, g, hdp, S, dtype=dtype)
    equal = total = 0
    for qk_norm, fused, pos in ((True, True, 0), (True, False, 127), (False, True, S - 1),
                                (True, True, S + 7), (False, False, 300)):
        row = rand(gen, b, 1, (hq + 2 * g) * hd, dtype=dtype)
        q, k, v = torch.split(row, [hq * hd, g * hd, g * hd], dim=-1)
        q, k, v = q.reshape(b, 1, hq, hd), k.reshape(b, 1, g, hd), v.reshape(b, 1, g, hd)
        if not fused:  # three tensors, as three projections give them
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        kw = dict(theta=10000.0, qk_norm=qk_norm)
        tol = PROLOGUE_ULPS[(dtype, qk_norm)]
        if mode == "paged":
            lengths = torch.randint(0, 4096, (b,), generator=gen, device="cuda")
            lengths[0] = pos
            lengths = lengths.to(torch.int32)
            n0 = ca.paged_decode_prologue.launches
            got = ca.paged_decode_prologue(q, k, v, lengths, inv_freq, **kw)
            want = ca.paged_decode_prologue_ref(q, k, v, lengths, **kw)
            torch.cuda.synchronize()
            assert ca.paged_decode_prologue.launches == n0 + 1
            for x, y in zip(got[:2], want[:2]):
                assert float(rotated_ulps(x, y, 7 if dtype == torch.bfloat16 else 23).max()) <= tol
                equal += int((x == y).sum())
                total += x.numel()
            assert torch.equal(got[2], want[2])
            continue
        length = torch.tensor(pos, dtype=torch.int32, device="cuda")
        ka, va = cache[0].clone(), cache[1].clone()
        kb, vb = cache[0].clone(), cache[1].clone()
        n0 = ca.dense_decode_prologue.launches
        got = ca.dense_decode_prologue(q, k, v, ka, va, length, 1, inv_freq, ring=mode == "ring",
                                       **kw)
        want = ca.dense_decode_prologue_ref(q, k, v, kb, vb, length, 1, ring=mode == "ring",
                                            **kw)
        torch.cuda.synchronize()
        assert ca.dense_decode_prologue.launches == n0 + 1
        col = pos % S if mode == "ring" else min(pos, S - 1)
        bits = 7 if dtype == torch.bfloat16 else 23
        assert float(rotated_ulps(got[..., :hd], want[..., :hd], bits).max()) <= tol
        assert float(rotated_ulps(ka[1, ..., :hd, col], kb[1, ..., :hd, col], bits).max()) <= tol
        assert not got[..., hd:].any() and not ka[1, :, :, hd:, col].any()
        assert torch.equal(va, vb)
        outside = torch.ones(S, dtype=torch.bool, device="cuda")
        outside[col] = False
        assert torch.equal(ka[..., outside], cache[0][..., outside])
        assert torch.equal(ka[0], cache[0][0]) and torch.equal(ka[2], cache[0][2])
        equal += int((got == want).sum()) + int((ka[1, ..., col] == kb[1, ..., col]).sum())
        total += got.numel() + ka[1, ..., col].numel()
    print(f"decode prologue {mode} {dtype} B={b}: {equal / total:.6f} of q and k bit-equal")


def test_prologue_rejects_bad_inputs(gen):
    """No fallback on the card: an input that requires grad, a q of two
    tokens, or an int64 length raises."""
    from vats_tpu_torch.nn.rope import rope_inv_freq

    inv = rope_inv_freq(12, 10000.0, device="cuda")
    q, k = rand(gen, 2, 1, 4, 12), rand(gen, 2, 1, 2, 12)
    lengths = torch.tensor([3, 9], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="requires grad"):
        ca.paged_decode_prologue(q.requires_grad_(), k, k, lengths, inv, theta=1e4,
                                 qk_norm=True)
    with pytest.raises(ValueError, match="one token"):
        ca.paged_decode_prologue(rand(gen, 2, 2, 4, 12), k, k, lengths, inv, theta=1e4,
                                 qk_norm=True)
    with pytest.raises(ValueError, match="int32"):
        ca.paged_decode_prologue(rand(gen, 2, 1, 4, 12), k, k, lengths.long(), inv,
                                 theta=1e4, qk_norm=True)


def test_wrappers_reject_bad_inputs(gen):
    k = rand(gen, 1, 2, 2, 8, 16)
    kn = rand(gen, 2, 2, 8)
    with pytest.raises(ValueError, match="int32"):
        ca.append_token_inplace(k, k.clone(), 0, kn, kn,
                                torch.tensor(1, device="cuda"))  # int64 length
    with pytest.raises(ValueError, match="contiguous"):
        ca.append_token_inplace(k, k.clone(), 0, kn.transpose(0, 1).contiguous()
                                .transpose(0, 1), kn,
                                torch.tensor(1, dtype=torch.int32, device="cuda"))


@pytest.mark.parametrize("left_window", [-1, 100])  # 100: dense ring cache
def test_tiny_model_on_the_card_matches_the_cpu(gen, left_window):
    """fp32 end to end: paged prefill (through K2 via attention_impl='flash')
    and decode (K3's paged prologue, K1), dense decode (K3's dense prologue;
    a ring cache when windowed), on the card against the plain versions on
    the CPU."""
    from vats_tpu_torch.configs import ModelArgs
    from vats_tpu_torch.inference import generate, generate_paged
    from vats_tpu_torch.models import TextLM

    cfg = ModelArgs(d_model=64, num_heads=4, query_groups=2, d_ffn=128,
                    num_layers=2, dropout=0.0, vocab_size=97, max_seq_len=320,
                    left_window=left_window, num_experts=4, top_k=2,
                    capacity_factor=1.25,
                    dtype="float32", attention_impl="flash")
    gpu = TextLM(cfg, device="cuda", seed=3).eval()
    cpu = TextLM(cfg, device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, assign=True)
    ids = torch.randint(1, 97, (2, 260), generator=torch.Generator().manual_seed(1))
    mask = torch.arange(260)[None, :] < torch.tensor([[260], [201]])
    ids = torch.where(mask, ids, 0)
    kw = dict(max_new_tokens=6, do_sample=False, temperature=0.0, pad_token_id=0)
    counts = (fa.flash_attention.launches, da.paged_decode_attention_commit.launches,
              ca.dense_decode_prologue.launches, ca.paged_decode_prologue.launches)
    for fn in (generate_paged, generate):
        tc, lc = fn(cpu, ids, mask, None, **kw)
        tg, lg = fn(gpu, ids.cuda(), mask.cuda(), None, **kw)
        assert torch.equal(lc, lg.cpu())
        assert torch.equal(tc, tg.cpu())
    # the paged prefill takes K2; so does the dense ring prefill when windowed
    prefills = 2 if left_window > 0 else 1
    assert fa.flash_attention.launches == counts[0] + prefills * cfg.num_layers
    assert da.paged_decode_attention_commit.launches == counts[1] + 6 * cfg.num_layers
    assert ca.dense_decode_prologue.launches == counts[2] + 6 * cfg.num_layers
    assert ca.paged_decode_prologue.launches == counts[3] + 6 * cfg.num_layers


def test_fused_ce_bf16_on_the_card_matches_the_cpu(gen):
    """The bf16 readout product with fp32 logits: one GEMM with fp32 output
    on the card, upcast operands on the CPU; both sum exact bf16 products in
    fp32 (in another order), so the loss agrees to fp32 rounding and each
    bf16-rounded gradient to a bf16 ulp of its largest element."""
    from vats_tpu_torch.train.metrics import fused_linear_cross_entropy

    hidden = rand(gen, 2, 70, 96)
    readout = 0.3 * rand(gen, 500, 96)
    labels = torch.randint(0, 500, (2, 70), generator=gen, device="cuda")
    labels[0, -9:] = -100
    res = []
    for dev in ("cuda", "cpu"):
        h = hidden.to(dev).requires_grad_()
        w = readout.to(dev).requires_grad_()
        loss = fused_linear_cross_entropy(h, w, labels.to(dev), chunk=32,
                                          compute_dtype=torch.bfloat16)
        res.append((loss, *torch.autograd.grad(loss, (h, w))))
    (lg, *gg), (lc, *gc) = res
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=0)
    for a, b_ in zip(gg, gc):
        torch.testing.assert_close(a.cpu(), b_, rtol=0, atol=1e-2 * float(b_.abs().max()))
