"""The port's CUDA kernels against their plain PyTorch versions, and the
card against the CPU, on the card.

These need an NVIDIA GPU and ``nvcc``; without them every test here skips.
They hold each kernel at the main path's shapes and off it (odd head dims,
one or eight heads per group, fp32 pools, windows, offsets), tiny fp32
models card against CPU to fp32 rounding, and two layers of each model at
full width in bf16 card against CPU (``torch_card_parity``'s limits).  This
file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances (``torch_card_parity``, which ``chip_smoke.py``'s kernel rows
share): fp32 kernels against fp32 plain versions 2e-5 (sums in another
order); bf16 outputs one bf16 ulp (rtol 1e-2) plus 2e-3 absolute.  Committed
pools and caches must be bit-equal.
"""

import pytest
import torch

from torch_card_parity import (
    BWD_BF16_TOL,
    PROLOGUE_ULPS,
    TOL,
    check_paged_prefill,
    check_routed_experts,
    p_flip_allowance,
    rotated_ulps,
)
from vats_tpu_torch.ops import cache_append as ca
from vats_tpu_torch.ops import decode_attention as da
from vats_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

# nlp_medium's serving batch (B=32, capacity 640: the last row clamps) and
# code_chat_8k's decode (Mellum2: 64 rows of 1k-8k tokens, at the window's
# and the tiles' edges first, one at capacity)
SERVING_LENGTHS = [0, 1, 127, 128, 576, 640] + list(range(5, 576, 22))
CODE_CHAT_LENGTHS = ([1023, 1024, 1025, 1151, 1152, 1153, 2047, 4096, 8191]
                     + list(range(1100, 8192, 129)))


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
        (torch.bfloat16, torch.bfloat16, 8, 3, 60, 128, SERVING_LENGTHS),
        (torch.bfloat16, torch.bfloat16, 4, 8, 128, 128, CODE_CHAT_LENGTHS),  # a full layer
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_paged_decode_rows_sharing_a_slot_commit_the_last_row(gen, dtype):
    """Rows parked on one scratch page (the serving engine's idle rows, all
    at one length) commit into the same slot with different values: the
    highest row's value lands, as a loop over the rows would write it, in
    every one of 20 calls whatever order their CTAs end in; the rows with
    pages of their own commit as before."""
    b, g, n, hd, ps, pps = 32, 8, 3, 64, 128, 2
    c = da.PagedKVCache.create(2, 1 + b * pps, ps, g, hd, page_size=ps, dtype=dtype,
                               device="cuda")
    hist = rand(gen, 2, (1 + b * pps) * ps, 2, g, hd)
    if dtype == torch.int8:
        q8, sc = da.quantize_kv(hist)
        c.kv_pages[..., :hd] = q8.reshape(2, 1 + b * pps, ps, 2, g, hd).permute(
            0, 1, 3, 4, 2, 5)
        c.kv_scales[:] = sc.reshape(2, 1 + b * pps, ps, 2, g).permute(0, 1, 3, 4, 2)
    else:
        c.kv_pages[..., :hd] = hist.reshape(2, 1 + b * pps, ps, 2, g, hd).permute(
            0, 1, 3, 4, 2, 5).to(dtype)
    table = (1 + torch.arange(b * pps, device="cuda", dtype=torch.int32)).reshape(b, pps)
    idle = torch.arange(b, device="cuda") % 3 != 0  # two rows in three on page 0
    table[idle] = 0
    lens = torch.where(idle, 2, torch.randint(0, pps * ps, (b,), generator=gen,
                                              device="cuda")).to(torch.int32)
    q = rand(gen, b, g * n, hd, dtype=torch.bfloat16)
    kc, vc = rand(gen, b, g, hd, dtype=torch.bfloat16), rand(gen, b, g, hd, dtype=torch.bfloat16)
    want_p, want_s = c.kv_pages.clone(), c.kv_scales.clone() if c.quantized else None
    for r in range(b):  # one row at a time: the last writer of a slot wins
        da.PagedKVCache(want_p, table[r:r + 1], lens[r:r + 1], want_s).append_token(
            1, kc[r:r + 1], vc[r:r + 1])
    runs = []
    for _ in range(20):
        pk = c.kv_pages.clone()
        sk = c.kv_scales.clone() if c.quantized else None
        da.paged_decode_attention_commit(q, pk, 1, table, lens, scale=0.2, k_cur=kc,
                                         v_cur=vc, kv_scales=sk)
        runs.append((pk, sk))
    torch.cuda.synchronize()
    for pk, sk in runs:
        assert torch.equal(pk, want_p)
        if sk is not None:  # scales as in the int8 commit test above
            assert torch.equal(sk, runs[0][1])
            torch.testing.assert_close(sk, want_s, rtol=1e-6, atol=0)


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
        (torch.bfloat16, 8, 3, 60, 128, SERVING_LENGTHS),
        (torch.float32, 8, 3, 60, 128, SERVING_LENGTHS),
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
    # nlp_medium's heads (24 / 8 of 60): a prefill batch, medium_dense's
    # train batch, and a shard of the 2-rank ring over 4096 tokens
    "nlp_medium_b8_t512": dict(b=8, t=512, s=512, hq=24, g=8, hd=60, kw=dict(causal=True)),
    "medium_dense_b16_t512": dict(b=16, t=512, s=512, hq=24, g=8, hd=60,
                                  kw=dict(causal=True)),
    "nlp_medium_t2048": dict(b=2, t=2048, s=2048, hq=24, g=8, hd=60, kw=dict(causal=True)),
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


# A key mask, segments and a left window at once, at head dim 60, where the
# first queries of a segment or a window attend one or two keys and a
# flipped rounding of p moves the output by more than one bf16 ulp: at
# nlp_medium's prefill width (10% of the keys invalid, a segment ending after
# 3% of the tokens) and at a small shape (segments of 45)
FLASH_MASKED = {
    "nlp_medium_b8_t512": dict(b=8, t=512, hq=24, g=8, left_window=100, invalid=0.1),
    "b2_t200_segments_of_45": dict(b=2, t=200, hq=6, g=2, left_window=70, invalid=0.2,
                                   segment_len=45),
}


@pytest.mark.parametrize("name", sorted(FLASH_MASKED))
def test_flash_bf16_masked_within_the_p_flip_allowance(gen, name):
    """K2 and K2' against the plain version within TOL plus the p flip
    allowance (``p_flip_allowance``), the lse to fp32 rounding; K5a and K5b
    from the plain forward's statistics within BWD_BF16_TOL.  Causal rows
    0-6 of batch row 1 attend no valid key: output 0, lse 1e30 and dq 0
    exactly; an invalid key gets dk = dv = 0 exactly."""
    c = FLASH_MASKED[name]
    b, t, hq, g, hd = c["b"], c["t"], c["hq"], c["g"], 60
    q, k, v, do = (rand(gen, b, t, h, hd, dtype=torch.bfloat16) for h in (hq, g, g, hq))
    valid = torch.rand((b, t), generator=gen, device="cuda") > c["invalid"]
    valid[1, :7] = False
    if "segment_len" in c:
        seg = (torch.arange(t, device="cuda") // c["segment_len"]).expand(b, t).contiguous()
    else:
        seg = torch.cumsum(torch.rand((b, t), generator=gen, device="cuda") > 0.97, 1)
    kw = dict(scale=hd**-0.5, causal=True, left_window=c["left_window"])
    masks = dict(kv_valid=valid, q_segment_ids=seg, kv_segment_ids=seg)
    n0 = (fa.flash_attention.launches, fa.flash_attention_lse.launches)
    out = fa.flash_attention(q, k, v, **kw, **masks)
    out_l, lse = fa.flash_attention_lse(q, k, v, **kw, **masks)
    ref, lse_ref = fa.flash_attention_lse_ref(q, k, v, **kw, **masks)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_lse.launches) == (
        n0[0] + 1, n0[1] + 1)
    limit = (TOL[torch.bfloat16]["atol"] + TOL[torch.bfloat16]["rtol"] * ref.float().abs()
             + p_flip_allowance(q, k, v, **kw, **masks))
    for got in (out, out_l):
        assert bool(((got.float() - ref.float()).abs() <= limit).all())
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    assert bool((out[1, :7] == 0).all()) and bool((lse[1, :, :7] == 1e30).all())
    di = (do.float() * ref.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse_ref, di, valid, seg, seg)
    got = fa.flash_attention_bwd(*args, **kw)
    want = fa.flash_attention_bwd_ref(*args, **kw)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, **BWD_BF16_TOL)
    assert bool((got[0][1, :7] == 0).all())
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


# K3's append mode: (cache [L, B, G, hd, S], positions; past S - 1 clamps):
# a small cache, nlp_medium's dense decode cache at B=16, and
# video_gen_xsmall's temporal cache at the JAX bench's B=2 (8 x 8 latents a
# frame, head dim 18 stored as 24, 5 latent frames)
CACHE_APPEND_CASES = {
    "small": ((3, 2, 4, 16, 100), (0, 99, 100, 250)),
    "nlp_medium_b16": ((20, 16, 8, 64, 544), (0, 127, 300, 543, 551)),
    "video_gen_xsmall_b2": ((4, 128, 4, 24, 5), (0, 2, 4, 7)),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(CACHE_APPEND_CASES))
def test_cache_append_matches_plain(gen, dtype, name):
    shape, positions = CACHE_APPEND_CASES[name]
    _, b, g, hd, _ = shape
    k, v = rand(gen, *shape, dtype=dtype), rand(gen, *shape, dtype=dtype)
    kn, vn = rand(gen, b, g, hd, dtype=dtype), rand(gen, b, g, hd, dtype=dtype)
    for pos in positions:
        length = torch.tensor(pos, dtype=torch.int32, device="cuda")
        ka, va, kb, vb = k.clone(), v.clone(), k.clone(), v.clone()
        n0 = ca.append_token_inplace.launches
        ca.append_token_inplace(ka, va, 1, kn, vn, length)
        ca.append_token_ref(kb, vb, 1, kn, vn, length)
        torch.cuda.synchronize()
        assert ca.append_token_inplace.launches == n0 + 1
        assert torch.equal(ka, kb) and torch.equal(va, vb), pos


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


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_packed_segments_isolate_documents_in_training(gen, dtype):
    """Segment isolation on the card, through the training path: a
    TokenShard packed with segment ids (the port's C packer), moved with
    ``device_batches``; one forward and backward (K2' with segment ids,
    K5a, K5b) and again with each row's first segment re-drawn.  The later
    segments come after the first, so causal attention alone would let
    them see it: only the segment mask keeps their logits from moving.
    Masked scores add exact zeros and the two runs are the same kernels on
    the same shapes, so they are bit-equal (held to one bf16 ulp, atol
    2e-3 rtol 1e-2, for bf16; 2e-5 for fp32)."""
    import numpy as np

    from vats_tpu_torch.configs import ModelArgs
    from vats_tpu_torch.data import device_batches
    from vats_tpu_torch.data.shard_dataset import ShardDataset, TokenShard
    from vats_tpu_torch.models import TextLM
    from vats_tpu_torch.train.metrics import compute_loss

    cfg = ModelArgs(d_model=128, num_heads=2, query_groups=1, d_ffn=256, num_layers=2,
                    dropout=0.0, vocab_size=97, max_seq_len=256, left_window=-1,
                    dtype=dtype, attention_impl="flash", gradient_checkpointing=True,
                    remat_policy="dots")
    rs = np.random.RandomState(2)
    lens = np.exp(rs.uniform(np.log(8), np.log(200), 40)).astype(int)
    docs = [rs.randint(1, 97, n).tolist() for n in lens]
    np_batch, _ = ShardDataset(TokenShard.from_documents(docs), 256).pack_sequences(0, 4)
    batch = next(device_batches(iter([np_batch]), "cuda"))
    segs = batch["segment_ids"]
    first, later = segs == 1, segs > 1
    assert int(later.any(1).sum()) >= 2
    model = TextLM(cfg, device="cuda", seed=1)

    def run(ids):
        logits, _, aux = model(ids, padding_mask=batch["padding_mask"], segment_ids=segs,
                               deterministic=False, dropout_seed=0)
        compute_loss(logits, batch["labels"], aux)[0].backward()
        return logits.detach().float()

    n0 = (fa.flash_attention_lse.launches, fa.flash_bwd_dkv.launches)
    out1 = run(batch["input_ids"])
    redraw = torch.randint(1, 97, segs.shape, generator=gen, device="cuda",
                           dtype=torch.int32)
    out2 = run(torch.where(first, redraw, batch["input_ids"]))
    assert (fa.flash_attention_lse.launches, fa.flash_bwd_dkv.launches) == (
        n0[0] + 2 * 2 * cfg.num_layers, n0[1] + 2 * cfg.num_layers)
    tol = TOL[torch.bfloat16 if dtype == "bfloat16" else torch.float32]
    torch.testing.assert_close(out2[later], out1[later], **tol)
    assert not torch.equal(out1[first], out2[first])


def test_async_checkpoint_of_a_card_state(gen, tmp_path):
    """``CheckpointManager(async_save=True)`` on the card: the state is
    copied to pinned host memory in stream order at the call, so a train
    step queued right after it (updating params and moments in place) does
    not reach the file; the restored state is bit-equal to the state at the
    call."""
    from vats_tpu_torch.checkpoint import CheckpointManager, load_checkpoint
    from vats_tpu_torch.checkpoint.manager import state_tree
    from vats_tpu_torch.configs import ModelArgs, TrainingArgs
    from vats_tpu_torch.data import synthetic_lm_batches
    from vats_tpu_torch.models import TextLM
    from vats_tpu_torch.train import create_optimizer, create_train_state, make_train_step

    cfg = ModelArgs(d_model=64, num_heads=4, query_groups=2, d_ffn=128, num_layers=2,
                    dropout=0.0, vocab_size=97, max_seq_len=64, dtype="bfloat16")
    targs = TrainingArgs(grad_accum_steps=2)

    def setup(seed):
        model = TextLM(cfg, device="cuda", seed=seed)
        return model, create_train_state(model, create_optimizer(targs, 10))

    model, state = setup(0)
    step = make_train_step(model, targs)
    batches = list(synthetic_lm_batches(gen, vocab_size=97, batch_size=2, seq_len=32,
                                        num_batches=2))
    state, _ = step(state, batches[0], 0)  # a mini-step: the accumulator is set
    want = state_tree(state, lambda t: t.clone())
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    saved = mgr.maybe_save(state, val_loss=1.0, force_regular=True)
    # the boundary step, in place, queued behind the copies: params move and
    # the accumulator is zeroed
    state, _ = step(state, batches[1], 1)
    mgr.close()
    assert not torch.equal(want["params"]["token_embed.weight"],
                           state.params["token_embed.weight"])
    for path in (saved["best"], saved["regular"]):
        _, fresh = setup(1)
        restored, _ = load_checkpoint(path, target=fresh)
        got = state_tree(restored)
        for name, t in want["params"].items():
            assert torch.equal(got["params"][name], t), name
        for name, t in want["opt_state"]["acc_grads"].items():
            assert torch.equal(got["opt_state"]["acc_grads"][name], t), name
        assert int(got["step"]) == 1 and got["opt_state"]["mini_step"] == 1


@pytest.mark.parametrize("b", [2, 16])  # 16: the vision phase's forward batch
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_at_vit2d_shape_matches_plain(gen, dtype, b):
    """K2, K2', K5a and K5b at ViT-2D medium's attention: head dim 72 (the
    wrappers pad it to 128), T = S = 576 (a ragged last 128-row tile),
    16 heads over 8 groups, non-causal, no mask; against the plain versions
    (bf16 as BWD_BF16_TOL and TOL; fp32 sums in another order, 1e-4)."""
    t, hq, g, hd = 576, 16, 8, 72
    q = rand(gen, b, t, hq, hd, dtype=dtype)
    k, v = rand(gen, b, t, g, hd, dtype=dtype), rand(gen, b, t, g, hd, dtype=dtype)
    do = rand(gen, b, t, hq, hd, dtype=dtype)
    kw = dict(scale=hd**-0.5, causal=False)
    n0 = [fn.launches for fn in (fa.flash_attention, fa.flash_attention_lse,
                                 fa.flash_bwd_dkv, fa.flash_bwd_dq)]
    out = fa.flash_attention(q, k, v, **kw)
    out_l, lse = fa.flash_attention_lse(q, k, v, **kw)
    ref, lse_ref = fa.flash_attention_lse_ref(q, k, v, **kw)
    di = (do.float() * ref.float()).sum(-1).transpose(1, 2).contiguous()
    got = fa.flash_attention_bwd(q, k, v, do, lse_ref, di, **kw)
    want = fa.flash_attention_bwd_ref(q, k, v, do, lse_ref, di, **kw)
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(
        (fa.flash_attention, fa.flash_attention_lse, fa.flash_bwd_dkv, fa.flash_bwd_dq),
        n0)] == [1, 1, 1, 1]
    assert out.shape == (b, t, hq, hd) and torch.equal(out, out_l)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    tol = BWD_BF16_TOL if dtype == torch.bfloat16 else dict(atol=1e-4, rtol=1e-4)
    for a, b_ in zip(got, want):
        assert a.shape[-1] == hd
        torch.testing.assert_close(a, b_, **tol)


def test_vit2d_two_layers_on_the_card_match_the_cpu(gen):
    """ViT-2D at medium width, 2 layers, fp32, remat on, B=2: the eval
    forward (K2 per layer) and the loss gradients (K2' twice per layer
    under remat, K5a and K5b once) on the card against the CPU's plain
    versions from the same weights: logits atol 1e-4, gradients atol 1e-4
    and rtol 1e-3 (fp32 sums in another order over 576 patches)."""
    from vats_tpu_torch.configs import vit2d_medium
    from vats_tpu_torch.models import ImageEncoder
    from vats_tpu_torch.train.vision import smoothed_ce

    cfg = vit2d_medium(num_layers=2, dropout=0.0, num_classes=10, dtype="float32",
                       use_checkpointing=True)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        gpu = ImageEncoder(cfg, device="cuda", seed=4)
        cpu = ImageEncoder(cfg, device="meta")
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, assign=True)
        x = torch.randn((2, 3, 400, 384), generator=torch.Generator().manual_seed(2))
        labels = torch.tensor([1, 7])
        n0 = fa.flash_attention.launches
        with torch.no_grad():
            lg = gpu(x.cuda())
        assert fa.flash_attention.launches == n0 + 2
        with torch.no_grad():
            torch.testing.assert_close(lg.cpu(), cpu(x), atol=1e-4, rtol=1e-4)
        n1 = (fa.flash_attention_lse.launches, fa.flash_bwd_dkv.launches,
              fa.flash_bwd_dq.launches)
        for model, dev in ((gpu, "cuda"), (cpu, "cpu")):
            loss = smoothed_ce(model(x.to(dev), deterministic=False, dropout_seed=0),
                               labels.to(dev), 0.1, 10)
            loss.backward()
        assert (fa.flash_attention_lse.launches - n1[0], fa.flash_bwd_dkv.launches - n1[1],
                fa.flash_bwd_dq.launches - n1[2]) == (4, 2, 2)
        for (name, a), b_ in zip(gpu.named_parameters(), cpu.parameters()):
            torch.testing.assert_close(a.grad.cpu(), b_.grad, atol=1e-4, rtol=1e-3, msg=name)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


# --- image generation: K3's table mode, K1 at head dim 24, the flash kernels
# at T = 4096, head dim 24 ----------------------------------------------------


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["dense", "ring", "paged"])
def test_decode_prologue_table_mode_matches_plain(gen, mode, dtype, b):
    """K3 in table mode at image_gen_xsmall's heads (32 / 4 of 24), B 1 and 4:
    the rotation reads the '2d_ntk' (cos, sin) table that
    ``rope_2d_ntk_cos_sin`` makes on the card; q and k within
    PROLOGUE_ULPS of the plain chain given the same table (only the
    QK-norm's sum runs in another order), v, the cache outside the written
    column exact; counted in ``.table.launches``."""
    from vats_tpu_torch.nn.rope import rope_2d_ntk_cos_sin

    hq, g, hd, L, S, gw = 32, 4, 24, 3, 257, 16
    cache = rand(gen, 2, L, b, g, hd, S, dtype=dtype)
    for qk_norm, pos in ((True, 0), (True, 17), (False, 255), (True, S + 3)):
        row = rand(gen, b, 1, (hq + 2 * g) * hd, dtype=dtype)
        q, k, v = torch.split(row, [hq * hd, g * hd, g * hd], dim=-1)
        q, k, v = q.reshape(b, 1, hq, hd), k.reshape(b, 1, g, hd), v.reshape(b, 1, g, hd)
        kw = dict(theta=10000.0, qk_norm=qk_norm)
        tol = PROLOGUE_ULPS[(dtype, qk_norm)]
        bits = 7 if dtype == torch.bfloat16 else 23
        if mode == "paged":
            lengths = torch.randint(0, 4096, (b,), generator=gen, device="cuda")
            lengths[0] = pos
            lengths = lengths.to(torch.int32)
            cs = rope_2d_ntk_cos_sin(lengths[:, None], hd, gw, 10000.0, 0.7)
            n0 = (ca.paged_decode_prologue.launches, ca.paged_decode_prologue.table.launches)
            got = ca.paged_decode_prologue(q, k, v, lengths, None, cos_sin=cs, **kw)
            want = ca.paged_decode_prologue_ref(q, k, v, lengths, cos_sin=cs, **kw)
            torch.cuda.synchronize()
            assert (ca.paged_decode_prologue.launches,
                    ca.paged_decode_prologue.table.launches) == (n0[0] + 1, n0[1] + 1)
            for x, y in zip(got[:2], want[:2]):
                assert float(rotated_ulps(x, y, bits).max()) <= tol
            assert torch.equal(got[2], want[2])
            continue
        length = torch.tensor(pos, dtype=torch.int32, device="cuda")
        cs = rope_2d_ntk_cos_sin(length + torch.arange(1, device="cuda"), hd, gw, 10000.0, 0.7)
        ka, va = cache[0].clone(), cache[1].clone()
        kb, vb = cache[0].clone(), cache[1].clone()
        n0 = (ca.dense_decode_prologue.launches, ca.dense_decode_prologue.table.launches)
        got = ca.dense_decode_prologue(q, k, v, ka, va, length, 1, None, ring=mode == "ring",
                                       cos_sin=cs, **kw)
        want = ca.dense_decode_prologue_ref(q, k, v, kb, vb, length, 1, ring=mode == "ring",
                                            cos_sin=cs, **kw)
        torch.cuda.synchronize()
        assert (ca.dense_decode_prologue.launches,
                ca.dense_decode_prologue.table.launches) == (n0[0] + 1, n0[1] + 1)
        col = pos % S if mode == "ring" else min(pos, S - 1)
        assert float(rotated_ulps(got, want, bits).max()) <= tol
        assert float(rotated_ulps(ka[1, ..., col], kb[1, ..., col], bits).max()) <= tol
        assert torch.equal(va, vb)
        outside = torch.ones(S, dtype=torch.bool, device="cuda")
        outside[col] = False
        assert torch.equal(ka[..., outside], cache[0][..., outside])


def test_decode_prologue_yarn_table_matches_plain(gen):
    """K3's paged table mode as code_chat_8k's full layers run it: Mellum2's
    YaRN table (``mellum2_12b``'s published values, the attention factor in
    cos and sin) at its heads (32 / 4 of 128), 64 rows of 1k-8k tokens,
    bf16, no QK-norm: q and k within PROLOGUE_ULPS of the plain chain given
    the same table, v exact, one launch."""
    from vats_tpu_torch.configs import mellum2_12b
    from vats_tpu_torch.nn.rope import rope_table_cos_sin, yarn_inv_freq

    cfg = mellum2_12b()
    hq, g, hd, b = cfg.num_heads, cfg.query_groups, cfg.head_dim, len(CODE_CHAT_LENGTHS)
    inv_freq = yarn_inv_freq(hd, cfg.rope_base, cfg.yarn_factor, cfg.yarn_original_max_position,
                             cfg.yarn_beta_fast, cfg.yarn_beta_slow, device="cuda")
    lengths = torch.tensor(CODE_CHAT_LENGTHS, dtype=torch.int32, device="cuda")
    cs = rope_table_cos_sin(lengths[:, None], inv_freq, cfg.yarn_attention_factor)
    row = rand(gen, b, 1, (hq + 2 * g) * hd, dtype=torch.bfloat16)
    q, k, v = (x.reshape(b, 1, -1, hd) for x in torch.split(row, [hq * hd, g * hd, g * hd], -1))
    kw = dict(theta=cfg.rope_base, qk_norm=False, cos_sin=cs)
    n0 = ca.paged_decode_prologue.table.launches
    got = ca.paged_decode_prologue(q, k, v, lengths, None, **kw)
    want = ca.paged_decode_prologue_ref(q, k, v, lengths, **kw)
    torch.cuda.synchronize()
    assert ca.paged_decode_prologue.table.launches == n0 + 1
    for x, y in zip(got[:2], want[:2]):
        assert float(rotated_ulps(x, y, 7).max()) <= PROLOGUE_ULPS[(torch.bfloat16, False)]
    assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_at_image_gen_heads_matches_plain(gen, dtype):
    """K1 at image_gen_xsmall's decode: head dim 24, 8 query heads a group
    (the generic NH=8 body), 4 groups; lengths over one page, across pages
    and at 4096: output within TOL, the committed pool bit-equal."""
    b, g, n, hd, ps = 6, 4, 8, 24, 128
    lengths = [0, 1, 127, 256, 257, 4096]
    pps = -(-max(lengths) // ps) + 1
    pool = rand(gen, 3, b * pps, 2, g, ps, hd, dtype=dtype)
    table = torch.randperm(b * pps, generator=gen, device="cuda").to(torch.int32)
    table = table.reshape(b, pps)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = rand(gen, b, g * n, hd, dtype=dtype)
    kc, vc = rand(gen, b, g, hd, dtype=dtype), rand(gen, b, g, hd, dtype=dtype)
    pk, pp = pool.clone(), pool.clone()
    n0 = da.paged_decode_attention_commit.launches
    out = da.paged_decode_attention_commit(q, pk, 1, table, lens, scale=hd**-0.5,
                                           k_cur=kc, v_cur=vc)
    ref = da.paged_decode_attention_ref(q, pp[1], table, lens, scale=hd**-0.5,
                                        k_cur=kc, v_cur=vc)
    da.PagedKVCache(pp, table, lens).append_token(1, kc, vc)
    torch.cuda.synchronize()
    assert da.paged_decode_attention_commit.launches == n0 + 1
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    assert torch.equal(pk, pp)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_at_image_gen_shape_matches_plain(gen, dtype):
    """K2, K2', K5a and K5b at the image transformer's full forward: T = S =
    4096 (a 64 x 64 latent grid), 32 heads over 4 groups, head dim 24 (the
    wrappers pad it to 32), causal; against the plain versions (TOL,
    BWD_BF16_TOL; fp32 1e-4)."""
    b, t, hq, g, hd = 1, 4096, 32, 4, 24
    q = rand(gen, b, t, hq, hd, dtype=dtype)
    k, v = rand(gen, b, t, g, hd, dtype=dtype), rand(gen, b, t, g, hd, dtype=dtype)
    do = rand(gen, b, t, hq, hd, dtype=dtype)
    kw = dict(scale=hd**-0.5, causal=True)
    fns = (fa.flash_attention, fa.flash_attention_lse, fa.flash_bwd_dkv, fa.flash_bwd_dq)
    n0 = [fn.launches for fn in fns]
    out = fa.flash_attention(q, k, v, **kw)
    out_l, lse = fa.flash_attention_lse(q, k, v, **kw)
    ref, lse_ref = fa.flash_attention_lse_ref(q, k, v, **kw)
    di = (do.float() * ref.float()).sum(-1).transpose(1, 2).contiguous()
    got = fa.flash_attention_bwd(q, k, v, do, lse_ref, di, **kw)
    want = fa.flash_attention_bwd_ref(q, k, v, do, lse_ref, di, **kw)
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(fns, n0)] == [1, 1, 1, 1]
    assert torch.equal(out, out_l)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    tol = BWD_BF16_TOL if dtype == torch.bfloat16 else dict(atol=1e-4, rtol=1e-4)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, **tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_at_tensor_parallel_local_heads_matches_plain(gen, dtype):
    """K2, K2', K5a and K5b at medium_moe's heads under tensor=2, as a rank
    of the sharded step runs them: Hq 12 / 2 = 6 query heads over 4 / 2 = 2
    KV groups (3 a group), head dim 64, B = 4, T = S = 512, causal; against
    the plain versions (TOL, BWD_BF16_TOL; fp32 1e-4)."""
    b, t, hq, g, hd = 4, 512, 6, 2, 64
    q = rand(gen, b, t, hq, hd, dtype=dtype)
    k, v = rand(gen, b, t, g, hd, dtype=dtype), rand(gen, b, t, g, hd, dtype=dtype)
    do = rand(gen, b, t, hq, hd, dtype=dtype)
    kw = dict(scale=hd**-0.5, causal=True)
    fns = (fa.flash_attention, fa.flash_attention_lse, fa.flash_bwd_dkv, fa.flash_bwd_dq)
    n0 = [fn.launches for fn in fns]
    out = fa.flash_attention(q, k, v, **kw)
    out_l, lse = fa.flash_attention_lse(q, k, v, **kw)
    ref, lse_ref = fa.flash_attention_lse_ref(q, k, v, **kw)
    di = (do.float() * ref.float()).sum(-1).transpose(1, 2).contiguous()
    got = fa.flash_attention_bwd(q, k, v, do, lse_ref, di, **kw)
    want = fa.flash_attention_bwd_ref(q, k, v, do, lse_ref, di, **kw)
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(fns, n0)] == [1, 1, 1, 1]
    assert torch.equal(out, out_l)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    tol = BWD_BF16_TOL if dtype == torch.bfloat16 else dict(atol=1e-4, rtol=1e-4)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, **tol)


def test_image_gen_tiny_on_the_card_matches_the_cpu(gen):
    """image_gen_tiny_test (fp32) on the card and on the CPU from the same
    weights: greedy tokens of ``generate_image_tokens`` and
    ``generate_image_tokens_paged`` (decode replayed from CUDA graphs, K3
    in table mode and K1 on the card) equal, one table-mode prologue a
    layer a decode forward."""
    from vats_tpu_torch.configs import image_gen_tiny_test
    from vats_tpu_torch.inference import generate_image_tokens, generate_image_tokens_paged
    from vats_tpu_torch.models import AutoregressiveImageTransformer

    cfg = image_gen_tiny_test(dtype="float32")
    gpu = AutoregressiveImageTransformer(cfg, device="cuda", seed=3).eval()
    cpu = AutoregressiveImageTransformer(cfg, device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, assign=True)
    text = torch.randn((2, 6, cfg.d_model), generator=torch.Generator().manual_seed(4))
    kw = dict(grid_h=4, grid_w=4, temperature=0.0, do_sample=False)
    for fn, counted in ((generate_image_tokens, ca.dense_decode_prologue.table),
                        (generate_image_tokens_paged, ca.paged_decode_prologue.table)):
        n0 = counted.launches
        got = fn(gpu, text.cuda(), None, None, **kw)
        torch.cuda.synchronize()
        assert counted.launches - n0 == cfg.num_layers * 16  # 16 forwards of one token
        assert torch.equal(got.cpu(), fn(cpu, text, None, None, **kw))


# --- video generation and the fused multimodal stream: K3's append mode at head
# dim 144, its table mode and K1 at head dim 96, K2 at head dim 96 ------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pos", [0, 7, 14, 20])  # S = 15: 20 clamps to 14
def test_cache_append_at_video_shape_matches_plain(gen, dtype, pos):
    """K3's append mode at video_gen_large's temporal cache (B*HW = 256
    rows, 4 groups, head dim 144: three pairs a lane), bit-equal to
    ``append_token_ref`` over the whole cache."""
    L, b, g, hd, S = 3, 256, 4, 144, 15
    k, v = rand(gen, L, b, g, hd, S, dtype=dtype), rand(gen, L, b, g, hd, S, dtype=dtype)
    kn, vn = rand(gen, b, g, hd, dtype=dtype), rand(gen, b, g, hd, dtype=dtype)
    length = torch.tensor(pos, dtype=torch.int32, device="cuda")
    ka, va, kb, vb = k.clone(), v.clone(), k.clone(), v.clone()
    n0 = ca.append_token_inplace.launches
    ca.append_token_inplace(ka, va, 1, kn, vn, length)
    ca.append_token_ref(kb, vb, 1, kn, vn, length)
    torch.cuda.synchronize()
    assert ca.append_token_inplace.launches == n0 + 1
    assert torch.equal(ka, kb) and torch.equal(va, vb)


@pytest.mark.parametrize("qk_norm", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_decode_prologue_multimodal_table_matches_plain(gen, mode, dtype, qk_norm):
    """K3 in table mode at multimodal_small's heads (8 / 4 of 96), B=4,
    each row at its own modality (text, image, video, video) and position:
    the table ``multimodal_rope_angles`` makes on the card; within
    PROLOGUE_ULPS of the plain chain given the same table."""
    from vats_tpu_torch.configs import multimodal_small
    from vats_tpu_torch.models.multimodal import multimodal_rope_angles

    cfg = multimodal_small()
    b, hq, g, hd, S = 4, 8, 4, 96, 2560
    mod = torch.tensor([[0], [1], [2], [2]], dtype=torch.int32, device="cuda")
    loc = torch.tensor([[63], [200], [1500], [2047]], dtype=torch.int32, device="cuda")
    cs = multimodal_rope_angles(cfg, mod, loc)  # [B, 1, hd/2]
    row = rand(gen, b, 1, (hq + 2 * g) * hd, dtype=dtype)
    q, k, v = torch.split(row, [hq * hd, g * hd, g * hd], dim=-1)
    q, k, v = q.reshape(b, 1, hq, hd), k.reshape(b, 1, g, hd), v.reshape(b, 1, g, hd)
    kw = dict(theta=10000.0, qk_norm=qk_norm)
    tol, bits = PROLOGUE_ULPS[(dtype, qk_norm)], 7 if dtype == torch.bfloat16 else 23
    if mode == "paged":
        lengths = (loc[:, 0] + 64).to(torch.int32)
        got = ca.paged_decode_prologue(q, k, v, lengths, None, cos_sin=cs, **kw)
        want = ca.paged_decode_prologue_ref(q, k, v, lengths, cos_sin=cs, **kw)
        for x, y in zip(got[:2], want[:2]):
            assert float(rotated_ulps(x, y, bits).max()) <= tol
        return
    cache = rand(gen, 2, 2, b, g, hd, S, dtype=dtype)
    length = torch.tensor(321, dtype=torch.int32, device="cuda")
    ka, va, kb, vb = cache[0].clone(), cache[1].clone(), cache[0].clone(), cache[1].clone()
    got = ca.dense_decode_prologue(q, k, v, ka, va, length, 1, None, ring=False, cos_sin=cs,
                                   **kw)
    want = ca.dense_decode_prologue_ref(q, k, v, kb, vb, length, 1, ring=False, cos_sin=cs,
                                        **kw)
    torch.cuda.synchronize()
    assert float(rotated_ulps(got, want, bits).max()) <= tol
    assert float(rotated_ulps(ka[1, ..., 321], kb[1, ..., 321], bits).max()) <= tol
    assert torch.equal(va, vb)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_multimodal_heads_through_k1_and_k2_match_plain(gen, dtype):
    """K1 at multimodal_small's decode (head dim 96, 2 query heads a group,
    4 groups; ragged lengths up to 2369, 19 pages a row) and K2 at its
    prefill (T = 256, head dim 96 padded to 128, causal, ragged key
    validity) against the plain versions."""
    b, g, n, hd, ps = 4, 4, 2, 96, 128
    lengths = [2369, 2303, 1500, 64]
    pps = 19
    pool = rand(gen, 2, b * pps, 2, g, ps, hd, dtype=dtype)
    table = torch.randperm(b * pps, generator=gen, device="cuda").to(torch.int32).reshape(b, pps)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = rand(gen, b, g * n, hd, dtype=dtype)
    kc, vc = rand(gen, b, g, hd, dtype=dtype), rand(gen, b, g, hd, dtype=dtype)
    pk, pp = pool.clone(), pool.clone()
    out = da.paged_decode_attention_commit(q, pk, 1, table, lens, scale=hd**-0.5,
                                           k_cur=kc, v_cur=vc)
    ref = da.paged_decode_attention_ref(q, pp[1], table, lens, scale=hd**-0.5,
                                        k_cur=kc, v_cur=vc)
    da.PagedKVCache(pp, table, lens).append_token(1, kc, vc)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    assert torch.equal(pk, pp)
    t = 256
    qf = rand(gen, b, t, 2 * g, hd, dtype=dtype)
    kf, vf = rand(gen, b, t, g, hd, dtype=dtype), rand(gen, b, t, g, hd, dtype=dtype)
    valid = torch.arange(t, device="cuda")[None, :] < torch.tensor(
        [[256], [200], [131], [17]], device="cuda")
    kw = dict(scale=hd**-0.5, causal=True, kv_valid=valid)
    n0 = fa.flash_attention.launches
    got = fa.flash_attention(qf, kf, vf, **kw)
    want = fa.flash_attention_ref(qf, kf, vf, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    keep = valid[:, :, None, None]  # a padded query's row is free (its logits are not read)
    torch.testing.assert_close((got.float() * keep), (want.float() * keep), **TOL[dtype])


def test_video_and_multimodal_tiny_on_the_card_match_the_cpu(gen):
    """video_gen_tiny_test and a tiny multimodal config (fp32) on the card
    and on the CPU from the same weights: greedy video tokens (inner steps
    replayed from a CUDA graph, K3's append mode once a layer a cached
    forward) and greedy multimodal codes (K3's paged table mode and K1 once
    a layer a decode forward) equal."""
    from vats_tpu_torch.configs import MultimodalStreamArgs, video_gen_tiny_test
    from vats_tpu_torch.inference import generate_multimodal, generate_video_tokens
    from vats_tpu_torch.models import AutoregressiveVideoTransformer, MultimodalLM

    def pair(cls, cfg):
        gpu = cls(cfg, device="cuda", seed=3).eval()
        cpu = cls(cfg, device="meta")
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, assign=True)
        return gpu, cpu

    cfg = video_gen_tiny_test(dtype="float32")
    gpu, cpu = pair(AutoregressiveVideoTransformer, cfg)
    text = torch.randn((2, 5, cfg.d_model), generator=torch.Generator().manual_seed(4))
    kw = dict(num_frames=2, temperature=0.0, do_sample=False)
    n0 = ca.append_token_inplace.launches
    got = generate_video_tokens(gpu, text.cuda(), None, None, **kw)
    torch.cuda.synchronize()
    # 16 read forwards and one append a frame, one launch a layer each
    assert ca.append_token_inplace.launches - n0 == cfg.num_layers * 2 * 17
    assert torch.equal(got.cpu(), generate_video_tokens(cpu, text, None, None, **kw))

    mcfg = MultimodalStreamArgs(
        d_model=48, num_heads=4, query_groups=2, d_ffn=96, num_layers=2, text_vocab_size=64,
        image_vocab_size=16, video_vocab_size=32, image_grid_h=2, image_grid_w=2,
        video_grid_t=2, video_grid_h=2, video_grid_w=2, max_text_len=8, dtype="float32")
    gpu, cpu = pair(MultimodalLM, mcfg)
    ids = torch.tensor([[5, 9, 2, 7, 1, 3], [11, 4, 8, 0, 0, 0]])
    mask = ids > 0
    n0 = (ca.paged_decode_prologue.table.launches, da.paged_decode_attention_commit.launches)
    img, vid = generate_multimodal(gpu, ids.cuda(), mask.cuda(), None, temperature=0.0,
                                   do_sample=False)
    torch.cuda.synchronize()
    forwards = mcfg.image_tokens + mcfg.video_tokens - 1
    assert (ca.paged_decode_prologue.table.launches - n0[0],
            da.paged_decode_attention_commit.launches - n0[1]) == (2 * forwards,) * 2
    want = generate_multimodal(cpu, ids, mask, None, temperature=0.0, do_sample=False)
    assert torch.equal(img.cpu(), want[0]) and torch.equal(vid.cpu(), want[1])


# Ring hops (context parallelism): K2' at a negative q_pos_offset (a wrapped
# shard from ahead, only a right window reaching it) and at a positive one
# (a past shard), and K5a/K5b fed a merged lse and di from outside with rows
# at 1e30 (no key anywhere: dq exactly 0), each against its plain version.
RING_HOPS = {
    "past_causal": dict(causal=True, q_pos_offset=300),
    "future_right_window": dict(causal=False, right_window=420, q_pos_offset=-300),
    "future_both_windows": dict(causal=False, left_window=40, right_window=350,
                                q_pos_offset=-300),
    "future_out_of_reach": dict(causal=True, q_pos_offset=-300),
    # the context_parallel phase's hops: nlp_medium's heads on a 2-rank ring
    # over 4096 tokens (B = 2, T = S = 2048 a shard): the past shard, and a
    # wrapped future one that a right window reaches by a band
    "medium_past_causal": dict(causal=True, q_pos_offset=2048, shape=(2, 2048, 24, 8)),
    "medium_future_right_window": dict(causal=False, right_window=2300, q_pos_offset=-2048,
                                       shape=(2, 2048, 24, 8)),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hop", sorted(RING_HOPS))
def test_flash_ring_hop_with_outside_statistics_matches_plain(gen, hop, dtype):
    hop_kw = dict(RING_HOPS[hop])
    (b, t, hq, g), hd = hop_kw.pop("shape", (2, 300, 6, 2)), 60
    q = rand(gen, b, t, hq, hd, dtype=dtype)
    k, v = rand(gen, b, t, g, hd, dtype=dtype), rand(gen, b, t, g, hd, dtype=dtype)
    do = rand(gen, b, t, hq, hd, dtype=dtype)
    kw = dict(scale=hd**-0.5, **hop_kw)
    out, lse = fa.flash_attention_lse(q, k, v, **kw)
    ref, lse_ref = fa.flash_attention_lse_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    if hop == "future_out_of_reach":  # every query row attends nothing here
        assert bool((lse == 1e30).all()) and bool((out == 0).all())
    # statistics from outside: this hop merged with a hop of its own (the
    # shard itself, causal), and rows with no key anywhere
    own, lse_own = fa.flash_attention_lse_ref(q, k, v, scale=kw["scale"], causal=True)
    la, lb = (torch.where(x > 1e29, -torch.inf, x) for x in (lse_ref, lse_own))
    glob = torch.logaddexp(la, lb)
    glob[1, :, :7] = torch.inf
    glob = torch.where(torch.isfinite(glob), glob, 1e30).contiguous()
    di = rand(gen, b, hq, t)
    n0 = (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
    got = fa.flash_attention_bwd(q, k, v, do, glob, di, **kw)
    want = fa.flash_attention_bwd_ref(q, k, v, do, glob, di, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches) == (n0[0] + 1, n0[1] + 1)
    tol = BWD_BF16_TOL if dtype == torch.bfloat16 else dict(atol=1e-4, rtol=1e-4)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, **tol)
    assert bool((got[0][1, :7] == 0).all())


def test_two_rank_ring_on_one_card_matches_flash(tmp_path):
    """Two ranks on cuda:0 over gloo (CUDA tensors staged through host
    buffers): ring attention forward and backward (K2' and K5a/K5b a live
    hop) against single-process flash over the whole sequence, bf16,
    within 1e-2 relative L2 (each hop's output is rounded to bf16 before
    the merge)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's hand-written kernels)")
    from torch_parallel_ranks import spawn

    b, t, hq, g, hd = 2, 1024, 6, 2, 60
    rng = torch.Generator().manual_seed(5)
    q, do = (torch.randn((b, t, hq, hd), generator=rng) for _ in range(2))
    k, v = (torch.randn((b, t, g, hd), generator=rng) for _ in range(2))
    kw = dict(scale=hd**-0.5, causal=True, left_window=700)
    ranks = spawn("card_ring", 2, tmp_path, dict(q=q, k=k, v=v, do=do, kw=kw))
    full = [x.cuda().bfloat16().requires_grad_() for x in (q, k, v)]
    ref = fa.flash_attention(*full, **kw)
    ref.backward(do.cuda().bfloat16())
    want = [ref] + [x.grad for x in full]
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        got = torch.cat([r[name] for r in ranks], dim=1)
        w = want[i].detach().float().cpu()
        assert float((got - w).norm() / w.norm()) <= 1e-2, name
    # rank 0 runs its own shard, rank 1 the past shard too
    assert [r["launches"] for r in ranks] == [(1, 1, 1), (2, 2, 2)]


def test_exact_top_k_ties_on_the_card_equal_the_cpu(gen):
    """``exact_top_k`` on bf16 logits upcast to fp32 (ties by the dozen at a
    vocabulary of 65536): values and indices, ties in index order, equal
    to the CPU's (``lax.top_k``'s order, which the CPU tests hold)."""
    from vats_tpu_torch.inference.sampling import exact_top_k

    logits = (rand(gen, 16, 65536) * 3).bfloat16().float()
    for k in (1, 50, 64, 1000):
        vals, idx = exact_top_k(logits, k)
        cv, ci = exact_top_k(logits.cpu(), k)
        assert torch.equal(vals.cpu(), cv) and torch.equal(idx.cpu(), ci), k


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,size", [((16, 3, 448, 531), (384, 455)),
                                        ((2, 3, 37, 53), (64, 92)),
                                        ((4, 3, 8, 240, 320), (224, 224))])
def test_resize_on_the_card_matches_the_cpu(gen, dtype, shape, size):
    """``resize_bilinear`` (``jax.image.resize``'s computation) on the card
    against the CPU: bf16 within one ulp (fp32 sums in another order move a
    rounding now and then), fp32 within 1e-5 (full fp32 products, no TF32)."""
    from vats_tpu_torch.models.vit2d import resize_bilinear

    x = rand(gen, *shape, dtype=dtype)
    got = resize_bilinear(x, size).cpu()
    want = resize_bilinear(x.cpu(), size)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    else:
        ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp(min=2.0**-126))) - 7)
        assert bool(((got.float() - want.float()).abs() <= ulp).all())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_blockwise_ring_on_one_rank_on_the_card_matches_the_cpu(tmp_path, dtype):
    """The blockwise ring (``impl="xla"``: 256 x 256 tiles over T = 1024,
    causal, left window 300, ragged key validity) on one gloo rank, on
    cuda:0 against the CPU, forward and backward: bf16 within 2e-2 absolute
    plus 2e-2 relative (one bf16 ulp of outputs and gradients up to ~4 where
    fp32 sums in another order move a rounding), fp32 within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's hand-written kernels)")
    from torch_parallel_ranks import spawn

    b, t, hq, g, hd = 2, 1024, 6, 2, 60
    rng = torch.Generator().manual_seed(6)
    q, do = (torch.randn((b, t, hq, hd), generator=rng) for _ in range(2))
    k, v = (torch.randn((b, t, g, hd), generator=rng) for _ in range(2))
    valid = torch.arange(t)[None, :] < torch.tensor([[t], [700]])
    kw = dict(scale=hd**-0.5, causal=True, left_window=300, q_chunk=256, k_chunk=256)
    (got,) = spawn("card_blockwise_ring", 1, tmp_path,
                   dict(q=q, k=k, v=v, do=do, valid=valid, kw=kw, dtype=dtype))
    tol = dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-4)
    for name, a, b_ in zip(("out", "dq", "dk", "dv"), got["cuda"], got["cpu"]):
        torch.testing.assert_close(a, b_, msg=name, **tol)


# K6 (paged tail-prefill attention) cases: (rows, bucket, starts, tails, g, n,
# hd, left_window).  Starts are page-aligned prefix hits (0 for a fresh
# row); a tail is the window's valid length (the mask ends there); a start
# of None is a scratch row (table all page 0, one valid token at 0), as the
# serving engine pads a group to a power of two.  pps 32 pages of 128:
# 4096 tokens, so a start of 3968 puts the bucket's pad queries past the
# table's capacity.
K6_CASES = {
    "bucket32_one_row": dict(bucket=32, starts=[0], tails=[20]),
    "bucket128_group8_scratch": dict(bucket=128, starts=[0, 128, 1024, 3968, 0, None, None,
                                                          None], tails=[128, 77, 100, 50, 1]),
    "bucket512_group16_scratch": dict(
        bucket=512, starts=[0, 0, 0, 128, 256, 512, 1024, 1536, 2048, 2560, 3072, 3584, 3968,
                            None, None, None],
        tails=[512, 129, 300, 512, 401, 200, 317, 500, 256, 130, 499, 64, 127]),
    "bucket2048": dict(bucket=2048, starts=[0, 1024], tails=[2048, 1500]),
    "hd96_two_heads_a_group": dict(bucket=128, starts=[0, 256], tails=[128, 60], g=4, n=2,
                                   hd=96),
    "hd32_one_head_a_group": dict(bucket=128, starts=[0, 384, None, None], tails=[100, 128],
                                  g=4, n=1, hd=32),
    "hd128_eight_heads_a_group": dict(bucket=128, starts=[0, 640], tails=[128, 90], g=1,
                                      n=8, hd=128),
    "left_window": dict(bucket=512, starts=[0, 640, 1280, None], tails=[512, 400, 33],
                        left_window=300),
    # code_chat_8k's prefills (Mellum2's heads, 64 pages a row): the
    # 8,192-token budget as 4 prompts at the 2,048 bucket and one at 6,144,
    # each with its sliding layers' window and without (the full layers).
    # Under the window a padding query far past its row's tail attends the
    # last few valid keys, where a flipped rounding of p moves the output by
    # more than one bf16 ulp: the p flip allowance covers it
    "mellum2_bucket2048": dict(bucket=2048, starts=[0, 0, 0, 0], tails=[2048, 1700, 1100, 1025],
                               g=4, n=8, hd=128, pps=64),
    "mellum2_bucket2048_window": dict(bucket=2048, starts=[0, 0, 0, 0],
                                      tails=[2048, 1700, 1100, 1025], g=4, n=8, hd=128, pps=64,
                                      left_window=1023),
    "mellum2_bucket6144": dict(bucket=6144, starts=[0], tails=[5000], g=4, n=8, hd=128, pps=64),
    "mellum2_bucket6144_window": dict(bucket=6144, starts=[0], tails=[5000], g=4, n=8, hd=128,
                                      pps=64, left_window=1023),
}


def _k6_inputs(gen, c, nl=2, ps=128):
    """A bf16 pool of random pages (pad columns 0; page 0 is the scratch
    page), each row's table a run of its own random pages (32 unless the
    case says), the starts as ``lengths``, the window masks, and
    roped-looking q padded to the pool's head dim."""
    starts, pps = c["starts"], c.get("pps", 32)
    b = len(starts)
    g, n, hd, t = c.get("g", 8), c.get("n", 3), c.get("hd", 60), c["bucket"]
    hdp = -(-hd // 8) * 8
    pages = 1 + b * pps
    pool = rand(gen, nl, pages, 2, g, ps, hdp, dtype=torch.bfloat16)
    pool[..., hd:] = 0
    perm = 1 + torch.randperm(pages - 1, generator=gen, device="cuda").to(torch.int32)
    table = perm.reshape(b, pps)
    mask = torch.zeros((b, t), dtype=torch.bool, device="cuda")
    lengths = torch.zeros(b, dtype=torch.int32, device="cuda")
    for r, start in enumerate(starts):
        if start is None:  # a scratch row
            table[r] = 0
            mask[r, 0] = True
        else:
            lengths[r] = start
            mask[r, :c["tails"][r]] = True
    q = rand(gen, b, t, g * n, hdp, dtype=torch.bfloat16)
    q[..., hd:] = 0
    return q, pool, table, lengths, mask, hd


def _k6_flash_ref(q, pool, layer, table, lengths, mask, scale, left_window):
    """K6's arithmetic a row at a time: the row's pages gathered, the plain
    flash forward (p rounded to bf16 before P V, a query with no key 0) at
    the row's offset.  Returns (out, a [B, Hq, T] bool: the query attends
    some key, the p flip allowance of each output element over the keys
    before the row's last query)."""
    t = q.shape[1]
    k_t, v_t = da.PagedKVCache(pool, table, lengths).gather_dense_t(layer)
    k, v = k_t.permute(0, 3, 1, 2), v_t.permute(0, 3, 1, 2)  # [B, S, G, hdp]
    s = k.shape[1]
    pos = torch.arange(s, device="cuda")
    outs, attends, allow = [], [], []
    for r in range(q.shape[0]):
        start = int(lengths[r])
        rel = torch.clamp(pos - start, 0, t - 1)
        valid = (pos < start) | ((pos < start + t) & mask[r][rel])
        kw = dict(scale=scale, causal=True, left_window=left_window, q_pos_offset=start)
        out, lse = fa.flash_attention_lse_ref(q[r:r + 1], k[r:r + 1], v[r:r + 1],
                                              kv_valid=valid[None], **kw)
        outs.append(out)
        attends.append(lse < fa.LSE_EMPTY_ROW)
        seen = min(s, start + t)  # no query sees a later key
        allow.append(p_flip_allowance(q[r:r + 1], k[r:r + 1, :seen], v[r:r + 1, :seen],
                                      kv_valid=valid[None, :seen], **kw))
    return torch.cat(outs), torch.cat(attends), torch.cat(allow)


@pytest.mark.parametrize("name", sorted(K6_CASES))
def test_paged_prefill_matches_plain(gen, name):
    """K6 against its arithmetic (the plain flash forward over the row's
    gathered pages: p rounded to bf16, as K6 rounds it) within one bf16 ulp
    of the output (TOL) at the queries the engine reads (the tails), and
    within TOL plus the p flip allowance at every query (a sum in another
    order flips a rounding of p now and then, as for K2; it moves a
    padding query that attends a window's last few keys by more than an
    ulp), and against the plain version (fp32 p, the
    attention's CPU path) at every query that attends a key: rounding each
    p_j to bf16 moves it by at most 2^-9 of itself, the output by at most
    2^-9 max|v|, so that tolerance adds 2^-9 max|v| to TOL's.  Every query
    is finite, a query that attends nothing writes 0; a second launch gives
    equal bits."""
    from vats_tpu_torch.ops import paged_prefill_attention as pp

    c = K6_CASES[name]
    q, pool, table, lengths, mask, hd = _k6_inputs(gen, c)
    layer, scale, lw = 1, hd**-0.5, c.get("left_window", -1)
    kw = dict(scale=scale, window_mask=mask, left_window=lw)
    n0 = pp.paged_prefill_attention.launches
    out = pp.paged_prefill_attention(q, pool, layer, table, lengths, **kw)
    again = pp.paged_prefill_attention(q, pool, layer, table, lengths, **kw)
    torch.cuda.synchronize()
    assert pp.paged_prefill_attention.launches == n0 + 2
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert torch.equal(out, again)
    assert bool(torch.isfinite(out.float()).all())
    assert bool((out[..., hd:] == 0).all())
    want, attends, allow = _k6_flash_ref(q, pool, layer, table, lengths, mask, scale, lw)
    tails = mask[:, :, None, None].expand(out.shape)
    torch.testing.assert_close(out.float()[tails], want.float()[tails], **TOL[torch.bfloat16])
    limit = (TOL[torch.bfloat16]["atol"] + TOL[torch.bfloat16]["rtol"] * want.float().abs()
             + allow)
    assert bool(((out.float() - want.float()).abs() <= limit).all())
    plain = pp.paged_prefill_attention_ref(q, pool, layer, table, lengths, **kw)
    check_paged_prefill(name, out, plain, attends.transpose(1, 2)[..., None],
                        float(pool[layer, :, 1].float().abs().max()))


def test_paged_prefill_replays_from_a_graph(gen):
    """A capture of K6 records one launch; its replay equals the eager call
    bit for bit, and reads the inputs' buffers anew (new starts, same
    shapes)."""
    from vats_tpu_torch.ops import kernels
    from vats_tpu_torch.ops import paged_prefill_attention as pp

    q, pool, table, lengths, mask, hd = _k6_inputs(gen, K6_CASES["bucket128_group8_scratch"])
    kw = dict(scale=hd**-0.5, window_mask=mask)
    call = lambda: pp.paged_prefill_attention(q, pool, 0, table, lengths, **kw)  # noqa: E731
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with kernels.launch_tally() as tally:
        with torch.cuda.graph(graph):
            out = call()
    assert tally == {pp.paged_prefill_attention: 1}
    for starts in ([0, 128, 1024, 3968, 0, 0, 0, 0], [256, 0, 512, 128, 3840, 0, 0, 0]):
        lengths.copy_(torch.tensor(starts, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, call())


def test_paged_prefill_rejects_bad_inputs(gen):
    """No fallback on the card: int8 pools, a stored head dim K6 has no tile
    for, a non-contiguous or fp32 q, an int64 table raise."""
    from vats_tpu_torch.ops import paged_prefill_attention as pp

    q, pool, table, lengths, mask, _ = _k6_inputs(gen, K6_CASES["bucket32_one_row"])
    kw = dict(scale=0.125, window_mask=mask)
    with pytest.raises(ValueError, match="bf16 pools"):
        pp.paged_prefill_attention(q, pool.to(torch.int8), 0, table, lengths, **kw)
    with pytest.raises(ValueError, match="bf16 pools"):
        pp.paged_prefill_attention(q[..., :24].contiguous(), pool[..., :24].contiguous(), 0,
                                   table, lengths, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        pp.paged_prefill_attention(q.transpose(2, 1).contiguous().transpose(2, 1), pool, 0,
                                   table, lengths, **kw)
    with pytest.raises(ValueError, match="bfloat16"):
        pp.paged_prefill_attention(q.float(), pool, 0, table, lengths, **kw)
    with pytest.raises(ValueError, match="int32"):
        pp.paged_prefill_attention(q, pool, 0, table.long(), lengths, **kw)


# K1's window (a windowed layer of a HybridModelArgs model): rows inside,
# at and past the window, windows that end mid-tile and on a tile's edge,
# one shorter than a tile, and a row at capacity
K1_WINDOW_CASES = {
    "mellum_heads": (8, 4, 128, 128, 1023, [0, 1, 1023, 1024, 1025, 1500, 2047, 3000]),
    "tile_edge": (8, 3, 60, 128, 255, [255, 256, 384, 640, 1000]),
    "short_window": (2, 8, 128, 256, 7, [3, 8, 9, 300, 511, 512]),
    "code_chat_8k": (4, 8, 128, 128, 1023, CODE_CHAT_LENGTHS),
}


@pytest.mark.parametrize("name", sorted(K1_WINDOW_CASES))
def test_windowed_paged_decode_matches_plain(gen, name):
    """K1 with a left window against the plain version with it (output
    within TOL, the committed pool bit-equal); the window changes the
    output of every row well past it."""
    g, n, hd, ps, lw, lengths = K1_WINDOW_CASES[name]
    b = len(lengths)
    pps = -(-(max(lengths) + 1) // ps)
    pool = rand(gen, 2, b * pps, 2, g, ps, -(-hd // 8) * 8, dtype=torch.bfloat16)
    pool[..., hd:] = 0
    table = torch.randperm(b * pps, generator=gen, device="cuda").to(torch.int32).reshape(b, pps)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = rand(gen, b, g * n, hd, dtype=torch.bfloat16)
    kc, vc = rand(gen, b, g, hd, dtype=torch.bfloat16), rand(gen, b, g, hd, dtype=torch.bfloat16)
    kw = dict(scale=hd**-0.5, k_cur=kc, v_cur=vc)
    pk, pp = pool.clone(), pool.clone()
    out = da.paged_decode_attention_commit(q, pk, 1, table, lens, left_window=lw, **kw)
    ref = da.paged_decode_attention_ref(q, pp[1], table, lens, left_window=lw, **kw)
    full = da.paged_decode_attention_ref(q, pp[1], table, lens, **kw)
    da.PagedKVCache(pp, table, lens).append_token(1, kc, vc)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16])
    assert torch.equal(pk, pp)
    past = lens >= lw + 128  # a tenth of the keys or more left out
    assert bool(((out.float() - full.float()).abs().amax(dim=(1, 2)) > 0.01)[past].all())


def test_paged_decode_without_window_is_unchanged_by_a_window_past_every_row(gen):
    """left_window = -1 (the default) is today's call; a window that reaches
    back past every row's start attends the same keys by the same path, so
    it gives equal bits; both equal the plain version within TOL."""
    g, n, hd, ps, lengths = 8, 3, 60, 128, [0, 1, 127, 128, 129, 2047, 4000]
    b, pps = len(lengths), 32
    pool = rand(gen, 2, b * pps, 2, g, ps, 64, dtype=torch.bfloat16)
    pool[..., hd:] = 0
    table = torch.randperm(b * pps, generator=gen, device="cuda").to(torch.int32).reshape(b, pps)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = rand(gen, b, g * n, hd, dtype=torch.bfloat16)
    kc, vc = rand(gen, b, g, hd, dtype=torch.bfloat16), rand(gen, b, g, hd, dtype=torch.bfloat16)
    kw = dict(scale=0.2, k_cur=kc, v_cur=vc)
    today = da.paged_decode_attention(q, pool, 0, table, lens, **kw)
    none = da.paged_decode_attention(q, pool, 0, table, lens, left_window=-1, **kw)
    wide = da.paged_decode_attention(q, pool, 0, table, lens, left_window=4096, **kw)
    torch.cuda.synchronize()
    assert torch.equal(today, none) and torch.equal(today, wide)
    ref = da.paged_decode_attention_ref(q, pool[0], table, lens, **kw)
    torch.testing.assert_close(today.float(), ref.float(), **TOL[torch.bfloat16])
    with pytest.raises(NotImplementedError, match="no sliding window"):
        da.paged_decode_attention_commit(
            q, pool.to(torch.int8), 0, table, lens, left_window=10,
            kv_scales=torch.ones(pool.shape[:-1], device="cuda"), **kw)


def test_hybrid_engine_on_the_card_matches_the_cpu(gen):
    """A HybridModelArgs model (a window of 8 tokens on three of its four
    layers, YaRN over an original 32 on the fourth, head dim 32 over
    d_model 64) served in fp32 through the ServingEngine: the card (graph
    replays, K3's table mode on the full layer, K1 with the window on the
    sliding ones) against the CPU's plain versions, token for token, past
    the window and past YaRN's original length."""
    from vats_tpu_torch.configs import mellum2_12b
    from vats_tpu_torch.inference import ServingEngine
    from vats_tpu_torch.models import TextLM

    cfg = mellum2_12b(d_model=64, num_heads=4, query_groups=2, head_dim=32, d_ffn=64,
                      num_layers=4, num_experts=8, top_k=4, left_window=7,
                      layer_types=("sliding_attention",) * 3 + ("full_attention",),
                      yarn_original_max_position=32, vocab_size=97, max_seq_len=512,
                      dtype="float32", param_dtype="float32")
    gpu = TextLM(cfg, device="cuda", seed=3).eval()
    cpu = TextLM(cfg, device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, assign=True)
    g = torch.Generator().manual_seed(4)
    prompts = [torch.randint(1, 97, (n,), generator=g).tolist() for n in (5, 30, 60, 100)]
    outs, n0 = [], (da.paged_decode_attention_commit.launches,
                    ca.paged_decode_prologue.table.launches)
    for model in (cpu, gpu):
        eng = ServingEngine(model, max_batch=4, max_context=256, decode_block_steps=4,
                            prompt_buckets=(32, 64, 128), max_prefill_tokens=128)
        rids = [eng.submit(p, 40) for p in prompts]
        out = eng.run()
        outs.append([out[r] for r in rids])
    assert outs[0] == outs[1]
    forwards = eng.forwards["decode"]
    assert da.paged_decode_attention_commit.launches == n0[0] + 4 * forwards
    assert ca.paged_decode_prologue.table.launches == n0[1] + forwards


# K7 at the main path's shapes: (n tokens, d, f, E, k).  decode_heavy's
# decode (64 rows) and prefill (1,024 tokens) on vats_medium_e8;
# code_chat_8k's decode and prefill (the 8,192-token budget) on Mellum2.
K7_SHAPES = {
    "medium_e8_decode": (64, 1440, 5760, 8, 2),
    "medium_e8_prefill": (1024, 1440, 5760, 8, 2),
    "mellum2_decode": (64, 2304, 896, 64, 8),
    "mellum2_prefill": (8192, 2304, 896, 64, 8),
}


def _k7_inputs(gen, n, d, f, e, k, skew=False):
    """bf16 tokens and expert weights (products of unit size), a router's
    top-k of random logits (``skew``: expert 0 never chosen, expert 1 in
    every token's first slot) and its renormalised bf16 weights."""
    x = rand(gen, n, d, dtype=torch.bfloat16)
    wg, wu = (rand(gen, e, d, f) * d**-0.5 for _ in range(2))
    wd = rand(gen, e, f, d) * f**-0.5
    logits = rand(gen, n, e)
    if skew:
        logits[:, 0] = -1e9
        logits[:, 1] = 1e9
    probs, idx = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True, stable=True)
    w = probs[:, :k] / probs[:, :k].sum(-1, keepdim=True)
    return (x, w.to(torch.bfloat16), idx[:, :k],
            *(t.to(torch.bfloat16) for t in (wg, wu, wd)))


@pytest.mark.parametrize("skew", [False, True], ids=["spread", "skewed"])
@pytest.mark.parametrize("name", sorted(K7_SHAPES))
def test_moe_grouped_gemm_matches_plain(gen, name, skew):
    """K7's plan, gather and combine equal their plain versions bit for bit
    (integer work; fp32 sums over the slots in the same order).  K7a and
    K7b (the small tiles at the decode shapes, the large at the prefills;
    skewed: an expert with no rows, one with a row of every token) against
    the plain version from the same bf16 operands: both take exact bf16
    products into fp32 sums, in another order, and round the fp32 epilogue
    once to bf16, so they may differ by a flipped rounding, one bf16 ulp
    (TOL's rtol 1e-2 covers 2^-8), plus TOL's 2e-3 floor near zero.  A
    second launch gives equal bits."""
    from vats_tpu_torch.ops import moe_grouped as mg

    n, d, f, e, k = K7_SHAPES[name]
    x, w, idx, wg, wu, wd = _k7_inputs(gen, n, d, f, e, k, skew=skew)
    n0 = mg.moe_grouped_gemm.launches
    check_routed_experts(name, x, w, idx, wg, wu, wd, e)
    assert mg.moe_grouped_gemm.launches == n0 + 2
    plan = mg.route_plan(idx, w, e)
    assert int(plan.counts.sum()) == n * k
    rows = x[plan.row_tok.long()]
    h = mg.moe_grouped_gemm(rows, plan.counts, wg, w_up=wu)
    assert torch.equal(h, mg.moe_grouped_gemm(rows, plan.counts, wg, w_up=wu))


def test_moe_routed_layer_on_the_card_matches_the_scatter_oracle(gen):
    """A lossless bf16 layer without autograd resolves to 'routed' on the
    card; its output against the scatter dispatch (the oracle, every token
    in every expert's buffer) at the same weights: the routed path rounds
    once (fp32 SwiGLU and combine) where the oracle rounds each product and
    sum to bf16, so they differ by a few bf16 ulps (2^-8 each) of the
    output's largest entries: within 2^-5 of the largest."""
    from vats_tpu_torch.nn.moe import MoELayer
    from vats_tpu_torch.ops import moe_grouped as mg

    layer = MoELayer(256, 512, 8, 2, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                     device="cuda")
    layer.reset_parameters(torch.Generator(device="cuda").manual_seed(1))
    x = rand(gen, 2, 40, 256, dtype=torch.bfloat16)
    n0 = mg.moe_grouped_gemm.launches
    with torch.no_grad():
        out, _ = layer(x)
        layer.dispatch = "scatter"
        want, _ = layer(x)
    assert layer.mode_calls == {"routed": 1, "scatter": 1}
    assert mg.moe_grouped_gemm.launches == n0 + 2
    scale = float(want.float().abs().max())
    torch.testing.assert_close(out.float(), want.float(), atol=2.0**-5 * scale, rtol=3e-2)


def test_moe_routed_experts_replay_under_other_routing(gen):
    """A capture of the routed path records K7 twice and no host sync; its
    replays over new tokens, weights and expert ids (other counts, an
    expert left empty) equal the eager path bit for bit."""
    from vats_tpu_torch.ops import kernels
    from vats_tpu_torch.ops import moe_grouped as mg

    n, d, f, e, k = K7_SHAPES["mellum2_decode"]
    x, w, idx, wg, wu, wd = _k7_inputs(gen, n, d, f, e, k)
    call = lambda: mg.routed_experts(x, w, idx, wg, wu, wd)  # noqa: E731
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with kernels.launch_tally() as tally:
        with torch.cuda.graph(graph):
            out = call()
    assert tally == {mg.moe_grouped_gemm: 2}
    for skew in (False, True):
        x2, w2, idx2 = _k7_inputs(gen, n, d, f, e, k, skew=skew)[:3]
        x.copy_(x2)
        w.copy_(w2)
        idx.copy_(idx2)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, call())


def test_moe_grouped_gemm_rejects_bad_inputs(gen):
    """No fallback on the card: fp32 operands, widths that are not
    multiples of 8, int64 counts, both or neither of w_up and row_w raise."""
    from vats_tpu_torch.ops import moe_grouped as mg

    x, w, idx, wg, wu, wd = _k7_inputs(gen, 64, 64, 96, 4, 2)
    plan = mg.route_plan(idx, w, 4)
    rows = mg.gather_rows(x, plan.row_tok)
    with pytest.raises(ValueError, match="bfloat16"):
        mg.moe_grouped_gemm(rows.float(), plan.counts, wg, w_up=wu)
    with pytest.raises(ValueError, match="multiples of 8"):
        mg.moe_grouped_gemm(rows[:, :60].contiguous(), plan.counts, wg[:, :60].contiguous(),
                            w_up=wu[:, :60].contiguous())
    with pytest.raises(ValueError, match="int32"):
        mg.moe_grouped_gemm(rows, plan.counts.long(), wg, w_up=wu)
    with pytest.raises(ValueError, match="w_up"):
        mg.moe_grouped_gemm(rows, plan.counts, wg, w_up=wu, row_w=plan.row_w)
    with pytest.raises(ValueError, match="w_up"):
        mg.moe_grouped_gemm(rows, plan.counts, wg)


# --- K8: the fused AdamW update and gradient accumulation -------------------
# K8 computes the plain version's operations with its roundings, so every
# case is bit for bit (NaNs too): params, moments, accumulators.

MEDIUM_MOE_PARAMS = 748_785_504  # vats_medium_moe, the training cells' model


def medium_moe_leaves(dtype):
    """vats_medium_moe's 122 leaves (12 layers, 8 experts top-2, the tied
    65,536 x 768 embedding down to the 8-element router biases) at their
    init scale, on the card in ``dtype``."""
    from vats_tpu_torch.configs import nlp_medium
    from vats_tpu_torch.models import TextLM

    cfg = nlp_medium(d_model=768, num_heads=12, query_groups=4, d_ffn=3072, num_layers=12,
                     num_experts=8, top_k=2, left_window=-1, max_seq_len=2048)
    params = [p.detach().to(dtype) for p in TextLM(cfg, device="cuda", seed=0).parameters()]
    assert len(params) == 122 and sum(p.numel() for p in params) == MEDIUM_MOE_PARAMS
    return params


# odd leaves: 1 element, tails of 1-3 past a multiple of 4, a chunk (8192)
# and one past it, and a param 4 bytes off the 16-byte boundary (K8's scalar
# path for a whole leaf)
ODD_SHAPES = [(1,), (3,), (5, 7), (8192,), (8193,), (2, 4099), (768,)]


def odd_leaves(gen, dtype):
    params = [rand(gen, *s).to(dtype) for s in ODD_SHAPES]
    buf = rand(gen, 1 + 4097).to(dtype)
    return params + [buf[1:]]


def grads_like(gen, params, zero_every=5):
    """A gradient a leaf at a scale of its own (1e-6 to 1e-1); every
    ``zero_every``-th leaf all zero (the update is weight decay alone)."""
    out = []
    for i, p in enumerate(params):
        s = 10.0 ** -(1 + (i * 7) % 6)
        g = torch.randn(p.shape, generator=gen, device="cuda") * s
        out.append((g * 0 if i % zero_every == zero_every - 1 else g).to(p.dtype))
    return out


def card_adamw(mu_dtype):
    """AdamW as the training cells' trainer makes it (betas 0.9 / 0.95, eps
    1e-6, weight decay 5e-4, lr 6e-4 after one warm-up update of lr 0)."""
    from vats_tpu_torch.train.optimizer import AdamW, cosine_with_warmup_schedule

    return AdamW(cosine_with_warmup_schedule(6e-4, 1, 100), b1=0.9, b2=0.95, eps=1e-6,
                 weight_decay=5e-4, mu_dtype=mu_dtype)


@pytest.mark.parametrize("dtype,mu_dtype", [
    (torch.float32, torch.bfloat16),   # the LM trainer's
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),  # bf16 params (a vision model's param_dtype)
    (torch.bfloat16, torch.float32),
], ids=["fp32-mu_bf16", "fp32-mu_fp32", "bf16-mu_bf16", "bf16-mu_fp32"])
def test_adamw_k8_equals_plain_at_medium_moe_leaves(gen, dtype, mu_dtype):
    """K8's update against the plain per-leaf version at every leaf of
    vats_medium_moe, over five consecutive updates from one state: no clip
    and no skip (bare AdamW), scale 1 and finite, scale < 1 (the clip),
    finite False with scale 0 (ClipAndSkipNonFinite's skip), and a scale
    without a finite flag (ClipByGlobalNorm).  Params, both moments and the
    gradients bit for bit after each."""
    from torch_card_parity import check_adamw
    from vats_tpu_torch.ops import adamw as aw

    opt = card_adamw(mu_dtype)
    params = medium_moe_leaves(dtype)
    state = opt.init(dict(enumerate(params)))
    mus, nus = list(state.mu.values()), list(state.nu.values())
    one = lambda x, dt=torch.float32: torch.tensor(x, dtype=dt, device="cuda")  # noqa: E731
    tables = aw.LeafTables()
    for i, (scale, finite) in enumerate([(None, None), (one(1.0), one(True, torch.bool)),
                                         (one(0.3712), one(True, torch.bool)),
                                         (one(0.0), one(False, torch.bool)),
                                         (one(0.5), None)]):
        grads = grads_like(gen, params)
        check_adamw(f"update {i}", opt, state.count, (params, grads, mus, nus), scale, finite,
                    tables=tables)
        state.count += 1 if finite is None else finite.to(torch.int32)
    assert int(state.count) == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_accumulation_k8_equals_plain_over_a_window(gen, dtype):
    """MultiSteps' window of k = 4 at vats_medium_moe's leaves: the running
    mean at positions 0..3 (K8's accumulation step against the plain one),
    then the boundary's update with the clip from the average's norm and
    the accumulator's reset in the same pass (acc * 0), then position 0 of
    the next window: bit for bit at each."""
    from torch_card_parity import check_accumulate, check_adamw
    from vats_tpu_torch.ops import adamw as aw
    from vats_tpu_torch.train.optimizer import clip_scale, global_norm

    opt = card_adamw(torch.bfloat16)
    params = medium_moe_leaves(dtype)
    state = opt.init(dict(enumerate(params)))
    accs = [torch.zeros_like(p) for p in params]
    acc_tables, tables = aw.LeafTables(), aw.LeafTables()
    for pos in range(4):
        check_accumulate(f"position {pos}", accs, grads_like(gen, params, zero_every=7),
                         pos + 1, acc_tables)
    finite, scale = clip_scale(global_norm(dict(enumerate(accs))), 1.0)
    assert bool(finite)
    check_adamw("boundary", opt, state.count, (params, accs, list(state.mu.values()),
                                               list(state.nu.values())),
                scale, finite, reset_grads=True, tables=tables)
    assert not any(bool(a.any()) for a in accs)
    check_accumulate("next window", accs, grads_like(gen, params), 1, acc_tables)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_k8_skips_a_nan_window_as_the_plain_path(gen, dtype):
    """MultiSteps(ClipAndSkipNonFinite(AdamW)) on the card over a window
    whose third gradient holds a NaN and an Inf (odd leaves: 1 element,
    tails, a misaligned param): the skip leaves params, moments and count
    untouched bit for bit, and the accumulator is what the plain version
    leaves, acc * 0: NaN where the average is not finite, 0 elsewhere."""
    from torch_card_parity import check_bits
    from vats_tpu_torch.ops import adamw as aw
    from vats_tpu_torch.train.optimizer import (
        ClipAndSkipNonFinite,
        MultiSteps,
        clip_scale,
        global_norm,
    )

    opt = card_adamw(torch.bfloat16)
    tx = MultiSteps(ClipAndSkipNonFinite(1.0, opt), 4)
    params = dict(enumerate(odd_leaves(gen, dtype)))
    n = len(params)
    st = tx.init(params)
    inner = st.inner_opt_state.inner_state
    state = [*params.values(), *inner.mu.values(), *inner.nu.values(), inner.count]
    before = [t.clone() for t in state]
    accs = [a.clone() for a in st.acc_grads.values()]  # the plain version's window
    for pos in range(4):
        grads = grads_like(gen, list(params.values()))
        if pos == 2:
            grads[3].view(-1)[5] = float("nan")
            grads[6].view(-1)[0] = float("inf")
        aw.accumulate_ref(accs, grads, pos + 1)
        tx.update_(params, dict(enumerate(grads)), st)
        assert (tx.leaves_fused, tx.leaves_plain) == (n, 0)
    assert (opt.leaves_fused, opt.leaves_plain) == (n, 0)
    # the plain version's boundary, from the state before the window
    finite, scale = clip_scale(global_norm(dict(enumerate(accs))), 1.0)
    assert not bool(finite)
    plain = [t.clone() for t in before]
    aw.adamw_update_ref(plain[:n], accs, plain[n:2 * n], plain[2 * n:3 * n],
                        opt.coefficients(plain[-1], finite), opt.eps, opt.weight_decay,
                        scale, finite, reset_grads=True)
    check_bits("skipped update, the plain version", plain, before)
    check_bits("skipped update", state, before)
    check_bits("accumulator after the skip", list(st.acc_grads.values()), accs)
    assert bool(torch.isnan(accs[3]).any()) and bool(torch.isnan(accs[6]).any())
    assert int(st.inner_opt_state.notfinite_count) == 1 and st.mini_step == 0


def test_adamw_k8_replays_a_window_from_graphs_as_eagerly(gen):
    """MultiSteps(ClipAndSkipNonFinite(AdamW)) on odd leaves, one CUDA graph
    a window position (each captured after an eager warm-up of its
    position, which builds K8's tables): a capture records one accumulation
    launch, and the boundary's one update launch besides; two windows of
    replays over new gradients equal an eager twin bit for bit."""
    from torch_card_parity import check_bits
    from vats_tpu_torch.ops import kernels
    from vats_tpu_torch.train.optimizer import ClipAndSkipNonFinite, MultiSteps
    from vats_tpu_torch.train.step_graphs import state_tensors

    def make():
        tx = MultiSteps(ClipAndSkipNonFinite(1.0, card_adamw(torch.bfloat16)), 4)
        params = {i: p.clone() for i, p in enumerate(leaves)}
        return tx, params, tx.init(params), {i: torch.zeros_like(p) for i, p in params.items()}

    leaves = odd_leaves(gen, torch.float32)
    (tx, params, st, grads), (tx2, params2, st2, grads2) = make(), make()

    def feed(new):  # the same gradients into both sides' buffers
        for gs in (grads, grads2):
            for t, x in zip(gs.values(), new):
                t.copy_(x)

    for pos in range(4):  # each position's eager warm-up, on both sides
        feed(grads_like(gen, leaves))
        tx.update_(params, grads, st)
        tx2.update_(params2, grads2, st2)
    graphs, tallies = [], []
    for pos in range(4):
        g = torch.cuda.CUDAGraph()
        with kernels.launch_tally() as tally:
            with torch.cuda.graph(g):
                st.mini_step = pos
                tx.update_(params, grads, st)
        st.mini_step = 0
        graphs.append(g)
        tallies.append({f.__name__: n for f, n in tally.items()})
    assert tallies[:3] == [{"accumulate_": 1}] * 3
    assert tallies[3] == {"accumulate_": 1, "adamw_update_": 1}
    for step in range(8):
        feed(grads_like(gen, leaves))
        graphs[step % 4].replay()
        tx2.update_(params2, grads2, st2)
    torch.cuda.synchronize()
    check_bits("graph against eager", state_tensors(params, st), state_tensors(params2, st2))


def test_adamw_k8_rejects_bad_leaves(gen):
    """No fallback on the card: a non-contiguous leaf, a grad in another
    dtype than its param, an int param and coefficients on the CPU raise."""
    from vats_tpu_torch.ops import adamw as aw

    opt = card_adamw(torch.bfloat16)
    p = [rand(gen, 8, 6)]
    st = opt.init(dict(enumerate(p)))
    k = opt.coefficients(st.count, torch.ones((), dtype=torch.bool, device="cuda"))
    leaves = lambda q, g: (q, g, list(st.mu.values()), list(st.nu.values()))  # noqa: E731
    call = lambda q, g, kk=k: aw.adamw_update_(*leaves(q, g), kk, 1e-6, 0.0,  # noqa: E731
                                               tables=aw.LeafTables())
    with pytest.raises(ValueError, match="contiguous"):
        call([p[0].t().contiguous().t()], [torch.zeros_like(p[0])])
    with pytest.raises(ValueError, match="must be the param's"):
        call(p, [torch.zeros_like(p[0], dtype=torch.bfloat16)])
    with pytest.raises(ValueError, match="fp32 or bf16"):
        aw.accumulate_([torch.zeros(4, dtype=torch.int32, device="cuda")],
                       [torch.zeros(4, dtype=torch.int32, device="cuda")], 1,
                       tables=aw.LeafTables())
    with pytest.raises(ValueError, match="one device"):
        call(p, [torch.zeros_like(p[0])], aw.Coeffs(*(t.cpu() for t in k)))


# --- two layers of each model at full width, bf16: the card against the CPU --
# The tiny fp32 tests above hold these paths to fp32 rounding; these hold
# them at the models' own widths, where the card and the CPU round bf16 at
# other places (torch_card_parity's limits).


@pytest.fixture
def no_tf32():
    """fp32 products in full fp32 on the card (cuBLAS and cuDNN), as on the CPU."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def card_and_cpu(cls, cfg, seed):
    """The model on the card from ``seed``, and the same weights on the CPU."""
    gpu = cls(cfg, device="cuda", seed=seed)
    cpu = cls(cfg, device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, assign=True)
    return gpu, cpu


def nlp_medium_moe(**kw):
    """nlp_medium as the serving cells run it: 8 experts top-2, bf16 params."""
    from vats_tpu_torch.configs import nlp_medium

    return nlp_medium(dropout=0.0, num_experts=8, top_k=2, param_dtype="bfloat16",
                      capacity_factor=1.25, gradient_checkpointing=False, left_window=-1,
                      use_mqa=False, **kw)


def _paged_logits(model, ids, mask, gen_tokens, steps):
    """[B, steps, V] fp32 logits on the CPU: the paged prefill's readout,
    then ``steps - 1`` decode forwards fed ``gen_tokens``."""
    cfg = model.cfg
    b, t = ids.shape
    cache = da.PagedKVCache.create(cfg.num_layers, b, t + steps, cfg.query_groups,
                                   cfg.head_dim, page_size=128, dtype=torch.bfloat16,
                                   device=model.device)
    last = torch.clamp(mask.sum(1) - 1, min=0)
    out = []
    with torch.no_grad():
        lg, cache, _ = model(ids, padding_mask=mask, paged_cache=cache, readout_positions=last)
        out.append(lg[:, 0].float().cpu())
        for s in range(steps - 1):
            lg, cache, _ = model(gen_tokens[:, s:s + 1], paged_cache=cache)
            out.append(lg[:, 0].float().cpu())
    return torch.stack(out, 1)


def _dense_logits(model, ids, mask, gen_tokens, steps):
    """As ``_paged_logits`` through the dense cache."""
    b, t = ids.shape
    cache = model.init_cache(b, t + steps)
    valid = torch.zeros((b, t + steps), dtype=torch.bool, device=model.device)
    valid[:, :t] = mask
    last = torch.clamp(mask.sum(1) - 1, min=0)
    out = []
    with torch.no_grad():
        lg, cache, _ = model(ids, padding_mask=valid, cache=cache, readout_positions=last)
        out.append(lg[:, 0].float().cpu())
        for s in range(steps - 1):
            valid[:, t + s] = True
            lg, cache, _ = model(gen_tokens[:, s:s + 1], padding_mask=valid, cache=cache)
            out.append(lg[:, 0].float().cpu())
    return torch.stack(out, 1)


def test_nlp_medium_two_layers_generate_on_the_card_as_on_the_cpu(gen, no_tf32):
    """nlp_medium (E8 top-2, bf16) at 2 layers: greedy ``generate_paged`` and
    ``generate`` over prompts of 300 and 260 tokens, 8 steps, on the card
    (kernels, decode replayed from graphs) and on the CPU (plain versions)
    from the same weights.  Teacher-forced on the CPU's tokens, every step's
    logits within LOGIT_ATOL but at most ROUTER_EXCUSED (row, step) whose
    MoE router picks other experts on a near tie (``router_flips``); greedy
    tokens equal or a near tie (``compare_greedy``)."""
    import torch_card_parity as parity

    from vats_tpu_torch.inference import generate, generate_paged
    from vats_tpu_torch.models import TextLM

    cfg = nlp_medium_moe(num_layers=2)
    steps, t = 8, 300
    gpu, cpu = card_and_cpu(TextLM, cfg, 7)
    gpu.eval(), cpu.eval()
    g = torch.Generator(device="cpu").manual_seed(99)
    lens = torch.tensor([t, 260])
    ids = torch.randint(1, cfg.vocab_size, (2, t), generator=g)
    mask = torch.arange(t)[None, :] < lens[:, None]
    ids = torch.where(mask, ids, 0).to(torch.int32)
    kw = dict(max_new_tokens=steps, temperature=0.0, do_sample=False, pad_token_id=0)
    for name, fn, logits_fn in (("generate_paged", generate_paged, _paged_logits),
                                ("generate", generate, _dense_logits)):
        tc, lc = fn(cpu, ids, mask, None, **kw)
        tg, lg = fn(gpu, ids.cuda(), mask.cuda(), None, **kw)
        assert torch.equal(lc, lg.cpu()), f"{name}: lengths differ between CPU and card"
        start = lens if name == "generate_paged" else torch.full((2,), t)
        gen_c, gen_g = (torch.stack([x[r, int(start[r]):int(start[r]) + steps]
                                     for r in range(2)]) for x in (tc, tg.cpu()))
        runs = {}
        for side, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
            calls, handles = parity.router_log(model)
            logits = logits_fn(model, ids.to(dev), mask.to(dev), gen_c.to(dev), steps)
            for h in handles:
                h.remove()
            runs[side] = (logits, calls)
        (logit_c, calls_c), (logit_g, calls_g) = runs["cpu"], runs["cuda"]
        excused, flips, gap_max = parity.router_flips(name, calls_g, calls_c, cfg.num_layers,
                                                      t, mask.sum(1) - 1, steps)
        errs = (logit_c - logit_g).abs().amax(dim=-1)  # [B, steps]
        held = torch.ones_like(errs, dtype=torch.bool)
        for r, s_ in excused:
            held[r, s_] = False
        err = float(errs[held].max())
        assert err <= parity.LOGIT_ATOL and bool(torch.isfinite(logit_g).all()), \
            f"{name}: step logits differ by {err:.3e}"
        exact, ties, free = parity.compare_greedy(name, gen_g, gen_c, logit_c, logit_g)
        print(f"{name}: max |logit err| {err:.3e}; router gap by layer {gap_max}; near-tie "
              f"flips {flips or 'none'}, excusing {sorted(excused)}; teacher-forced tokens "
              f"{exact}/{2 * steps} equal, {ties} near ties; free-running equal for {free}")


def test_nlp_medium_int8_engine_on_the_card_matches_the_cpu(gen, no_tf32):
    """nlp_medium (E8 top-2, bf16) at 2 layers through the serving engine
    with int8 KV pages: 8 requests (4 sharing a 128-token prefix; the
    unshared prompts end just below a page, so their rows grow into a
    second one and the 7-page pool runs dry: a preemption) on the card (K4,
    replayed graphs; logits from an eager drive whose tokens equal the graph
    drive's) and on the CPU (plain version).  The logits of every forward
    up to the first differing argmax are finite, and the greedy tokens agree
    at 90% of the positions or more."""
    import torch_card_parity as parity

    from vats_tpu_torch.inference import ServingEngine
    from vats_tpu_torch.models import TextLM

    cfg = nlp_medium_moe(num_layers=2)
    gpu, cpu = card_and_cpu(TextLM, cfg, 11)
    gpu.eval(), cpu.eval()
    stream = parity.serve_stream(77, cfg.vocab_size, 4, 4, 128, (8, 40), (118, 127), (10, 16))
    engine_kw = dict(max_batch=4, max_context=512, page_size=128, total_pages=1 + 7,
                     prefix_caching=True, kv_quant="int8", decode_block_steps=2,
                     prompt_buckets=(64, 128, 256))
    res = {}
    for name, model, use_graphs in (("cuda", gpu, True), ("cuda eager", gpu, False),
                                    ("cpu", cpu, False)):
        logits = []
        handle = None if use_graphs else model.register_forward_hook(
            lambda m, a, out: logits.append(out[0][:, -1].float().cpu()))
        engine = ServingEngine(model, **engine_kw)
        engine.graphs.use_graph = use_graphs
        rids = [engine.submit(p, max_new_tokens=n) for p, n in stream]
        out = engine.run()
        if handle is not None:
            handle.remove()
        res[name] = ([out[r] for r in rids], logits, engine)
    (tok_g, _, eng_g), (tok_e, lg_g, _), (tok_c, lg_c, _) = (
        res["cuda"], res["cuda eager"], res["cpu"])
    assert len(eng_g.graphs) > 0 and tok_g == tok_e
    assert eng_g.preemptions >= 1 and eng_g.prefix_cache.hit_tokens > 0
    assert len(lg_g) == len(lg_c), "the two engines ran other schedules"
    errs = []
    for a, b_ in zip(lg_g, lg_c):  # forwards up to the first differing argmax
        assert bool(torch.isfinite(a).all())
        errs.append(float((a - b_).abs().max()))
        if not torch.equal(a.argmax(-1), b_.argmax(-1)):
            break
    n_tok = sum(len(x) for x in tok_c)
    agree = sum(int(x == y) for tg, tc in zip(tok_g, tok_c) for x, y in zip(tg, tc))
    print(f"per-forward max |logit err| before the first differing argmax "
          f"{[round(e, 4) for e in errs]}; greedy tokens equal {agree}/{n_tok}")
    assert agree / n_tok >= 0.9


def test_medium_dense_two_layers_train_steps_on_the_card_match_the_cpu(gen, no_tf32):
    """medium_dense (the JAX bench's training tier: d1440, vocab 65536, remat
    'dots', fused CE 128, bf16 AdamW mu) at 2 layers, B=2, T=512 (one row
    padded by 40), dropout 0: three train steps on the card (K2', K5a, K5b)
    and on the CPU from the same weights and batch.  After each step: the
    loss within PARITY_LOSS_ATOL, the grad norm within PARITY_NORM_RTOL,
    every param within 2 x the lr applied so far; each parameter's gradient
    and its change since the start within PARITY_LEAF_*."""
    import torch_card_parity as parity

    from vats_tpu_torch.configs import TrainingArgs, nlp_medium
    from vats_tpu_torch.models import TextLM
    from vats_tpu_torch.train import create_optimizer, create_train_state, make_train_step

    b, t = 2, 512
    cfg = nlp_medium(dropout=0.0, left_window=-1, use_mqa=False, gradient_checkpointing=True,
                     capacity_factor=1.25, max_seq_len=t, remat_policy="dots", num_experts=1,
                     top_k=1, num_layers=2)
    targs = TrainingArgs(grad_accum_steps=1, fused_ce_chunk=128, adam_mu_dtype="bfloat16")
    gpu, cpu = card_and_cpu(TextLM, cfg, 5)
    # warmup int(0.05 * 20) = 1: step 0 runs at lr 0, steps 1-2 at ~6e-4
    sched = create_optimizer(targs, 20).schedule
    runs = {name: (model, create_train_state(model, create_optimizer(targs, 20)),
                   make_train_step(model, targs)) for name, model in (("cuda", gpu), ("cpu", cpu))}
    g = torch.Generator().manual_seed(11)
    ids = torch.randint(1, cfg.vocab_size, (b, t), generator=g, dtype=torch.int32)
    lens = torch.tensor([t, t - 40])
    mask = torch.arange(t)[None, :] < lens[:, None]
    ids = torch.where(mask, ids, 0)
    labels = torch.cat([ids[:, 1:], torch.full((b, 1), -100, dtype=torch.int32)], 1)
    labels = torch.where(torch.arange(t)[None, :] < (lens - 1)[:, None], labels, -100)
    batch = {"input_ids": ids, "labels": labels, "padding_mask": mask}
    start = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    lr_sum = 0.0
    for i in range(3):
        out = {}
        for name, (model, state, step) in runs.items():
            state, m = step(state, {k: v.to(model.device) for k, v in batch.items()}, 0)
            out[name] = (float(m["loss"]), float(m["grad_norm"]))
        lr_sum += float(sched(i))
        dp = max(float((a.detach().cpu().float() - b_.detach().float()).abs().max())
                 for a, b_ in zip(gpu.parameters(), cpu.parameters()))
        (lg, ng), (lc, nc) = out["cuda"], out["cpu"]
        report = (f"step {i}: loss card {lg:.5f} cpu {lc:.5f}; grad norm card {ng:.5f} cpu "
                  f"{nc:.5f}; max |param diff| {dp:.3e} (limit {2 * lr_sum + 1e-6:.3e})")
        assert (abs(lg - lc) <= parity.PARITY_LOSS_ATOL
                and abs(ng - nc) <= parity.PARITY_NORM_RTOL * nc and dp <= 2 * lr_sum + 1e-6), \
            report
        print(report + "; " + parity.leaf_report(
            "gradients", parity.leaf_errors(gpu, cpu, parity.leaf_grad),
            parity.PARITY_LEAF_GRAD_RTOL) + "; " + parity.leaf_report(
            "change since the start", parity.leaf_errors(
                gpu, cpu, lambda n, p: p.detach().cpu() - start[n]),
            parity.PARITY_LEAF_CHANGE_RTOL))


# Card (kernels, bf16 compute) against the CPU (plain versions), same
# weights.  The two round bf16 at other places (each product's sum, the
# resize), a few bf16 ulps (2^-8 relative) of activations up to ~5 after two
# (ViT-2D) or four (ViT-3D) layers: features atol 0.1 + rtol 0.02; logits (a
# mean over 576 patches through a 1/sqrt(d) head) atol 0.05 + rtol 0.02.
VISION_FEAT_TOL = dict(atol=0.1, rtol=0.02)
VISION_LOGIT_TOL = dict(atol=0.05, rtol=0.02)


def _features(model, *args, **kw):
    """(final-norm features, output) of a no-grad forward, fp32 on the CPU."""
    got = {}
    h = model.norm.register_forward_hook(lambda m, i, o: got.setdefault("f", o))
    try:
        with torch.no_grad():
            out = model(*args, **kw)
    finally:
        h.remove()
    return got["f"].float().cpu(), out.float().cpu()


def test_vit_medium_width_bf16_on_the_card_matches_the_cpu(gen, no_tf32):
    """ViT-2D at medium width (2 layers, B=2, 1000 classes, remat, bf16
    compute): the eval forward (K2 a layer; features within VISION_FEAT_TOL,
    logits within VISION_LOGIT_TOL) and one train step at dropout 0 without
    augmentation (K2' twice a layer, K5a and K5b once): loss and grad norm
    within PARITY_LOSS_ATOL / PARITY_NORM_RTOL, each parameter's gradient
    and change in the step within PARITY_LEAF_*.  ViT-3D xsmall at its full
    config, B=1, the last 6 of its 32 frames padded: features within
    VISION_FEAT_TOL, and no flash kernel runs (the JAX model attends with
    XLA there)."""
    import torch_card_parity as parity

    from vats_tpu_torch.configs import vit2d_medium, vit3d_xsmall
    from vats_tpu_torch.models import ImageEncoder, VideoTransformer
    from vats_tpu_torch.train import (
        VisionTrainingArgs,
        create_train_state,
        create_vision_optimizer,
        make_vision_train_step,
    )

    cfg = vit2d_medium(num_layers=2, dropout=0.0, num_classes=1000, use_checkpointing=True)
    L = cfg.num_layers
    gpu, cpu = card_and_cpu(ImageEncoder, cfg, 7)
    g = torch.Generator().manual_seed(23)
    x = torch.randn((2, 3, 384, 384), generator=g)
    labels = torch.tensor([3, 997])
    n0 = fa.flash_attention.launches
    fg, lg = _features(gpu, x.cuda())
    assert fa.flash_attention.launches == n0 + L
    fc, lc = _features(cpu, x)
    torch.testing.assert_close(fg, fc, **VISION_FEAT_TOL)
    torch.testing.assert_close(lg, lc, **VISION_LOGIT_TOL)
    args = VisionTrainingArgs(grad_accum_steps=1, use_augmentation=False, warmup_epochs=1,
                              epochs=10)
    start = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    out = {}
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        state = create_train_state(model, create_vision_optimizer(args, 1))
        n1 = (fa.flash_attention_lse.launches, fa.flash_bwd_dkv.launches,
              fa.flash_bwd_dq.launches)
        _, m = make_vision_train_step(model, args, 1000)(
            state, {"images": x.to(model.device), "labels": labels.to(model.device)}, 0)
        out[name] = (float(m["loss"]), float(m["grad_norm"]))
        if name == "cuda":
            assert (fa.flash_attention_lse.launches - n1[0], fa.flash_bwd_dkv.launches - n1[1],
                    fa.flash_bwd_dq.launches - n1[2]) == (2 * L, L, L)
    (lgpu, ngpu), (lcpu, ncpu) = out["cuda"], out["cpu"]
    assert abs(lgpu - lcpu) <= parity.PARITY_LOSS_ATOL
    assert abs(ngpu - ncpu) <= parity.PARITY_NORM_RTOL * ncpu
    print(parity.leaf_report("gradients", parity.leaf_errors(gpu, cpu, parity.leaf_grad),
                             parity.PARITY_LEAF_GRAD_RTOL))
    print(parity.leaf_report("change in the step", parity.leaf_errors(
        gpu, cpu, lambda n, p: p.detach().cpu() - start[n]), parity.PARITY_LEAF_CHANGE_RTOL))
    del gpu, cpu

    cfg = vit3d_xsmall(dropout=0.0)
    gpu, cpu = card_and_cpu(VideoTransformer, cfg, 9)
    th, tw = cfg.target_size
    x = torch.randn((1, 3, cfg.max_frames, th, tw), generator=g)
    fm = torch.ones((1, cfg.max_frames), dtype=torch.bool)
    fm[:, -6:] = False
    n0 = (fa.flash_attention.launches, fa.flash_attention_lse.launches)
    with torch.no_grad():
        fgpu = gpu(x.cuda(), frame_mask=fm.cuda()).float().cpu()
        fcpu = cpu(x, frame_mask=fm).float()
    assert (fa.flash_attention.launches, fa.flash_attention_lse.launches) == n0
    torch.testing.assert_close(fgpu, fcpu, **VISION_FEAT_TOL)


# Image generation at image_gen_xsmall's width, 2 layers: 16 text tokens;
# a 16 x 16 grid, 32 teacher-forced steps.  The trainer step runs at 64 px
# (T = 256, still the card's flash path) in fp32: at initialisation the
# codebook rows (uniform in +-1/256) lie within bf16 noise of one another
# seen from a latent of norm ~25, so a bf16 step's argmin would flip at
# hundreds of positions between two devices and take the gradients with it.
IMG_TEXT_T, IMG_PARITY_GRID, IMG_PARITY_FORCED = 16, 16, 32
IMG_PARITY_BN = dict(atol=1e-4, rtol=0.02)
IMG_QUANT_TIE = 1e-5  # an argmin flip's distance gap, relative to |z|^2
# biases of the convolutions in front of a BatchNorm: zero gradient in exact
# arithmetic (the BatchNorm takes the mean out)
IMG_NOISE_LEAVES = tuple(f"encoder.convs.{i}.bias" for i in range(3)) + tuple(
    f"decoder.deconvs.{i}.bias" for i in range(2))


def _forced_image_logits(model, text, tokens, paged, steps):
    """Logits of ``steps`` cached decode forwards fed the start token, then
    ``tokens`` (raster order), one a step: [B, steps, V] fp32 on the CPU."""
    b = text.shape[0]
    n = tokens.shape[1] * tokens.shape[2]
    cache = (model.init_paged_cache(b, n + 1) if paged else model.init_cache(b, n))
    kw = {"paged_cache" if paged else "cache": cache}
    seq = torch.cat([torch.zeros((b, 1), dtype=torch.int32), tokens.reshape(b, -1).cpu()], 1)
    seq = seq.to(model.device)
    out = []
    with torch.no_grad():
        for i in range(steps):
            lg, _ = model(seq[:, i:i + 1], text, grid_w=tokens.shape[2], return_logits=True, **kw)
            out.append(lg[:, 0].float().cpu())
    return torch.stack(out, 1)


def test_image_gen_xsmall_width_on_the_card_matches_the_cpu(gen, no_tf32):
    """image_gen_xsmall's width at 2 layers (bf16), B=2, 16 x 16: greedy
    ``generate_image_tokens`` and ``_paged`` (K3's table mode once a layer
    a step) equal to the CPU's up to a near tie of the CPU's top two
    teacher-forced logits; the logits of 32 teacher-forced cached decode
    steps on both paths within LOGIT_ATOL.  One fp32 ``ImageGenTrainer``
    step at 64 px, B=2 (eager on the card: the quantizer hooks read on the
    host): the loss within PARITY_LOSS_ATOL; a quantizer index flips only
    at a near tie of the CPU's distances (IMG_QUANT_TIE), and where none
    flips each parameter's gradient and change are within PARITY_LEAF_*
    (the biases in front of a BatchNorm held to 1e-2 of their weights'
    gradient norm instead); the BatchNorm statistics within IMG_PARITY_BN."""
    import torch_card_parity as parity

    from vats_tpu_torch.configs import image_gen_xsmall
    from vats_tpu_torch.inference import generate_image_tokens, generate_image_tokens_paged
    from vats_tpu_torch.models import AutoregressiveImageTransformer
    from vats_tpu_torch.train import ImageGenTrainer, ImageGenTrainingArgs

    cfg = image_gen_xsmall(num_layers=2, dropout=0.0)
    gpu, cpu = card_and_cpu(AutoregressiveImageTransformer, cfg, 7)
    gpu.eval(), cpu.eval()
    g = torch.Generator().manual_seed(41)
    text = torch.randn((2, IMG_TEXT_T, cfg.d_model), generator=g).to(torch.bfloat16)
    gh = IMG_PARITY_GRID
    kw = dict(grid_h=gh, grid_w=gh, temperature=0.0, do_sample=False)
    for paged, fn in ((False, generate_image_tokens), (True, generate_image_tokens_paged)):
        counted = ca.paged_decode_prologue.table if paged else ca.dense_decode_prologue.table
        n0 = counted.launches
        tok_g = fn(gpu, text.cuda(), None, None, **kw).cpu()
        assert counted.launches - n0 == cfg.num_layers * gh * gh
        tok_c = fn(cpu, text, None, None, **kw)
        torch.testing.assert_close(
            _forced_image_logits(gpu, text.cuda(), tok_c, paged, IMG_PARITY_FORCED),
            _forced_image_logits(cpu, text, tok_c, paged, IMG_PARITY_FORCED),
            atol=parity.LOGIT_ATOL, rtol=0)
        with torch.no_grad():
            seq = torch.cat([torch.zeros((2, 1), dtype=torch.int32),
                             tok_c.reshape(2, -1)[:, :-1]], 1)
            full, _ = cpu(seq, text, grid_w=gh, return_logits=True)
        top2 = full.topk(2, dim=-1).values
        first = parity.first_difference_is_a_near_tie(
            f"paged={paged}", tok_g.reshape(2, -1), tok_c.reshape(2, -1),
            top2[..., 0] - top2[..., 1])
        print(f"paged={paged}: greedy tokens equal up to step {first}")
    del gpu, cpu

    tcfg = image_gen_xsmall(num_layers=2, dropout=0.0, target_size=64, dtype="float32")
    targs = ImageGenTrainingArgs(seed=3)
    tg = ImageGenTrainer(tcfg, targs, num_training_steps=10, device="cuda")
    tg.graphs.use_graph = False
    tc = ImageGenTrainer(tcfg, targs, num_training_steps=10,
                         variables={k: v.cpu() for k, v in tg.model.state_dict().items()},
                         device="cpu")
    start = {n: p.detach().clone() for n, p in tc.model.named_parameters()}
    batch = {"images": torch.rand((2, 3, 64, 64), generator=g),
             "text_embeddings": torch.randn((2, IMG_TEXT_T, tcfg.d_model),
                                            generator=g).to(torch.bfloat16)}
    seen = {}  # the quantizer's input and indices on each side

    def keep_quantizer(side):
        def hook(mod, args, out):
            seen[side] = (args[0].detach().float().cpu(), out[2].cpu())
        return hook

    hooks = [tg.model.quantizer.register_forward_hook(keep_quantizer("cuda")),
             tc.model.quantizer.register_forward_hook(keep_quantizer("cpu"))]
    L = tcfg.num_layers
    n1 = (fa.flash_attention_lse.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
    mg = tg.train_step({k: v.cuda() for k, v in batch.items()})
    assert (fa.flash_attention_lse.launches - n1[0], fa.flash_bwd_dkv.launches - n1[1],
            fa.flash_bwd_dq.launches - n1[2]) == (2 * L, L, L)
    mc = tc.train_step(batch)
    for h in hooks:
        h.remove()
    (_, ig), (zc, ic) = seen["cuda"], seen["cpu"]
    flips = (ig != ic).reshape(-1).nonzero()[:, 0]
    cb = tc.model.quantizer.embedding.detach().float()
    zf = zc.reshape(-1, zc.shape[-1])
    for pos in flips.tolist():
        d2 = ((zf[pos][None, :] - cb[[int(ig.reshape(-1)[pos]), int(ic.reshape(-1)[pos])]])
              ** 2).sum(-1)
        assert float(d2[0] - d2[1]) <= IMG_QUANT_TIE * float((zf[pos] ** 2).sum()), pos
    assert abs(mg["loss"] - mc["loss"]) <= parity.PARITY_LOSS_ATOL
    grads = parity.leaf_errors(tg.model, tc.model, parity.leaf_grad)
    change = parity.leaf_errors(tg.model, tc.model, lambda n, p: p.detach().cpu() - start[n])
    keep = lambda errs: {n: e for n, e in errs.items() if n not in IMG_NOISE_LEAVES}  # noqa: E731
    if len(flips):  # a flip moves that position's code and the gradients with it
        print(f"{len(flips)} quantizer indices flipped at near ties: leaf checks excused")
    else:
        print(parity.leaf_report("gradients", keep(grads), parity.PARITY_LEAF_GRAD_RTOL))
        print(parity.leaf_report("change in the step", keep(change),
                                 parity.PARITY_LEAF_CHANGE_RTOL))
    for name in IMG_NOISE_LEAVES:
        w = name.replace(".bias", ".weight")
        for side in (dict(tc.model.named_parameters()), dict(tg.model.named_parameters())):
            assert float(side[name].grad.norm()) <= 1e-2 * float(side[w].grad.norm()), name
    sg, sc = tg.model.state_dict(), tc.model.state_dict()
    for n in (n for n in sc if "running_" in n):
        torch.testing.assert_close(sg[n].cpu(), sc[n], **IMG_PARITY_BN)


# Video generation at video_gen_large's width (d1728, 12/4 heads of 144), 2
# layers, the latent grid cut to 4 x 4 (the CPU runs every step's full-frame
# forward), 8 text tokens, 2 latent frames; the trainer step in fp32, as the
# image trainer's.
VID_TEXT_T, VID_FRAMES, VID_PARITY_GRID = 8, 2, 4


def test_video_gen_large_width_on_the_card_matches_the_cpu(gen, no_tf32):
    """video_gen_large's width at 2 layers on a 4 x 4 grid, B=2 (bf16):
    greedy ``generate_video_tokens`` over 2 frames (K3's append mode once a
    layer a cached forward) equal to the CPU's up to a near tie; the logits
    of the cached forwards append frame 0, read frame 1, append frame 1
    (fed the CPU's tokens) within LOGIT_ATOL.  One fp32 ``VideoTokenTrainer``
    step at B=1 over 15 latent frames: the loss within PARITY_LOSS_ATOL,
    each parameter's gradient and change within PARITY_LEAF_*."""
    import torch_card_parity as parity

    from vats_tpu_torch.configs import video_gen_large
    from vats_tpu_torch.inference import generate_video_tokens
    from vats_tpu_torch.models import AutoregressiveVideoTransformer
    from vats_tpu_torch.train import VideoGenTrainingArgs, VideoTokenTrainer

    gh = VID_PARITY_GRID
    cfg = video_gen_large(num_layers=2, dropout=0.0, latent_height=gh, latent_width=gh)
    gpu, cpu = card_and_cpu(AutoregressiveVideoTransformer, cfg, 7)
    gpu.eval(), cpu.eval()
    g = torch.Generator().manual_seed(43)
    text = torch.randn((2, VID_TEXT_T, cfg.d_model), generator=g).to(torch.bfloat16)
    kw = dict(num_frames=VID_FRAMES, temperature=0.0, do_sample=False)
    n0 = ca.append_token_inplace.launches
    tok_g = generate_video_tokens(gpu, text.cuda(), None, None, **kw).cpu()
    assert ca.append_token_inplace.launches - n0 == 2 * VID_FRAMES * (gh * gh + 1)
    tok_c = generate_video_tokens(cpu, text, None, None, **kw)
    flat = tok_c.reshape(2, -1)
    seq = torch.cat([torch.zeros((2, 1), dtype=torch.int32), flat[:, :-1]], 1).reshape(
        tok_c.shape)

    def cached(model):
        cache = model.init_cache(2)
        s = seq.to(model.device)
        out = []
        with torch.no_grad():
            for f, mode in ((0, "append"), (1, "read"), (1, "append")):
                lg, _ = model(s[:, f:f + 1], text.to(model.device), cache=cache,
                              cache_mode=mode, return_logits=True)
                out.append(lg.float().cpu())
        return torch.stack(out)

    torch.testing.assert_close(cached(gpu), cached(cpu), atol=parity.LOGIT_ATOL, rtol=0)
    with torch.no_grad():
        full, _ = cpu(seq, text, return_logits=True)
    top2 = full.reshape(2, flat.shape[1], -1).topk(2, dim=-1).values
    first = parity.first_difference_is_a_near_tie("video", tok_g.reshape(2, -1), flat,
                                                  top2[..., 0] - top2[..., 1])
    print(f"greedy tokens equal up to step {first}")
    del gpu, cpu

    tcfg = video_gen_large(num_layers=2, dropout=0.0, latent_height=gh, latent_width=gh,
                           dtype="float32")
    lat_t = tcfg.max_frames // tcfg.patch_size[0]
    targs = VideoGenTrainingArgs(seed=3)
    tg = VideoTokenTrainer(tcfg, targs, num_training_steps=10, device="cuda")
    tc = VideoTokenTrainer(tcfg, targs, num_training_steps=10,
                           params={k: v.cpu() for k, v in tg.model.state_dict().items()},
                           device="cpu")
    start = {n: p.detach().clone() for n, p in tc.model.named_parameters()}
    batch = {"indices": torch.randint(0, tcfg.num_embeddings, (1, lat_t, gh, gh), generator=g),
             "text_embeddings": torch.randn((1, VID_TEXT_T, tcfg.d_model), generator=g)}
    lg_, lc_ = tg.train_step({k: v.cuda() for k, v in batch.items()}), tc.train_step(batch)
    assert abs(lg_ - lc_) <= parity.PARITY_LOSS_ATOL
    print(parity.leaf_report("gradients", parity.leaf_errors(tg.model, tc.model,
                                                             parity.leaf_grad),
                             parity.PARITY_LEAF_GRAD_RTOL))
    print(parity.leaf_report("change in the step", parity.leaf_errors(
        tg.model, tc.model, lambda n, p: p.detach().cpu() - start[n]),
        parity.PARITY_LEAF_CHANGE_RTOL))


def test_multimodal_small_width_on_the_card_matches_the_cpu(gen, no_tf32):
    """multimodal_small's width at 2 layers with 2 video frames (256 image +
    512 video tokens a row, bf16): greedy ``generate_multimodal`` over the
    ragged prompts 256/200/131/17 (the card's prefill through K2, its decode
    through K3's paged table mode and K1) equal to the CPU's codes up to a
    near tie of the CPU's masked top two logits; the logits of the prefill's
    readout and of 32 decode steps fed the CPU's tokens within LOGIT_ATOL."""
    import torch_card_parity as parity

    from vats_tpu_torch.configs import multimodal_small
    from vats_tpu_torch.inference import generate_multimodal
    from vats_tpu_torch.models import MultimodalLM

    cfg = multimodal_small(num_layers=2, video_grid_t=2)
    vt, vi = cfg.text_vocab_size, cfg.image_vocab_size
    n_img, n_total = cfg.image_tokens, cfg.image_tokens + cfg.video_tokens
    gpu, cpu = card_and_cpu(MultimodalLM, cfg, 9)
    gpu.eval(), cpu.eval()
    ragged = (256, 200, 131, 17)
    b, t_long = len(ragged), ragged[0]
    lens = torch.tensor(ragged)
    mask = torch.arange(t_long)[None, :] < lens[:, None]
    ids = torch.where(mask, torch.randint(1, vt, (b, t_long),
                                          generator=torch.Generator().manual_seed(47)), 0)
    kw = dict(temperature=0.0, do_sample=False)
    n0 = (fa.flash_attention.launches, ca.paged_decode_prologue.table.launches)
    out_g = generate_multimodal(gpu, ids.cuda(), mask.cuda(), None, **kw)
    assert (fa.flash_attention.launches - n0[0],
            ca.paged_decode_prologue.table.launches - n0[1]) == (
        cfg.num_layers, cfg.num_layers * (n_total - 1))
    out_c = generate_multimodal(cpu, ids, mask, None, **kw)
    flat = lambda o: torch.cat([o[0].reshape(b, -1).cpu() + vt,  # noqa: E731
                                o[1].reshape(b, -1).cpu() + vt + vi], 1)
    gen_g, gen_c = flat(out_g), flat(out_c)
    pre_mod = torch.zeros((b, t_long), dtype=torch.int32)
    pre_loc = torch.arange(t_long, dtype=torch.int32)[None, :].expand(b, -1)

    def forced(model, steps=min(32, n_img)):
        dev = model.device
        full = lambda x: torch.full((b, 1), x, dtype=torch.int32, device=dev)  # noqa: E731
        cache = model.init_paged_cache(b, t_long + n_total)
        out = []
        with torch.no_grad():
            lg, _ = model(ids.to(dev), pre_mod.to(dev), pre_loc.to(dev),
                          padding_mask=mask.to(dev), paged_cache=cache,
                          readout_positions=(lens - 1).to(dev))
            out.append(lg[:, 0].float().cpu())
            for i in range(steps):
                lg, _ = model(gen_c[:, i:i + 1].to(dev), full(1), full(i), paged_cache=cache)
                out.append(lg[:, 0].float().cpu())
        return torch.stack(out, 1)

    torch.testing.assert_close(forced(gpu), forced(cpu), atol=parity.LOGIT_ATOL, rtol=0)
    # the CPU's masked top-two gaps along its own streams (uncached forwards)
    vocab = torch.arange(cfg.vocab_size)
    gaps = torch.empty((b, n_total))
    with torch.no_grad():
        for r in range(b):
            n_ = int(lens[r])
            seq = torch.cat([ids[r, :n_], gen_c[r]])[None]
            mod = torch.cat([torch.zeros(n_), torch.ones(n_img),
                             torch.full((n_total - n_img,), 2)]).to(torch.int32)[None]
            loc = torch.cat([torch.arange(n_), torch.arange(n_img),
                             torch.arange(n_total - n_img)]).to(torch.int32)[None]
            lg, _ = cpu(seq, mod, loc)
            lg = lg[0, n_ - 1:n_ - 1 + n_total]
            img_rows = torch.arange(n_total)[:, None] < n_img
            lo = torch.where(img_rows, vt, vt + vi)
            hi = torch.where(img_rows, vt + vi, cfg.vocab_size)
            top2 = torch.where((vocab >= lo) & (vocab < hi), lg, float("-inf")).topk(2).values
            gaps[r] = top2[:, 0] - top2[:, 1]
    first = parity.first_difference_is_a_near_tie("multimodal", gen_g, gen_c, gaps)
    print(f"greedy codes equal up to step {first}")


# --- K9: absorbed latent decode (ops/mla_decode.py) ---------------------------


@pytest.mark.parametrize("b,h,layer,lengths", [
    # v2lite.reasoning_256's decode: 256 rows, 16 heads, lengths 1-12,288,
    # the 64-token stages' and 128-token tiles' edges and a chunk's first
    (256, 16, 1, [1, 2, 63, 64, 65, 127, 128, 129, 767, 768, 769, 3071, 3072, 3073, 12287,
                  12288]),
    (5, 3, 0, [0, 1, 700, 5000, 12288]),  # fewer heads, an empty row
])
def test_k9_matches_its_plain_version(gen, b, h, layer, lengths):
    """K9 against its plain version within TOL plus ``mla_p_allowance`` (the
    two round p to bf16 against different maxima), a second call bit for
    bit, at the published widths (576-wide latent, 512-wide values, pages
    of 128, 96 pages a row: 12,288 tokens)."""
    from torch_card_parity import check_close, mla_p_allowance
    from vats_tpu_torch.ops import mla_decode as md

    ps, pps, w, r, scale = 128, 96, 576, 512, 0.11472
    lens = lengths + torch.randint(1, ps * pps + 1, (b - len(lengths),), generator=gen,
                                   device="cuda").tolist()
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    pages = rand(gen, 2, b * pps + 1, ps, w, dtype=torch.bfloat16)
    table = (1 + torch.randperm(b * pps, generator=gen, device="cuda")).to(
        torch.int32).reshape(b, pps)
    q = rand(gen, b, h, w, dtype=torch.bfloat16)
    before = (md.mla_decode_attention.launches, md.mla_decode_attention.plain.launches)
    got = md.mla_decode_attention(q, pages, layer, table, lengths, scale=scale, v_dim=r)
    assert (md.mla_decode_attention.launches - before[0],
            md.mla_decode_attention.plain.launches - before[1]) == (1, 0)
    want = md.mla_decode_attention_ref(q, pages[layer], table, lengths, scale=scale, v_dim=r)
    limit = dict(TOL[torch.bfloat16],
                 extra=mla_p_allowance(q, pages[layer], table, lengths, scale, r))
    check_close("K9", got, want, limit)
    assert torch.equal(got, md.mla_decode_attention(q, pages, layer, table, lengths,
                                                    scale=scale, v_dim=r))
    if 0 in lens:
        assert torch.equal(got[lens.index(0)], torch.zeros_like(got[0]))


@pytest.mark.parametrize("bad", ["fp32", "heads", "width", "v_dim", "page"])
def test_k9_refuses_what_it_does_not_take(gen, bad):
    """On the card a call K9 does not take raises (no plain fallback there):
    an fp32 pool, 17 heads, another latent width, another value width, pages
    of 64 tokens."""
    from vats_tpu_torch.ops import mla_decode as md

    b, h, w, r, ps, pps = 2, 16, 576, 512, 128, 2
    h, w, r, ps = {"heads": (17, w, r, ps), "width": (h, 320, 256, ps),
                   "v_dim": (h, w, 256, ps), "page": (h, w, r, 64)}.get(bad, (h, w, r, ps))
    dt = torch.float32 if bad == "fp32" else torch.bfloat16
    pages = rand(gen, 1, b * pps, ps, w, dtype=dt)
    table = torch.arange(b * pps, dtype=torch.int32, device="cuda").reshape(b, pps)
    lengths = torch.full((b,), 5, dtype=torch.int32, device="cuda")
    q = rand(gen, b, h, w, dtype=dt)
    before = (md.mla_decode_attention.launches, md.mla_decode_attention.plain.launches)
    with pytest.raises(ValueError, match="K9 takes"):
        md.mla_decode_attention(q, pages, 0, table, lengths, scale=0.1, v_dim=r)
    assert (md.mla_decode_attention.launches, md.mla_decode_attention.plain.launches) == before


def test_deepseek_v2_lite_engine_equals_the_reference_at_full_width(gen):
    """DeepSeek-V2-Lite whole (27 layers, bf16, the benchmark's seeded
    weights) through the engine: grouped prefills into the latent pool,
    decode blocks from graphs through K9 and K7; each served greedy token's
    logit under the fp32 reference (``benchmark/reference/deepseek_v2.py``,
    TF32 off) lies below the best by no more, on average, than the cell's
    limit (``benchmark/limits/v2lite.reasoning_256.json``)."""
    import dataclasses
    import json
    import os

    import numpy as np

    from benchmark.reference.deepseek_v2 import DeepSeekV2Reference, make_params
    from benchmark.reference.model import no_tf32
    from vats_tpu_torch.configs import deepseek_v2_lite
    from vats_tpu_torch.inference import ServingEngine
    from vats_tpu_torch.models import TextLM

    cfg = deepseek_v2_lite()
    m = dataclasses.asdict(cfg)
    params = make_params(m, 2027, torch.bfloat16, "cuda")
    model = TextLM(cfg, device="meta")
    model.load_state_dict(params, assign=True)
    eng = ServingEngine(model.eval(), max_batch=4, max_context=2048, decode_block_steps=4,
                        prompt_buckets=(512, 2048), max_prefill_tokens=4096)
    lens = [37, 300, 900, 1500]
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen, device="cuda").tolist()
               for n in lens]
    rids = [eng.submit(p, 48) for p in prompts]
    out = eng.run()
    del eng, model
    torch.cuda.empty_cache()
    no_tf32()
    ref = DeepSeekV2Reference(m, params)
    seqs = [torch.tensor(p + out[r][:-1], device="cuda") for p, r in zip(prompts, rids)]
    gaps = []
    for p, r, h in zip(prompts, rids, ref.hidden_all(seqs)):
        logits = ref.readout(h[len(p) - 1:])
        served = torch.tensor(out[r], device="cuda")
        gaps.append((logits.max(-1).values - logits.gather(1, served[:, None])[:, 0]).cpu())
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "benchmark", "limits", "v2lite.reasoning_256.json")) as f:
        limit = json.load(f)["mean_logit_gap"]
    mean = float(np.mean(torch.cat(gaps).numpy()))
    assert mean <= limit, (mean, [float(g.max()) for g in gaps])
