"""Decode steps replayed from CUDA graphs against the same steps run eagerly,
on the card (``inference/graphs.py``).

These need an NVIDIA GPU and ``nvcc``; without them every test here skips.
This file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py

Tolerance: none.  A replay runs the kernels the eager step launches, on the
same inputs and in the same order, and draws from the same generator state,
so tokens and lengths are bit-equal.  Also: launch counts are the eager
warm-up's plus the capture's tally times the replays; two graphs on one
stream, and an eager K1 call on another stream during replays, keep their own
K1 counters; a capture that meets a host sync raises.
"""

import pytest
import torch

from vats_tpu_torch.ops import cache_append as ca
from vats_tpu_torch.ops import decode_attention as da

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's hand-written kernels)")
    return torch.Generator(device="cuda").manual_seed(0)


def tiny_model(seed=3, **kw):
    from vats_tpu_torch.configs import ModelArgs
    from vats_tpu_torch.models import TextLM

    base = dict(d_model=128, num_heads=4, query_groups=2, d_ffn=256, num_layers=3,
                dropout=0.0, vocab_size=256, max_seq_len=512, left_window=-1,
                num_experts=4, top_k=2, capacity_factor=1.25, dtype="bfloat16",
                param_dtype="bfloat16", use_mqa=False, gradient_checkpointing=False)
    base.update(kw)
    return TextLM(ModelArgs(**base), device="cuda", seed=seed).eval()


def ragged(gen, b, t, vocab):
    lens = torch.randint(t // 2, t + 1, (b,), generator=gen, device="cuda")
    ids = torch.randint(1, vocab, (b, t), generator=gen, device="cuda")
    mask = torch.arange(t, device="cuda")[None, :] < lens[:, None]
    return torch.where(mask, ids, 0).to(torch.int32), mask


SAMPLED = dict(do_sample=True, temperature=0.8, top_k=20, top_p=None,
               repetition_penalty=None, approx_top_k=False)
GREEDY = dict(do_sample=False, temperature=0.0, top_k=None, top_p=None,
              repetition_penalty=None, approx_top_k=False)


def graph_and_eager(fn, model, ids, mask, sample, seed, counted, **kw):
    """``fn`` (``_generate`` or ``_generate_paged``) with the graph and
    eagerly, each from a generator seeded with ``seed``; returns both
    results and the launches of ``counted`` each made."""
    out = []
    for use_graph in (True, False):
        g = torch.Generator(device="cuda").manual_seed(seed)
        n0 = counted.launches
        tokens, lengths, graph = fn(model, ids, mask, g, sample, use_graph=use_graph, **kw)
        torch.cuda.synchronize()
        out.append((tokens, lengths, graph, counted.launches - n0))
    return out


@pytest.mark.parametrize("sample", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_generate_dense_graph_equals_eager(gen, sample):
    """Dense cache (K3's fused dense prologue, one launch per layer per
    step); the ring cache of a windowed model as well."""
    from vats_tpu_torch.inference.generate import _generate

    for lw in (-1, 100):
        model = tiny_model(left_window=lw)
        ids, mask = ragged(gen, 3, 140, 256)
        steps = 19
        (tg, lg, graph, n_g), (te, le, none, n_e) = graph_and_eager(
            _generate, model, ids, mask, sample, 11, ca.dense_decode_prologue,
            max_new_tokens=steps, pad_token_id=0, eos_token_id=None, total_len=None)
        assert graph is not None and none is None
        assert torch.equal(tg, te) and torch.equal(lg, le)
        L = model.cfg.num_layers
        assert graph.replays == steps - 1 and graph.tally == {ca.dense_decode_prologue: L}
        assert n_g == n_e == L * steps


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("sample", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_generate_paged_graph_equals_eager(gen, kv_quant, sample):
    """bf16 pages (K1) and int8 pages (K4), each after K3's fused paged
    prologue; an EOS (a check every few replays) and a row that runs out of
    buffer."""
    from vats_tpu_torch.inference.generate import _generate_paged

    model = tiny_model()
    ids, mask = ragged(gen, 5, 200, 256)
    counted = (da.paged_decode_attention_commit_int8 if kv_quant
               else da.paged_decode_attention_commit)
    L, steps = model.cfg.num_layers, 21
    kw = dict(max_new_tokens=steps, pad_token_id=0, page_size=128, kv_quant=kv_quant,
              prefill_row_chunk=None)
    (tg, lg, graph, n_g), (te, le, _, n_e) = graph_and_eager(
        _generate_paged, model, ids, mask, sample, 5, counted, eos_token_id=None,
        total_len=None, **kw)
    assert torch.equal(tg, te) and torch.equal(lg, le)
    assert graph.replays == steps - 1
    assert graph.tally == {counted: L, ca.paged_decode_prologue: L}
    assert n_g == n_e == L * steps
    # an EOS drawn from the run above; total_len cuts the longest rows short
    eos = int(tg[0, int(mask[0].sum()) + 4])
    (tg, lg, _, _), (te, le, _, _) = graph_and_eager(
        _generate_paged, model, ids, mask, sample, 5, counted, eos_token_id=eos,
        total_len=210, **kw)
    assert torch.equal(tg, te) and torch.equal(lg, le)
    assert int(lg.max()) <= 210


def test_moe_sort_dispatch_is_captured(gen):
    """dispatch='sort' counts its experts without a host sync, so its decode
    step captures and replays."""
    from vats_tpu_torch.inference.generate import _generate_paged

    model = tiny_model(moe_dispatch="sort")
    ids, mask = ragged(gen, 4, 64, 256)
    (tg, lg, graph, _), (te, le, _, _) = graph_and_eager(
        _generate_paged, model, ids, mask, GREEDY, 0, da.paged_decode_attention_commit,
        max_new_tokens=9, pad_token_id=0, eos_token_id=None, total_len=None,
        page_size=128, kv_quant=None, prefill_row_chunk=None)
    assert graph.replays == 8
    assert torch.equal(tg, te) and torch.equal(lg, le)


def engine_stream():
    system = [(13 * i) % 250 + 1 for i in range(300)]
    return [(system + [3, 1, 4], 12), ([(5 * i) % 250 + 1 for i in range(122)], 14),
            (system + [2, 7, 1, 8], 6), ([7, 7, 23, 45], 5),
            ([(3 * i) % 250 + 1 for i in range(500)], 30)]


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("mode", ["bf16 KV", "int8 KV", "int8 weights + int8 KV"])
def test_engine_graph_equals_eager(gen, mode, overlap):
    """The engine's 4-step blocks (and the 1-step fallback near the context
    cap) replayed against eager blocks: prefix caching, a preemption,
    greedy rows and keyed sampled rows; K1 or K4, and K3's paged prologue,
    launched once per layer per decode forward."""
    from vats_tpu_torch.inference import QuantizedModel, SamplingParams, ServingEngine

    model = tiny_model()
    if mode.startswith("int8 weights"):
        model = QuantizedModel(model, min_size=1024)
    kv_quant = None if mode == "bf16 KV" else "int8"
    counted = (da.paged_decode_attention_commit_int8 if kv_quant
               else da.paged_decode_attention_commit)
    outs = []
    for use_graphs in (True, False):
        eng = ServingEngine(model, max_batch=2, max_context=512, prefix_caching=True,
                            total_pages=1 + 4, kv_quant=kv_quant, decode_block_steps=4,
                            per_request_sampling=True, overlap_scheduling=overlap)
        eng._use_graphs = use_graphs
        n0, p0 = counted.launches, ca.paged_decode_prologue.launches
        rids = [eng.submit(p, max_new_tokens=n, sampling=SamplingParams(
            temperature=0.7, top_k=10, seed=i) if i % 2 else None)
            for i, (p, n) in enumerate(engine_stream())]
        out = eng.run()
        torch.cuda.synchronize()
        assert eng.preemptions >= 1 and eng.prefix_cache.hit_tokens > 0
        assert counted.launches - n0 == model.cfg.num_layers * eng.forwards["decode"]
        assert (ca.paged_decode_prologue.launches - p0
                == model.cfg.num_layers * eng.forwards["decode"])
        outs.append([out[r] for r in rids])
        if use_graphs:
            assert sorted(eng.graphs) == [1, 4]
            assert sum(k * (1 + g.replays) for k, g in eng.graphs.items()) == \
                eng.forwards["decode"]
    assert outs[0] == outs[1]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_colliding_prefill_appends_are_deterministic(gen, dtype):
    """A serving prefill's padding writes through unmapped table entries onto
    the scratch page 0, and positions past the table clamp onto a row's
    last slot: many writes to one slot.  Every run on the card writes what
    the CPU's sequential loop writes (the last writer's value)."""
    b, t, g, hd = 4, 300, 2, 60
    table = torch.tensor([[0, 0, 0, 0], [1, 2, 0, 0], [3, 4, 5, 6], [7, 0, 0, 0]],
                         dtype=torch.int32)
    lengths = torch.tensor([0, 130, 400, 60], dtype=torch.int32)
    k = torch.randn((b, t, g, hd), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((b, t, g, hd), generator=gen, device="cuda").to(torch.bfloat16)

    def append(device):
        c = da.PagedKVCache.create(2, 8, 128, g, hd, dtype=dtype, device=device)
        c.page_table, c.lengths = table.to(device), lengths.to(device)
        c.append_tokens(1, k.to(device), v.to(device))
        return [x.cpu() for x in (c.kv_pages, c.kv_scales) if x is not None]

    want = append("cpu")
    for _ in range(5):
        got = append("cuda")
        assert all(torch.equal(a, w) for a, w in zip(got, want))


def test_engine_and_its_graphs_are_freed_when_dropped(gen):
    """The graphs reach the engine through a weak proxy: dropping the engine
    frees its page pool and graphs at once, with no cycle left for the
    collector."""
    import gc
    import weakref

    from vats_tpu_torch.inference import ServingEngine

    eng = ServingEngine(tiny_model(), max_batch=2, max_context=512,
                        decode_block_steps=4)
    eng.submit([5, 9, 17], max_new_tokens=9)
    eng.run()
    assert eng.graphs[4].replays >= 1
    refs = [weakref.ref(eng.pool), weakref.ref(eng.graphs[4])]
    gc.disable()
    try:
        del eng
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def _k1_inputs(gen, b, lengths):
    g, n, hd, ps, pps = 8, 3, 60, 128, 8
    pool = torch.randn((2, b * pps, 2, g, ps, 64), generator=gen,
                       device="cuda").to(torch.bfloat16)
    pool[..., hd:] = 0
    table = torch.randperm(b * pps, generator=gen, device="cuda").to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn((b, g * n, hd), generator=gen, device="cuda").to(torch.bfloat16)
    kv = torch.randn((b, g, hd), generator=gen, device="cuda").to(torch.bfloat16)
    return pool, table.reshape(b, pps), lens, q, kv


def _k1_graph(pool, table, lens, q, kv, out):
    from vats_tpu_torch.inference.graphs import StepGraph

    def body():
        out.copy_(da.paged_decode_attention(q, pool, 1, table, lens, scale=0.2,
                                            k_cur=kv, v_cur=kv))

    graph = StepGraph(body, "cuda")
    graph.run()
    return graph


def test_two_graphs_on_one_stream_and_eager_k1_on_another(gen):
    """Two K1 graphs replayed in turns on one stream, and eager K1 calls on
    a second stream while they replay: each graph holds the counters it was
    captured with (not the stream's), so every output equals the call made
    alone."""
    a = _k1_inputs(gen, 6, [1000, 5, 129, 700, 1024, 300])
    b = _k1_inputs(gen, 6, [3, 900, 1024, 128, 640, 1])
    want = [da.paged_decode_attention(q, pool, 1, table, lens, scale=0.2, k_cur=kv,
                                      v_cur=kv) for pool, table, lens, q, kv in (a, b)]
    outs = [torch.zeros_like(w) for w in want]
    graphs = [_k1_graph(*inp, out) for inp, out in zip((a, b), outs)]
    for graph in graphs:
        assert graph.tally == {da.paged_decode_attention: 1}
        assert graph._counters is not None
    assert graphs[0]._counters.data_ptr() != graphs[1]._counters.data_ptr()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    n0 = da.paged_decode_attention.launches
    got, eager = [[], []], []
    for _ in range(20):
        for i, graph in enumerate(graphs):
            graph.replay()
            got[i].append(outs[i].clone())
        with torch.cuda.stream(side):
            pool, table, lens, q, kv = a
            eager.append(da.paged_decode_attention(q, pool, 1, table, lens, scale=0.2,
                                                   k_cur=kv, v_cur=kv))
    torch.cuda.synchronize()
    assert da.paged_decode_attention.launches - n0 == 2 * 20 + 20
    for i in range(2):
        assert all(torch.equal(x, want[i]) for x in got[i])
    assert all(torch.equal(x, want[0]) for x in eager)


def test_capture_with_a_host_sync_raises(gen):
    """No fallback: a step that reads a device value on the host cannot be
    captured, and the capture raises."""
    from vats_tpu_torch.inference.graphs import StepGraph

    x = torch.ones(4, device="cuda")

    def body():
        if bool(x.any()):
            x.mul_(1.0)

    graph = StepGraph(body, "cuda")
    with pytest.raises(RuntimeError):
        graph.run()
    torch.cuda.synchronize()
