"""Steps replayed from CUDA graphs against the same steps run eagerly, on
the card (``inference/graphs.py``, ``train/step_graphs.py``): decode, the
serving engine's prefills and its speculative verify forward, the vision
eval step, and the training programs (the LM train and eval steps, the
ViT-2D train step, the image-gen trainer's step and eval, both video
trainers).

These need an NVIDIA GPU and ``nvcc``; without them every test here skips.
This file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py

Tolerance: none.  A replay runs the kernels the eager step launches, on the
same inputs and in the same order, and draws from the same generator state,
so tokens and lengths are bit-equal.  Also: launch counts are the eager
warm-up's plus the capture's tally times the replays; two graphs on one
stream, and an eager K1 call on another stream during replays, keep their own
K1 counters; a capture that meets a host sync raises.  The engine's graphs
leave its page pool bit-equal to the eager engine's; an eval graph reads
the parameters in place (an optimizer update shows at the next replay) and
captures again for other tensors.  A train graph holds the forward, the
backward and the in-place update: params, moments, counters, BatchNorm
statistics and metrics bit-equal to the eager step's after every step, a
load in place seen at the next replay, a new state captured again, one
gradient buffer a parameter for every key, and a model that keeps a routing
record refused before its capture.
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


def test_moe_routed_decode_is_captured(gen):
    """A lossless model (capacity_factor -1) routes rows through K7 in its
    decode step (two launches a layer, no host sync), so the step captures;
    every replay routes other tokens to other experts, and the graph's
    tokens equal the eager steps' bit for bit."""
    from vats_tpu_torch.inference.generate import _generate_paged
    from vats_tpu_torch.nn.moe import MoELayer
    from vats_tpu_torch.ops import moe_grouped as mg

    model = tiny_model(capacity_factor=-1.0)
    ids, mask = ragged(gen, 5, 100, 256)
    steps = 12
    (tg, lg, graph, n_g), (te, le, _, n_e) = graph_and_eager(
        _generate_paged, model, ids, mask, GREEDY, 0, mg.moe_grouped_gemm,
        max_new_tokens=steps, pad_token_id=0, eos_token_id=None, total_len=None,
        page_size=128, kv_quant=None, prefill_row_chunk=None)
    L = model.cfg.num_layers
    assert graph.replays == steps - 1 and graph.tally[mg.moe_grouped_gemm] == 2 * L
    assert torch.equal(tg, te) and torch.equal(lg, le)
    assert n_g == n_e == 2 * L * (steps + 1)  # the prefill and every decode step
    modes = [m.mode_calls for m in model.modules() if isinstance(m, MoELayer)]
    assert all(set(c) == {"routed"} for c in modes)


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
        eng.graphs.use_graph = use_graphs
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
            decode = {key[1]: g for key, g in eng.graphs.items() if key[0] == "decode"}
            assert sorted(decode) == [1, 4]
            assert sum(k * (1 + g.replays) for k, g in decode.items()) == \
                eng.forwards["decode"]
            assert_prefill_graphs(eng)
    assert outs[0] == outs[1]


def assert_prefill_graphs(eng):
    """One prefill graph per (bucket, rpad) the engine met, each run (its
    warm-up, then replays) once per prefill forward."""
    prefill = {key[1:]: g for key, g in eng.graphs.items() if key[0] == "prefill"}
    assert set(prefill) == eng.prefill_shapes
    assert sum(1 + g.replays for g in prefill.values()) == eng.forwards["prefill"]


def group_stream(vocab):
    """As ``tests/test_torch_serving.py``'s: groups padded to 16, 4, 1, 2
    and 8 rows, and a preempted continuation past the largest bucket."""
    import numpy as np

    rs = np.random.RandomState(5)
    ids = lambda n: rs.randint(1, vocab, n).tolist()  # noqa: E731
    return ([(ids(110), 30), (ids(126), 30)]
            + [(ids(rs.randint(3, 17)), 20) for _ in range(9)]
            + [(ids(rs.randint(17, 33)), 20) for _ in range(4)] + [(ids(50), 20)]
            + [(ids(rs.randint(3, 17)), 6) for _ in range(5)])


def engine_pair(model, stream, **kw):
    """The stream through a graph engine and an eager one: both engines'
    tokens and pools (bf16 pages, or int8 pages and their scales)."""
    from vats_tpu_torch.inference import ServingEngine

    got = []
    for use_graphs in (True, False):
        eng = ServingEngine(model, **kw)
        eng.graphs.use_graph = use_graphs
        rids = [eng.submit(p, max_new_tokens=n) for p, n in stream]
        out = eng.run()
        torch.cuda.synchronize()
        got.append((eng, [out[r] for r in rids]))
    return got


@pytest.mark.parametrize("mode", ["bf16 KV", "int8 KV", "overlap"])
def test_prefill_graphs_equal_eager_for_every_key(gen, mode):
    """Every (bucket, rpad) key of a stream with groups of 1 to 16 rows and a
    continuation past the largest bucket: graph and eager engines give the
    same tokens and leave their pools bit-equal (every prefill's pages)."""
    model = tiny_model()
    kw = dict(max_batch=16, max_context=512, total_pages=1 + 17,
              prompt_buckets=(16, 32, 64, 128), kv_quant="int8" if mode == "int8 KV" else None)
    if mode == "overlap":
        kw.update(decode_block_steps=4, overlap_scheduling=True)
    (eg, tg), (ee, te) = engine_pair(model, group_stream(256), **kw)
    assert tg == te
    assert eg.prefill_shapes == ee.prefill_shapes == {
        (16, 16), (32, 4), (64, 1), (128, 2), (16, 8), (256, 1)}
    assert_prefill_graphs(eg)
    assert len(ee.graphs) == 0 and eg.preemptions == ee.preemptions == 1
    assert torch.equal(eg.pool, ee.pool)
    assert (eg.scales is None) == (mode != "int8 KV")
    if eg.scales is not None:
        assert torch.equal(eg.scales, ee.scales)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_verify_graph_equals_eager(gen, kv_quant):
    """spec_k = 4 (greedy, prefix caching, a preemption): every verify
    forward replays one graph, and the tokens, the drafts' acceptance and
    the pool equal the eager engine's."""
    model = tiny_model()
    kw = dict(max_batch=2, max_context=512, prefix_caching=True, total_pages=1 + 4,
              kv_quant=kv_quant, spec_k=4)
    (eg, tg), (ee, te) = engine_pair(model, engine_stream(), **kw)  # periodic prompts
    assert tg == te and eg.preemptions >= 1
    assert (eg.spec_proposed, eg.spec_accepted) == (ee.spec_proposed, ee.spec_accepted)
    assert eg.spec_accepted > 0
    assert eg.forwards == ee.forwards
    assert eg.graphs[("verify",)].replays + 1 == eg.forwards["verify"]
    assert_prefill_graphs(eg)
    assert torch.equal(eg.pool, ee.pool)


def test_host_sync_in_a_prefill_body_raises(gen):
    """No fallback: a prefill whose forward reads a device value on the host
    cannot be captured, and the engine's call raises."""
    from vats_tpu_torch.inference import ServingEngine

    model = tiny_model()
    eng = ServingEngine(model, max_batch=2, max_context=512)

    def sync(mod, args):
        if args[0].shape[1] > 1:
            bool(args[0].isnan().any())

    handle = model.layers[0].register_forward_pre_hook(sync)
    try:
        eng.submit([5, 9, 17], max_new_tokens=4)
        with pytest.raises(RuntimeError):
            eng.run()
    finally:
        handle.remove()
    torch.cuda.synchronize()
    end_failed_capture()


def end_failed_capture():
    """A capture that raised leaves the CUDA generators it held marked as
    capturing (PyTorch clears the mark at a capture's end), and the next
    draw outside a capture raises; a capture that completes clears it, for
    the tests that follow."""
    x = torch.zeros(1, device="cuda")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        x.add_(1)
    torch.cuda.synchronize()


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
    assert eng.graphs[("decode", 4)].replays >= 1
    refs = [weakref.ref(eng.pool), weakref.ref(eng.graphs[("decode", 4)]),
            weakref.ref(eng.graphs[("prefill", 32, 1)])]
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
    end_failed_capture()


def vision_models():
    """ViT-2D at 256 patches (the flash path: K2, one launch a layer) and
    ViT-3D tiny, each with a 10-class head."""
    from vats_tpu_torch.configs import vit2d_xsmall, vit3d_tiny_test
    from vats_tpu_torch.models import ImageEncoder, VideoTransformer

    return {
        "vit2d": (ImageEncoder(vit2d_xsmall(target_size=256, patch_size=16, num_classes=10),
                               device="cuda", seed=1), (3, 3, 256, 256)),
        "vit3d": (VideoTransformer(vit3d_tiny_test(use_classifier_head=True), device="cuda",
                                   seed=2), (3, 3, 8, 32, 32)),
    }


@pytest.mark.parametrize("kind", ["vit2d", "vit3d"])
def test_eval_step_graphs_equal_eager(gen, kind):
    """The eval step from graphs against ``eval_metrics`` run eagerly, bit
    for bit, on a full batch and a smaller last one (a graph each); ViT-2D's
    replay launches K2 once a layer.  Then an optimizer update in place
    shows at the next replay, and params that are other tensors (a copy)
    capture again."""
    from vats_tpu_torch.ops import flash_attention as fa
    from vats_tpu_torch.train import (
        VisionTrainingArgs,
        create_train_state,
        create_vision_optimizer,
        make_vision_eval_step,
        make_vision_train_step,
    )
    from vats_tpu_torch.train.vision import eval_metrics

    model, shape = vision_models()[kind]
    x = torch.randn(shape, generator=gen, device="cuda")
    y = torch.randint(0, 10, (shape[0],), generator=gen, device="cuda")
    step = make_vision_eval_step(model, 10)
    state = create_train_state(model, create_vision_optimizer(
        VisionTrainingArgs(grad_accum_steps=1, use_augmentation=False, warmup_epochs=1,
                           epochs=4), 1))

    def check(params, images, labels):
        want = eval_metrics(model, params, images, labels, 10)
        n0 = fa.flash_attention.launches
        got = step(params, {"images": images, "labels": labels})
        torch.cuda.synchronize()
        assert torch.equal(torch.stack([got["loss"], got["acc"]]), want)
        return want, fa.flash_attention.launches - n0

    for images, labels in ((x, y), (x[:2], y[:2]), (x, y)):
        _, k2 = check(state.params, images, labels)
        if kind == "vit2d":
            assert k2 == model.cfg.num_layers
    assert sorted(step.graphs) == sorted(step.graphs.entries) and len(step.graphs) == 2
    before = check(state.params, x, y)[0]
    graph = step.graphs[tuple(step.graphs)[0]]
    make_vision_train_step(model, VisionTrainingArgs(
        grad_accum_steps=1, use_augmentation=False), 10)(state, {"images": x, "labels": y}, 0)
    after = check(state.params, x, y)[0]
    assert not torch.equal(before, after)
    assert step.graphs[tuple(step.graphs)[0]] is graph  # replayed, not captured again
    copies = {n: p.detach().clone() * 0.5 for n, p in state.params.items()}
    halved = check(copies, x, y)[0]
    assert not torch.equal(halved, after) and len(step.graphs) == 1


# --- the train programs (the JAX package's training jit sites) -------------


def same_bits(x, y):
    """Bit for bit (a NaN equals the same NaN)."""
    return x.dtype == y.dtype and x.shape == y.shape and torch.equal(
        x.contiguous().reshape(-1).view(torch.uint8), y.contiguous().reshape(-1).view(torch.uint8))


def same_tensors(a, b):
    """Every tensor of two train states (params, moments, counters) and two
    models' buffers, bit for bit."""
    from vats_tpu_torch.train.step_graphs import state_tensors

    ta, tb = state_tensors(*a), state_tensors(*b)
    assert len(ta) == len(tb)
    return all(same_bits(x, y) for x, y in zip(ta, tb))


def flash_counts():
    from vats_tpu_torch.ops import flash_attention as fa

    return {f.__name__: f.launches for f in (fa.flash_attention, fa.flash_attention_lse,
                                             fa.flash_bwd_dkv, fa.flash_bwd_dq)}


def diff_counts(before):
    return {k: v - before[k] for k, v in flash_counts().items()}


def train_model(experts=1, seed=3):
    from vats_tpu_torch.configs import ModelArgs
    from vats_tpu_torch.models import TextLM

    return TextLM(ModelArgs(
        d_model=128, num_heads=4, query_groups=2, d_ffn=256, num_layers=2, dropout=0.1,
        vocab_size=256, max_seq_len=256, left_window=-1, num_experts=experts,
        top_k=min(2, experts), capacity_factor=1.25, dtype="bfloat16", use_mqa=False,
        gradient_checkpointing=True, remat_policy="dots"), device="cuda", seed=seed)


def lm_batches(gen, n, b=2, t=256):
    from vats_tpu_torch.data import synthetic_lm_batches

    return list(synthetic_lm_batches(gen, vocab_size=256, batch_size=b, seq_len=t,
                                     num_batches=n, pad_fraction=0.2))


def lm_pair(accum=1, experts=1):
    """Two models and states from one seed, each with its own step; the
    second step runs eagerly."""
    from vats_tpu_torch.configs import TrainingArgs
    from vats_tpu_torch.train import create_optimizer, create_train_state, make_train_step

    targs = TrainingArgs(grad_accum_steps=accum, fused_ce_chunk=64, adam_mu_dtype="bfloat16")
    out = []
    for use_graph in (True, False):
        model = train_model(experts)
        state = create_train_state(model, create_optimizer(targs, 20))
        step = make_train_step(model, targs)
        step.graphs.use_graph = use_graph
        out.append((model, state, step))
    return out, targs


@pytest.mark.parametrize("accum,experts", [(1, 1), (4, 1), (1, 4)],
                         ids=["dense", "accum4", "moe"])
def test_lm_train_step_graph_equals_eager(gen, accum, experts):
    """Dropout 0.1, remat 'dots', fused CE: params, moments, counters and
    metrics bit-equal after each step; one graph a window position; a
    replay launches K2' 2 x layers, K5a and K5b once a layer, K2 never;
    ``state.step`` counts every call."""
    (g, e), _ = lm_pair(accum, experts)
    batches = lm_batches(gen, 2 * accum + 2)
    L = g[0].cfg.num_layers
    grad_ptrs = None
    for i, batch in enumerate(batches):
        n0 = flash_counts()
        _, mg = g[2](g[1], batch, 100 + i)
        torch.cuda.synchronize()
        got = diff_counts(n0)
        _, me = e[2](e[1], batch, 100 + i)
        assert all(torch.equal(mg[k], me[k]) for k in mg), i
        assert same_tensors((g[1], list(g[0].buffers())), (e[1], list(e[0].buffers()))), i
        assert got == {"flash_attention": 0, "flash_attention_lse": 2 * L,
                       "flash_bwd_dkv": L, "flash_bwd_dq": L}, (i, got)
        assert int(g[1].step) == i + 1
        ptrs = [p.grad.data_ptr() for p in g[0].parameters()]
        grad_ptrs = grad_ptrs or ptrs
        assert ptrs == grad_ptrs, i  # one gradient buffer a parameter for every key
    assert len(g[2].graphs) == accum and g[2].graphs.replays == len(batches) - accum
    for (_, p), (_, q) in zip(g[0].named_parameters(), e[0].named_parameters()):
        assert torch.equal(p.grad, q.grad)  # the graph's gradient buffers


def test_routing_record_refuses_the_capture(gen):
    """``record_routing`` on the MoE layers: the step raises on the card
    before its warm-up (state untouched, no graph), since a replay could not
    update the record; eagerly it records the step's routing; with the
    record off the step captures."""
    from vats_tpu_torch.nn.moe import MoELayer

    (g, e), _ = lm_pair(experts=4)
    layers = [m for m in g[0].modules() if isinstance(m, MoELayer)]
    for m in layers:
        m.record_routing = True
    batch, later = lm_batches(gen, 2)
    with pytest.raises(RuntimeError, match="record_routing"):
        g[2](g[1], batch, 1)
    assert int(g[1].step) == 0 and len(g[2].graphs) == 0
    g[2].graphs.use_graph = False
    g[2](g[1], batch, 1)
    e[2](e[1], batch, 1)
    assert same_tensors((g[1],), (e[1],))
    n = batch["input_ids"].numel()
    for m in layers:
        assert m.routing["experts"].shape == (n, 2) and m.routing["keep"].any()
    for m in layers:
        m.record_routing = False
    g[2].graphs.use_graph = True
    g[2](g[1], later, 2)
    torch.cuda.synchronize()
    assert len(g[2].graphs) == 1 and int(g[1].step) == 2


def test_non_finite_step_is_skipped_alike(gen):
    """A NaN written into a weight in place after the capture: the replay
    skips the step as the eager step does (params and moments untouched,
    ``skipped_steps`` 1), bit for bit."""
    (g, e), _ = lm_pair()
    batches = lm_batches(gen, 3)
    for side in (g, e):
        side[2](side[1], batches[0], 1)
        with torch.no_grad():
            side[0].norm.weight[0] = float("nan")  # every position's hidden state
        side[2](side[1], batches[1], 2)
    torch.cuda.synchronize()
    assert int(g[1].skipped_steps) == int(e[1].skipped_steps) == 1
    assert same_tensors((g[1],), (e[1],))
    assert g[2].graphs.replays == 1


def test_lm_eval_step_graph_equals_eager(gen):
    """T = 512: the deterministic forward through K2, one launch a layer a
    replay; metrics bit-equal to ``eval_metrics`` run eagerly."""
    from vats_tpu_torch.train import make_eval_step
    from vats_tpu_torch.train.loop import eval_metrics

    (g, _), targs = lm_pair()
    step = make_eval_step(g[0], targs)
    for batch in lm_batches(gen, 3, t=512)[:1] * 2 + lm_batches(gen, 1, b=3, t=512):
        want = eval_metrics(g[0], g[1].params, batch, targs)
        n0 = flash_counts()
        got = step(g[1].params, batch)
        torch.cuda.synchronize()
        assert all(torch.equal(got[k], want[k]) for k in want)
        assert diff_counts(n0)["flash_attention"] == g[0].cfg.num_layers
    assert len(step.graphs) == 2 and step.graphs.replays == 1


def test_load_in_place_is_seen_and_new_state_captures_again(gen, tmp_path):
    """``load_checkpoint(target=state)`` restores in place: the next replay
    steps from the loaded values (its metrics equal the step that followed
    the save); a new state of other tensors captures again."""
    from vats_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from vats_tpu_torch.train import create_optimizer, create_train_state

    (g, _), targs = lm_pair()
    batches = lm_batches(gen, 3)
    g[2](g[1], batches[0], 1)
    path = save_checkpoint(str(tmp_path), g[1])
    _, m1 = g[2](g[1], batches[1], 2)
    graph = g[2].graphs[next(iter(g[2].graphs))]
    load_checkpoint(path, target=g[1])
    _, m2 = g[2](g[1], batches[1], 2)
    torch.cuda.synchronize()
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert g[2].graphs[next(iter(g[2].graphs))] is graph and graph.replays == 2
    fresh = create_train_state(g[0], create_optimizer(targs, 20))
    g[2](fresh, batches[2], 3)
    assert g[2].graphs[next(iter(g[2].graphs))] is not graph and int(fresh.step) == 1


def test_host_sync_in_a_train_body_raises(gen):
    """No fallback: a train body that reads its loss on the host cannot be
    captured; the capture raises."""
    from vats_tpu_torch.train.step_graphs import TrainGraphs

    w = torch.nn.Parameter(torch.ones(4, device="cuda"))
    graphs = TrainGraphs("cuda")

    def build():
        x = torch.ones(4, device="cuda")

        def body():
            w.grad = None
            loss = (w * x).sum()
            loss.backward()
            if float(loss) > 0:
                w.data.add_(-0.1 * w.grad)

        return {"x": x}, body, x

    with pytest.raises(RuntimeError):
        graphs("k", build, {"x": torch.ones(4)}, params=[w], state=[w])
    torch.cuda.synchronize()
    end_failed_capture()


def test_vit2d_train_micro_steps_graph_equal_eager(gen):
    """ViT-2D at 256 patches (K2'/K5a/K5b), dropout 0.1, remat, the pixel
    battery and mixup / cutmix on, 2 micro-steps a window: one graph a
    position, bit-equal to eager after every micro-step, the same kernel
    launches a replay as an eager micro-step."""
    from vats_tpu_torch.configs import vit2d_xsmall
    from vats_tpu_torch.models import ImageEncoder
    from vats_tpu_torch.train import (
        VisionTrainingArgs,
        create_train_state,
        create_vision_optimizer,
        make_vision_train_step,
    )

    args = VisionTrainingArgs(grad_accum_steps=2, pixel_augs_on_device=True, epochs=4,
                              warmup_epochs=1)
    sides = []
    for use_graph in (True, False):
        model = ImageEncoder(vit2d_xsmall(target_size=256, patch_size=16, num_classes=10,
                                          dropout=0.1, use_checkpointing=True),
                             device="cuda", seed=1)
        state = create_train_state(model, create_vision_optimizer(args, 1))
        step = make_vision_train_step(model, args, 10)
        step.graphs.use_graph = use_graph
        sides.append((model, state, step))
    counts = []
    for i in range(5):
        batch = {"images": torch.rand((3, 3, 256, 256), generator=gen, device="cuda"),
                 "labels": torch.randint(0, 10, (3,), generator=gen, device="cuda")}
        ms = []
        for model, state, step in sides:
            n0 = flash_counts()
            ms.append(step(state, batch, 50 + i)[1])
            torch.cuda.synchronize()
            counts.append(diff_counts(n0))
        assert all(torch.equal(ms[0][k], ms[1][k]) for k in ms[0]), i
        assert same_tensors((sides[0][1],), (sides[1][1],)), i
        assert counts[-2] == counts[-1] and counts[-1]["flash_bwd_dq"] > 0, counts[-2:]
    assert len(sides[0][2].graphs) == 2 and sides[0][2].graphs.replays == 3


def test_image_gen_trainer_step_and_eval_graph_equal_eager(gen):
    """Three trainer steps and an evaluate: metrics, params, moments and the
    BatchNorm statistics bit-equal to eager.  cuDNN's deterministic
    algorithms for the convolutions (its default backward may add with
    atomics, which no two runs share)."""
    from vats_tpu_torch.configs import image_gen_tiny_test
    from vats_tpu_torch.train import ImageGenTrainer, ImageGenTrainingArgs

    torch.backends.cudnn.deterministic = True
    try:
        cfg = image_gen_tiny_test(dropout=0.1)
        sides = []
        for use_graph in (True, False):
            tr = ImageGenTrainer(cfg, ImageGenTrainingArgs(), num_training_steps=10,
                                 device="cuda")
            tr.graphs.use_graph = tr.eval_graphs.use_graph = use_graph
            sides.append(tr)
        s = cfg.target_size
        for i in range(3):
            batch = {"images": torch.rand((2, 3, s, s), generator=gen, device="cuda"),
                     "text_embeddings": torch.randn((2, 6, cfg.d_model), generator=gen,
                                                    device="cuda")}
            mg, me = (tr.train_step(batch) for tr in sides)
            assert mg == me, i
            assert same_tensors(*((tr.state, list(tr.model.buffers())) for tr in sides)), i
        eg, ee = (tr.evaluate(iter([batch]), max_batches=1) for tr in sides)
        assert eg == ee and len(sides[0].graphs) == 1 and len(sides[0].eval_graphs) == 1
    finally:
        torch.backends.cudnn.deterministic = False


def test_video_trainers_graph_equal_eager(gen):
    """Both video trainers, three steps each: losses, params, moments and
    the 3-D VQ-VAE's BatchNorm statistics bit-equal to eager."""
    import vats_tpu_torch.configs.video_gen as vcfg
    from vats_tpu_torch.train import VideoGenTrainingArgs, VideoTokenTrainer, VQVAE3DTrainer

    torch.backends.cudnn.deterministic = True
    try:
        cfg = vcfg.video_gen_tiny_test(dropout=0.1)
        for cls in (VQVAE3DTrainer, VideoTokenTrainer):
            sides = []
            for use_graph in (True, False):
                tr = cls(cfg, VideoGenTrainingArgs(), num_training_steps=10, device="cuda")
                tr.graphs.use_graph = use_graph
                sides.append(tr)
            for i in range(3):
                if cls is VQVAE3DTrainer:  # clips [B, C, T, H, W] in [0, 1]
                    batch = torch.rand((2, 3, 4, 16, 16), generator=gen, device="cuda")
                else:  # latent indices [B, T, H, W] of the 4x4 latent grid
                    batch = {"indices": torch.randint(0, cfg.num_embeddings, (2, 2, 4, 4),
                                                      generator=gen, device="cuda"),
                             "text_embeddings": torch.randn((2, 5, cfg.d_model),
                                                            generator=gen, device="cuda")}
                lg, le = (tr.train_step(batch) for tr in sides)
                assert lg == le, (cls.__name__, i)
                assert same_tensors(*((tr.state, list(tr.model.buffers())) for tr in sides))
            assert len(sides[0].graphs) == 1 and sides[0].graphs.replays == 2
    finally:
        torch.backends.cudnn.deterministic = False
