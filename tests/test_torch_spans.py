"""The program's spans (``vats_tpu_torch/utils/profiling.annotate``) where
the port's layers open them, on the CPU under ``torch.profiler``:

  * a serving step opens ``serve.admit`` over ``serve.prefill`` over
    ``serve.prefill.wait``, then ``serve.dispatch``, ``serve.block_wait``,
    ``serve.commit`` and ``serve.retire``, in that order; a prefill span
    carries its request ids; a speculative step opens ``serve.verify``;
  * an eager train step opens ``train.forward``, ``train.backward`` and
    ``train.optimizer``; an MoE layer ``moe.route``, ``moe.dispatch``,
    ``moe.experts`` and ``moe.combine`` in both single-rank dispatches;
  * ``data.feed`` covers the conversion of a batch, not the generator that
    yields it;
  * outside a step's body the host opens 6 spans a serving step and 4 more
    a prefill group, and at most 8 a micro-step;
  * served tokens and train losses are bit-equal with a profiler on and off;
  * the engine's and the train step's graphs share one ``use_graph``
    switch (``GraphSet.use_graph``), off on the CPU.
"""

import time

import numpy as np
import pytest
import torch

from vats_tpu_torch.configs import TrainingArgs, nlp_xsmall
from vats_tpu_torch.data import synthetic_lm_batches
from vats_tpu_torch.data.feed import device_batches
from vats_tpu_torch.inference import SamplingParams, ServingEngine
from vats_tpu_torch.inference.graphs import GraphSet
from vats_tpu_torch.models import TextLM
from vats_tpu_torch.nn.moe import MoELayer
from vats_tpu_torch.train import create_optimizer, create_train_state, make_train_step
from vats_tpu_torch.train.step_graphs import TrainGraphs

torch.set_num_threads(1)

CFG = dict(
    d_model=64, num_heads=4, query_groups=2, d_ffn=128, num_layers=2,
    vocab_size=128, dropout=0.0, num_experts=4, top_k=2,
    max_seq_len=256, use_mqa=False, gradient_checkpointing=False,
    dtype="float32", param_dtype="float32",
)


def profiled(fn, record_shapes=False):
    """(fn's result, the program's spans as (name, start, end, kwinputs)
    sorted by start, outermost first at a tie)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=record_shapes) as prof:
        out = fn()
    spans = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("vats."):
            s = e.start_ns()
            spans.append((e.name()[len("vats."):], s, s + e.duration_ns(), e.kwinputs()))
    spans.sort(key=lambda x: (x[1], -x[2]))
    return out, spans


def names(spans):
    return [s[0] for s in spans]


def inside(a, b) -> bool:
    """Span ``a`` lies within span ``b``."""
    return b[1] <= a[1] and a[2] <= b[2]


def outside_bodies(spans):
    """The spans that no ``graph.run`` / ``graph.capture`` holds: the host's
    own, which a replay runs too."""
    bodies = [s for s in spans if s[0] in ("graph.run", "graph.capture")]
    return [s for s in spans if not any(b is not s and inside(s, b) for b in bodies)]


@pytest.fixture(scope="module")
def model():
    return TextLM(nlp_xsmall(**CFG), device="cpu", seed=0).eval()


def engine(model, **kw):
    kw = dict(dict(max_batch=4, max_context=256, total_pages=16, prompt_buckets=(16, 32),
                   decode_block_steps=2), **kw)
    return ServingEngine(model, seed=0, eos_token_id=None, **kw)


# --- serving --------------------------------------------------------------


def test_a_serving_step_opens_its_spans_nested_and_in_order(model):
    eng = engine(model)
    for p in ([5, 9, 17, 3], [88, 11, 4]):
        eng.submit(p, 6)
    _, spans = profiled(eng.step)
    host = outside_bodies(spans)
    top = [s for s in host if not any(o is not s and inside(s, o) for o in host)]
    assert names(top) == ["serve.admit", "serve.dispatch", "serve.block_wait",
                          "serve.commit", "serve.retire"]
    admit = top[0]
    prefills = [s for s in spans if s[0] == "serve.prefill"]
    waits = [s for s in spans if s[0] == "serve.prefill.wait"]
    assert len(prefills) == len(waits) == 1  # one group: both prompts in bucket 16
    assert inside(prefills[0], admit) and inside(waits[0], prefills[0])
    # the prefill's inputs and run are the graph set's, inside the prefill
    graph = [s for s in spans if s[0].startswith("graph.")]
    assert names(s for s in graph if inside(s, prefills[0])) == ["graph.inputs", "graph.run"]
    assert names(s for s in graph if inside(s, top[1])) == ["graph.run"]
    assert {s[0] for s in spans if s[0].startswith("moe.")} == {
        "moe.route", "moe.dispatch", "moe.experts", "moe.combine"}


def test_a_serving_step_opens_six_host_spans_and_four_a_prefill_group(model):
    eng = engine(model)
    for p in ([5, 9, 17, 3], [88, 11, 4], [1] * 20):  # two prefill groups
        eng.submit(p, 6)
    _, spans = profiled(eng.step)
    assert len(outside_bodies(spans)) == 6 + 4 * 2
    _, spans = profiled(eng.step)  # a decode-only step
    assert names(outside_bodies(spans)) == ["serve.admit", "serve.dispatch", "graph.run",
                                            "serve.block_wait", "serve.commit",
                                            "serve.retire"]


def test_a_prefill_span_carries_its_request_ids(model):
    eng = engine(model)
    rids = [eng.submit(p, 3) for p in ([5, 9, 17, 3], [88, 11, 4], [1] * 20)]
    _, spans = profiled(eng.step, record_shapes=True)
    carried = sorted(s[3]["rids"] for s in spans if s[0] == "serve.prefill")
    assert carried == sorted([f"{rids[0]},{rids[1]}", f"{rids[2]}"])


@pytest.mark.parametrize("kw,want", [
    (dict(overlap_scheduling=True), ["serve.admit", "serve.dispatch"]),
    (dict(spec_k=2, decode_block_steps=1), ["serve.admit", "serve.verify", "serve.retire"]),
])
def test_overlapped_and_speculative_steps_open_their_spans(model, kw, want):
    eng = engine(model, **kw)
    eng.submit([5, 9, 17, 3, 5, 9, 17, 3], 6)
    _, spans = profiled(eng.step)
    host = outside_bodies(spans)
    top = [s for s in host if not any(o is not s and inside(s, o) for o in host)]
    assert names(top) == want


def test_served_tokens_are_bit_equal_with_a_profiler_on_and_off(model):
    def serve(profile):
        eng = engine(model, per_request_sampling=True)
        for i, p in enumerate(([5, 9, 17, 3], [88, 11, 4], [1] * 20, [7, 7, 23])):
            eng.submit(p, 9, sampling=SamplingParams(temperature=0.7 if i % 2 else 0.0,
                                                     top_k=20, top_p=0.9, seed=i))
        return profiled(eng.run)[0] if profile else eng.run()

    assert serve(True) == serve(False)


# --- the one use_graph switch -----------------------------------------------


def test_the_engine_and_the_train_step_share_one_use_graph_switch(model):
    eng = engine(model)
    assert isinstance(eng.graphs, GraphSet) and eng.graphs.use_graph is False
    assert not hasattr(eng, "_use_graphs")
    assert TrainGraphs("cpu").use_graph is False and GraphSet("cuda").use_graph is True
    eng.submit([5, 9, 17, 3], 4)
    eng.graphs.use_graph = True  # on the CPU the bodies run eagerly all the same
    out = eng.run()
    assert len(out) == 1 and len(next(iter(out.values()))) == 4
    assert len(eng.graphs) == 0 and eng.graphs.entries  # no graph, every key's buffers


# --- training -------------------------------------------------------------


def _train(accum, seed=0):
    cfg = nlp_xsmall(**dict(CFG, dropout=0.1))
    model = TextLM(cfg, device="cpu", seed=seed)
    ta = TrainingArgs(grad_accum_steps=accum, fused_ce_chunk=8)
    state = create_train_state(model, create_optimizer(ta, 100, grad_accum_steps=accum))
    batches = synthetic_lm_batches(torch.Generator().manual_seed(2), vocab_size=128,
                                   batch_size=2, seq_len=16)
    return make_train_step(model, ta), state, batches


@pytest.mark.parametrize("accum", [1, 2])
def test_an_eager_train_step_opens_forward_backward_optimizer(accum):
    step, state, batches = _train(accum)
    for i in range(accum):
        _, spans = profiled(lambda: step(state, next(batches), i))
        host = outside_bodies(spans)
        assert names(host) == ["graph.inputs", "graph.run"]
        run = host[1]
        phases = [s for s in spans if s[0].startswith("train.")]
        assert names(phases) == ["train.forward", "train.backward", "train.optimizer"]
        assert all(inside(s, run) for s in phases)
        assert phases[0][2] <= phases[1][1] and phases[1][2] <= phases[2][1]
        moe = [s for s in spans if s[0].startswith("moe.")]
        assert moe and all(inside(s, phases[0]) for s in moe)  # the forward's only
        assert len(host) <= 8


def test_train_losses_are_bit_equal_with_a_profiler_on_and_off():
    losses = {}
    for on in (True, False):
        step, state, batches = _train(2)
        run = lambda i: step(state, next(batches), i)[1]["loss"]  # noqa: E731
        losses[on] = [float(profiled(lambda: run(i))[0] if on else run(i)) for i in range(4)]
    assert losses[True] == losses[False]


def test_the_feed_span_holds_the_conversion_not_the_generator():
    def slow():
        for b in range(3):
            time.sleep(0.05)
            yield {"input_ids": np.full((2, 8), b, np.int64),
                   "padding_mask": np.ones((2, 8), np.int64)}

    out, spans = profiled(lambda: list(device_batches(slow(), "cpu")))
    assert [int(b["input_ids"][0, 0]) for b in out] == [0, 1, 2]
    assert out[0]["input_ids"].dtype == torch.int32 and out[0]["padding_mask"].dtype == torch.bool
    feeds = [s for s in spans if s[0] == "data.feed"]
    assert len(feeds) == 3
    assert all(e - s < 0.02e9 for _, s, e, _ in feeds)
    # each starts after its batch's sleep: 50 ms or more after the previous one ended
    assert all(b[1] - a[2] >= 0.045e9 for a, b in zip(feeds, feeds[1:]))


# --- the MoE layer ------------------------------------------------------------


@pytest.mark.parametrize("mode", ["sort", "scatter"])
def test_an_moe_forward_opens_route_dispatch_experts_combine(mode):
    layer = MoELayer(32, 64, 4, 2, dispatch=mode, capacity_factor=1.25, device="cpu")
    layer.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 12, 32, generator=torch.Generator().manual_seed(1))
    (out, _), spans = profiled(lambda: layer(x))
    assert names(spans) == ["moe.route", "moe.dispatch", "moe.experts", "moe.combine"]
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))  # one after another
    ref, _ = layer(x)
    assert torch.equal(out, ref)
