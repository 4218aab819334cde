"""``benchmark/spans.py`` on synthetic events and on the CPU: the idle
intervals split exactly by the innermost program span (the parts sum to
the idle total), a kernel attributed by its launch event's correlation id
and not by its start, idle gaps named by program spans, each reading
``None`` without its inputs, the cell's own readers unmoved by ``program``
and ``probe``, and the probes on a tiny engine and train step."""

import copy
import os

import pytest
import torch

from benchmark import harness, spans
from benchmark.tests import tiny

METRICS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "metrics")


def _events():
    """A window 0..10 s: the harness's step 1..9; inside it the program's
    admit 1..4 (its prefill 2..4, the prefill's wait 3..4) and dispatch
    5..6.  Device work 2.5..3 (launched at 2.2, in the prefill), 6.5..8
    (a replay launched at 5.5, in the dispatch), 9.5..10 (launched at 8.7,
    under the harness only) and an operation with no launch event 0..0.5."""
    ev = spans.Events(window=(0.0, 10.0))
    ev.bench = [("engine.step", 1.0, 9.0)]
    ev.program = [("serve.admit", 1.0, 4.0), ("serve.prefill", 2.0, 4.0),
                  ("serve.prefill.wait", 3.0, 4.0), ("serve.dispatch", 5.0, 6.0)]
    ev.ops = [("gemm", 2.5, 0.5, 11), ("k1", 6.5, 1.5, 12), ("copy", 9.5, 0.5, 13),
              ("lost", 0.0, 0.5, 99)]
    ev.launches = {11: 2.2, 12: 5.5, 13: 8.7}
    return ev


def test_idle_splits_exactly_by_the_innermost_program_span():
    out = spans.attribute(_events(), (0.0, 10.0))
    idle = out["idle_s"]
    assert idle == pytest.approx({
        "untraced": 0.5 + 0.5,                                   # 0.5..1, 9..9.5
        "serve.admit": 1.0,                                      # 1..2
        "serve.admit/serve.prefill": 0.5,                        # 2..2.5
        "serve.admit/serve.prefill/serve.prefill.wait": 1.0,     # 3..4
        "harness only": 1.0 + 0.5 + 1.0,                         # 4..5, 6..6.5, 8..9
        "serve.dispatch": 1.0,                                   # 5..6
    })
    busy = 0.5 + 0.5 + 1.5 + 0.5
    assert sum(idle.values()) == pytest.approx(10.0 - busy)
    assert spans.under(idle, "serve.admit") == pytest.approx(2.5)


def test_a_kernel_goes_to_the_span_of_its_launch_not_of_its_start():
    dev = spans.attribute(_events(), (0.0, 10.0))["device_s"]
    # k1 runs 6.5..8, after the dispatch closed at 6: it was launched inside it
    assert dev == pytest.approx({"serve.admit/serve.prefill": 0.5, "serve.dispatch": 1.5,
                                 "harness only": 0.5, "unattributed": 0.5})


def test_the_window_clips_device_seconds_and_defaults_to_the_operations():
    ev = _events()
    assert sum(spans.attribute(ev, (2.75, 7.0))["device_s"].values()) == pytest.approx(0.75)
    assert spans.attribute(ev)["window_s"] == pytest.approx(10.0)


def test_gaps_are_named_by_program_spans_in_the_breakdown():
    ev = _events()
    ops = [(n, s, d) for n, s, d, _ in ev.ops]
    gaps = harness.reduce_trace(ops, ev.window, ev.bench + ev.program)["breakdown"]["idle_gaps"]
    # gaps 3..6.5, 0.5..2.5 and 8..9.5, each named by the innermost span over its middle
    assert gaps == [["engine.step", pytest.approx(3.5)], ["serve.admit", pytest.approx(2.0)],
                    ["engine.step", pytest.approx(1.5)]]


def test_paths_follow_nesting_across_threads():
    # the backward's recompute opens moe spans on autograd's thread inside
    # the main thread's train.backward
    p = spans.Paths([("graph.run", 0.0, 10.0), ("train.backward", 1.0, 9.0),
                     ("moe.dispatch", 2.0, 3.0)])
    assert p.at(2.5) == "graph.run/train.backward/moe.dispatch"
    assert p.at(3.5) == "graph.run/train.backward"
    assert p.at(11.0) == "untraced"


def _record(workload):
    """A record with ``program`` and ``probe`` as a traced run of
    ``workload`` would hold them."""
    idle = {"serve.admit/serve.prefill/serve.prefill.wait": 0.02, "serve.commit": 0.03,
            "serve.dispatch/graph.run": 0.01, "serve.retire": 0.005, "data.feed": 0.004,
            "harness only": 0.1, "untraced": 0.001}
    probe = {"serve.dispatch/graph.run/moe.route": 0.1, "serve.dispatch/graph.run/moe.dispatch": 0.2,
             "serve.dispatch/graph.run/moe.experts": 0.4, "serve.dispatch/graph.run/moe.combine": 0.1,
             "serve.dispatch/graph.run": 0.2, "serve.admit/serve.prefill/graph.run/moe.route": 5.0,
             "graph.run/train.forward/moe.experts": 0.3, "graph.run/train.backward": 0.5,
             "graph.run/train.optimizer": 0.2, "data.feed": 0.01}
    return {"counters": {"decode_forwards": 4, "decode_rows": 250},
            "trace": {"busy_s": 2.0, "window_s": 4.0, "counters": {"output_tokens": 1000,
                                                                   "tokens": 4000},
                      "by_name": {"paged_decode_kernel": 0.5}, "program": {"idle_s": idle}},
            "probe": {"device_s": probe}}


@pytest.mark.parametrize("name,want", [
    ("idle_admit_share.decode", 100 * 0.02 / 4.0),
    ("idle_block_share.decode", 100 * (0.03 + 0.01 + 0.005) / 4.0),
    ("moe_dispatch_share.decode", 100 * 0.4 / 1.0),
    ("idle_feed_share.train", 100 * 0.004 / 4.0),
    ("optimizer_share.train", 100 * 0.2 / 1.0),
])
def test_readings(name, want):
    assert spans.READINGS[name][0](_record(None)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(spans.READINGS))
def test_a_reading_with_nothing_to_read_returns_nothing(name):
    reader = spans.READINGS[name][0]
    assert reader({"counters": {}, "trace": None}) is None
    traced = {"counters": {}, "trace": {"busy_s": 1.0, "window_s": 2.0, "counters": {}}}
    assert reader(traced) is None  # a parent's trace: no program spans, no probe


@pytest.mark.parametrize("name", sorted(f[:-3] for f in os.listdir(METRICS) if f.endswith(".py")))
def test_the_cells_readers_are_unmoved_by_program_and_probe(name):
    rec = _record(None)
    bare = copy.deepcopy(rec)
    del bare["probe"], bare["trace"]["program"]
    assert harness.load_reader(name)(rec) == harness.load_reader(name)(bare)


def test_the_serving_probe_runs_eager_steps_and_counts_nothing_of_the_drive():
    from benchmark.drivers import serve
    from vats_tpu_torch.inference.serving import ServingEngine

    ctx = tiny.serve_ctx("closed_loop", "medium_e8.decode_heavy")
    m = ctx.config["model"]
    kw = dict(ctx.config["engine"], prompt_buckets=tuple(ctx.config["engine"]["prompt_buckets"]))
    eng = ServingEngine(serve.build_model(m, ctx.seed, "cpu"), seed=1, eos_token_id=None, **kw)
    for n in (20, 40):
        eng.submit(list(range(1, n + 1)), 40)
    eng.step()
    forwards = eng.forwards["decode"]
    out = spans.probe_serve(eng)
    assert eng.forwards["decode"] == forwards + 4 * 4  # its own step and three more
    assert eng.graphs.use_graph is False and out["steps"] == 3  # the CPU's, put back
    assert out["device_s"] == {}  # no device on the CPU


def test_the_training_probe_runs_one_whole_optimizer_step():
    from vats_tpu_torch.configs import TrainingArgs, nlp_xsmall
    from vats_tpu_torch.data import synthetic_lm_batches
    from vats_tpu_torch.models import TextLM
    from vats_tpu_torch.train import create_optimizer, create_train_state, make_train_step

    model = TextLM(nlp_xsmall(d_model=64, num_heads=4, num_layers=2, num_experts=4, top_k=2,
                              dtype="float32"), device="cpu", seed=0)
    ta = TrainingArgs(grad_accum_steps=2)
    state = create_train_state(model, create_optimizer(ta, 10, grad_accum_steps=2))
    step = make_train_step(model, ta)
    batches = synthetic_lm_batches(torch.Generator().manual_seed(2), vocab_size=512,
                                   batch_size=2, seq_len=16)
    out = spans.probe_train(step, state, batches, iter(range(100)), 2)
    assert int(state.step) == 4 and out["micro_steps"] == 2
    assert step.graphs.use_graph is False  # the CPU's default, put back
