"""The port's profiling hooks (``vats_tpu_torch/utils/profiling.py``).

``annotate``: with no profiler running it enters nothing of the profiler's
and makes none of its arguments; under ``torch.profiler`` it records
``vats.``-prefixed, nested operator events (not user annotations, which
the profiler would echo on the device's timeline), carrying their
arguments where the profiler records inputs.  ``trace`` writes a Chrome
trace on the CPU that holds the regions ``annotate`` opened, nested."""

import json
import os

import torch

import vats_tpu_torch.utils.profiling as t_prof
from vats_tpu_torch.utils import annotate, trace

torch.set_num_threads(1)


def test_trace_writes_a_chrome_trace_with_nested_regions(tmp_path):
    log_dir = str(tmp_path / "profiles")
    with trace(log_dir) as where:
        assert where == log_dir
        with annotate("outer_region"):
            with annotate("inner_region"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("name") in ("vats.outer_region",
                                                                "vats.inner_region")}
    assert set(spans) == {"vats.outer_region", "vats.inner_region"}
    outer, inner = spans["vats.outer_region"], spans["vats.inner_region"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_annotate_enters_nothing_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the profiler was entered with no profiler running")

    monkeypatch.setattr(t_prof, "_span", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with annotate("outer", refuse):
        with annotate("inner"):
            pass
    assert annotate("a") is annotate("b")  # one shared no-op


def test_annotate_records_prefixed_nested_operator_events_with_their_args():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        with annotate("serve.prefill", lambda: {"rids": "3,7"}):
            with annotate("serve.prefill.wait"):
                torch.ones(8) + 1
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("vats.")}
    assert set(events) == {"vats.serve.prefill", "vats.serve.prefill.wait"}
    outer, inner = events["vats.serve.prefill"], events["vats.serve.prefill.wait"]
    assert outer.start_ns() <= inner.start_ns() and inner.end_ns() <= outer.end_ns()
    assert outer.kwinputs() == {"rids": "3,7"}
    assert not outer.is_user_annotation() and not inner.is_user_annotation()
