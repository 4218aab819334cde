"""The port's profiling hooks against ``vats_tpu.utils.profiling``.

``StepTimer``: the same tick sequence (durations set by a fake clock, so no
tolerance but float rounding of the same sums, rtol 1e-12) gives the same
summary in both packages, window included.  ``trace`` writes a Chrome trace
on the CPU that holds the regions ``annotate`` opened, nested."""

import json
import os

import numpy as np
import pytest
import torch

import vats_tpu.utils.profiling as j_prof
import vats_tpu_torch.utils.profiling as t_prof
from vats_tpu_torch.utils import StepTimer, annotate, trace

torch.set_num_threads(1)


class FakeClock:
    def __init__(self, steps):
        self.times = list(np.cumsum([0.0] + steps))

    def __call__(self):
        return self.times.pop(0)


@pytest.mark.parametrize("window", [3, 50])
def test_step_timer_summary_matches_jax(monkeypatch, window):
    durations = [0.5, 0.25, 1.0, 0.125, 2.0, 0.75]
    tokens = [100, 0, 300, 50, 1000, 10]
    out = {}
    for name, mod in (("port", t_prof), ("jax", j_prof)):
        monkeypatch.setattr(mod.time, "perf_counter", FakeClock(durations))
        timer = mod.StepTimer(window=window)
        timer.start()
        dts = [timer.tick(None, tokens=n) for n in tokens]
        out[name] = (dts, timer.summary())
        monkeypatch.undo()
    (tdts, tsum), (jdts, jsum) = out["port"], out["jax"]
    np.testing.assert_allclose(tdts, jdts, rtol=1e-12)
    assert tsum.keys() == jsum.keys() == {"mean_step_s", "steps_per_s", "tokens_per_s"}
    for k in jsum:
        np.testing.assert_allclose(tsum[k], jsum[k], rtol=1e-12, err_msg=k)
    assert StepTimer().summary() == j_prof.StepTimer().summary() == {}


def test_step_timer_tick_takes_tensors_and_first_tick_is_zero():
    timer = StepTimer(window=2)
    assert timer.tick({"loss": torch.ones(2), "more": [torch.zeros(1), (1, 2)]},
                      tokens=5) == 0.0
    timer.tick(torch.ones(3), tokens=5)
    timer.tick(None, tokens=7)
    assert len(timer._durations) == 2 and timer._tokens == [5, 7]


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
    spans = {e["name"]: e for e in events if e.get("name") in ("outer_region",
                                                                "inner_region")}
    assert set(spans) == {"outer_region", "inner_region"}
    outer, inner = spans["outer_region"], spans["inner_region"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
