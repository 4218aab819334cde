"""What every run of the benchmark shares: the manifest and the cell's files,
the clock from process start, spans of the harness's own calls, the
profiled span and its reduction, the device line, the check that no JAX
module was loaded, and the result line.

Spans: :meth:`Recorder.span` wraps a call of the harness into a layer of
the program (``engine.step``, ``train.step``, ``feed``); inside a profiled
span it marks the call for the profiler (``bench.<name>``), so an idle gap
of the device can be named by what the host was doing.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names that must not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "vats_tpu")


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(*parts: str) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def process_start_wall() -> float:
    """Wall time (``time.time()``) at which this process started, from
    ``/proc``; the import time of this module where ``/proc`` has none."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def forbidden_modules(names=None) -> List[str]:
    """The module names (by default the loaded ones) whose top-level name
    (before the first dot) is one of :data:`FORBIDDEN`, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def load_reader(name: str):
    """The ``read(record)`` function of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def percentile(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    vals = sorted(values)
    pos = (len(vals) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


# ----------------------------------------------------------- spans


@dataclass
class Recorder:
    """The set-up phases' seconds, and the harness's spans: marked for the
    profiler while a span of the window is traced."""

    phases: Dict[str, float] = field(default_factory=dict)
    marking: bool = False

    @contextlib.contextmanager
    def span(self, name: str):
        if self.marking:
            with torch.profiler.record_function(f"bench.{name}"):
                yield
        else:
            yield

    @contextlib.contextmanager
    def phase(self, name: str):
        """A set-up phase, its seconds kept by name (added up if repeated)."""
        t0 = time.perf_counter()
        yield
        self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0


# ------------------------------------------------------ device trace


def _start_ns(e) -> int:
    try:
        return int(e.start_ns())
    except AttributeError:
        return int(e.start_us() * 1000)


def merge_intervals(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted disjoint union of [start, end) intervals."""
    out: List[List[float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce_trace(ops: List[Tuple[str, float, float]], window: Tuple[float, float],
                 host: List[Tuple[str, float, float]], top: int = 10) -> dict:
    """Busy seconds (the union of the device's operation intervals inside
    ``window``), the window's length, seconds by operation name and the
    breakdown: the ``top`` operations by device time, and the ``top``
    longest idle gaps, each named by the innermost host span over its
    middle (``untraced host`` where none).  Times in seconds on one clock."""
    w0, w1 = window
    clipped = [(max(s, w0), min(s + d, w1)) for _, s, d in ops if s + d > w0 and s < w1]
    busy_iv = merge_intervals([iv for iv in clipped if iv[1] > iv[0]])
    busy = sum(e - s for s, e in busy_iv)
    by_name: Dict[str, float] = {}
    for name, s, d in ops:
        seg = min(s + d, w1) - max(s, w0)
        if seg > 0:
            by_name[name] = by_name.get(name, 0.0) + seg
    gaps, prev = [], w0
    for s, e in busy_iv + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)

    def doing(t):
        best = None
        for name, s, e in host:
            if s <= t <= e and (best is None or e - s < best[1]):
                best = (name, e - s)
        return best[0] if best else "untraced host"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "busy_s": busy,
        "window_s": w1 - w0,
        "by_name": by_name,
        "breakdown": {
            "device_ops": [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[doing((s + e) / 2), e - s] for s, e in gaps[:top]],
        },
    }


class DeviceTrace:
    """torch.profiler over one span of the window: the device's operations
    and the harness's marked spans, reduced by :func:`reduce_trace` on
    :meth:`stop`.  The span starts and ends on a synchronize."""

    def __init__(self, recorder: Recorder):
        self.recorder = recorder
        self.prof = None
        self.result: Optional[dict] = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.recorder.marking = True
        self._window = torch.profiler.record_function("bench.window")
        self._window.__enter__()

    def stop(self) -> dict:
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self.recorder.marking = False
        self.prof.__exit__(None, None, None)
        ops, host, window = [], [], None
        for e in self.prof.profiler.kineto_results.events():
            dur = e.duration_ns()
            if e.name().startswith("bench."):  # the harness's marks (also shown on
                s = _start_ns(e) / 1e9          # the device's timeline): host spans
                if e.device_type() == DeviceType.CUDA:
                    continue
                if e.name() == "bench.window":
                    window = (s, s + dur / 1e9)
                else:
                    host.append((e.name()[len("bench."):], s, s + dur / 1e9))
            elif e.device_type() == DeviceType.CUDA and dur > 0:
                ops.append((e.name(), _start_ns(e) / 1e9, dur / 1e9))
        self.prof = None
        if window is None or not ops:
            self.result = None
        else:
            self.result = reduce_trace(ops, window, host)
        return self.result


# ------------------------------------------------------------ result


def device_line(chips: int) -> dict:
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i) for i in range(chips))),
    }


def checks_text(checks: Dict[str, dict]) -> str:
    return "; ".join(f"{k}={v['value']!r} (limit {v['limit']!r})" for k, v in checks.items())


def within(checks: Dict[str, dict]) -> bool:
    """Every compared number is a finite value at or under its limit."""
    for v in checks.values():
        x = v["value"]
        if x is None or not (x == x) or x > v["limit"]:
            return False
    return True


def idle_percent(record: dict) -> Optional[float]:
    """100 x (1 - busy / span) of a record's traced span; None untraced."""
    tr = record.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
