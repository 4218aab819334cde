"""Profiling and tracing hooks.

Counterpart of ``vats_tpu/utils/profiling.py`` over ``torch.profiler``:

  * :func:`trace` -- context manager around ``torch.profiler.profile``
    (host activity, and the card's kernels where there is a card) that
    writes a Chrome trace (``chrome://tracing`` or Perfetto) into
    ``log_dir``;
  * :class:`StepTimer` -- wall-clock step timing with tokens/s, safe under
    asynchronous launches (it waits for the device of the result it is
    given);
  * :func:`annotate` -- a named region (``torch.profiler.record_function``)
    so train-loop phases show up in the trace timeline.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Dict, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str = "profiles") -> Iterator[str]:
    """Profile the enclosed block; its Chrome trace is written to
    ``log_dir/trace_<pid>_<ns>.json`` on exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named region that appears in profiler timelines (nests)."""
    return torch.profiler.record_function(name)


def _devices(result: Any, found: set) -> set:
    if isinstance(result, torch.Tensor):
        found.add(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _devices(v, found)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _devices(v, found)
    elif dataclasses.is_dataclass(result) and not isinstance(result, type):
        for f in dataclasses.fields(result):
            _devices(getattr(result, f.name), found)
    return found


class StepTimer:
    """Rolling step timing; call ``tick(result, tokens=...)`` once per step."""

    def __init__(self, window: int = 50):
        self.window = window
        self._durations = []
        self._tokens = []
        self._last = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def tick(self, result: Any = None, tokens: int = 0) -> float:
        """Returns the step duration.  Every card that holds a tensor of
        ``result`` (a tensor, or dicts, lists, tuples and dataclasses of
        them) is synchronized first, so queued launches don't fake instant
        steps."""
        if result is not None:
            for dev in _devices(result, set()):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        now = time.perf_counter()
        dt = now - (self._last if self._last is not None else now)
        self._last = now
        self._durations.append(dt)
        self._tokens.append(tokens)
        if len(self._durations) > self.window:
            self._durations.pop(0)
            self._tokens.pop(0)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self._durations:
            return {}
        total = sum(self._durations)
        return {
            "mean_step_s": total / len(self._durations),
            "steps_per_s": len(self._durations) / total if total else 0.0,
            "tokens_per_s": sum(self._tokens) / total if total else 0.0,
        }
