"""Profiling and tracing hooks.

Counterpart of ``vats_tpu/utils/profiling.py`` over ``torch.profiler``:

  * :func:`trace` -- context manager around ``torch.profiler.profile``
    (host activity, and the card's kernels where there is a card) that
    writes a Chrome trace (``chrome://tracing`` or Perfetto) into
    ``log_dir``;
  * :func:`annotate` -- the program's one span: a named region of the
    profiler's timeline (``vats.<name>``) while a profiler runs, and a
    shared no-op otherwise.

Spans exist exactly when someone profiles (:func:`trace`, or any other
``torch.profiler.profile``), on the profiler's own clock, so they line up
with the device's operations in its timeline; a kernel's launch event, at
the time it was queued, falls inside the spans open on the host then.
They keep no record of their own.  With no profiler running a span costs
one read of the profiler's flag and an empty ``with``.

A span is an operator event of the profiler (``RecordFunctionFast``), not a
user annotation: the profiler draws no echo of it on the device's
timeline, so a reduction of the device's operations sees only the device's
work.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

#: the prefix of every span's name in a profiler's timeline
PREFIX = "vats."


class _Off:
    """The shared no-op span."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()
_span = torch._C._profiler._RecordFunctionFast


@contextlib.contextmanager
def trace(log_dir: str = "profiles") -> Iterator[str]:
    """Profile the enclosed block; its Chrome trace, the program's spans
    included, is written to ``log_dir/trace_<pid>_<ns>.json`` on exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str, args: Optional[Callable[[], Dict[str, str]]] = None):
    """The span ``vats.<name>`` (spans nest) while a profiler runs; else the
    shared no-op.  ``args``: a function that makes ``{key: text}`` for the
    span, called only while a profiler runs; the profiler keeps it where it
    records operators' inputs (``record_shapes=True``)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if args is None:
        return _span(PREFIX + name)
    return _span(PREFIX + name, (), args())  # a dict: anything else aborts
