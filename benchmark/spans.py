"""The program's own spans (``vats.*``, ``vats_tpu_torch/utils/profiling``)
read against the device's timeline, and the per-layer readings they give.

    python benchmark/spans.py --workload medium_e8.decode_heavy --seed 7 \
        --seconds 51

runs the cell once as ``--trace 1`` does, with two additions, and prints
one JSON line: the readings below, the cell's own per-layer metrics, the
breakdown (idle gaps named by the innermost span, the program's included)
and ``program`` / ``probe`` as defined here.  The benchmark's own runs
never run this: it stands in for what ``harness.DeviceTrace.stop`` and the
drivers would do to report these readings, and installs itself in their
place for its own run only (:func:`main`).

Attribution (:func:`attribute`), on the profiler's one clock:

  * ``idle_s``: every idle second of the traced span (the gaps between the
    union of the device's operation intervals) under the path of program
    spans open on the host at that moment (outermost first, joined by
    ``/``; e.g. ``serve.admit/serve.prefill/serve.prefill.wait``), or
    ``harness only`` where only the harness's spans are open, or
    ``untraced``; the parts sum to the idle total;
  * ``device_s``: every device second of the span under the path open when
    the operation was launched: each operation is joined to its runtime
    launch event (``cudaLaunchKernel``, ``cudaGraphLaunch``, a copy's
    ``cudaMemcpyAsync``, ...) by correlation id, on whatever thread, so a
    graph's replayed kernels fall under the ``graph.run`` that replayed
    them and the backward's kernels, launched by autograd's thread, under
    ``train.backward``.  An operation with no launch event counts under
    ``unattributed``.

The probe (:func:`probe_serve`, :func:`probe_train`), after the window: a
replay runs no Python, so the spans inside a step's body (``moe.*``,
``train.*``) exist only where the body runs eagerly.  The probe runs a
short eager stretch (3 engine steps, or one whole optimizer step) after one
unprofiled eager one, under its own profiler, and attributes its device
seconds the same way.  Eager and replay run the same kernels in the same
order, so its shares carry over to the replays; its launch gaps do not,
and nothing reads them.  Its steps count toward nothing of the run.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402

PROGRAM, BENCH = "vats.", "bench."
HARNESS_ONLY, UNTRACED, UNATTRIBUTED = "harness only", "untraced", "unattributed"
#: the prefix of the host's launch events: the CUDA runtime's and driver's
#: calls (``cudaLaunchKernel``, ``cuLaunchKernelEx``, ...), whose
#: correlation id the device's operations carry
LAUNCH_PREFIX = "cu"

Span = Tuple[str, float, float]  # (name, start, end), seconds


@dataclass
class Events:
    """A profiler's events, on its clock in seconds."""

    ops: List[Tuple[str, float, float, int]] = field(default_factory=list)  # name, start, dur, corr
    launches: Dict[int, float] = field(default_factory=dict)  # correlation id -> launch time
    program: List[Span] = field(default_factory=list)
    bench: List[Span] = field(default_factory=list)
    window: Optional[Tuple[float, float]] = None


def collect(events) -> Events:
    """Sort ``prof.profiler.kineto_results.events()`` into :class:`Events`:
    the device's operations, the host's launch events, the program's and
    the harness's spans (their echoes on the device's timeline left out)
    and the harness's ``bench.window``."""
    from torch.autograd import DeviceType

    out = Events()
    for e in events:
        name, dur = e.name(), e.duration_ns()
        s = e.start_ns() / 1e9
        on_device = e.device_type() == DeviceType.CUDA
        if name.startswith(PROGRAM) or name.startswith(BENCH):
            if on_device:
                continue
            span = (name.split(".", 1)[1], s, s + dur / 1e9)
            if name == BENCH + "window":
                out.window = span[1:]
            else:
                (out.program if name.startswith(PROGRAM) else out.bench).append(span)
        elif on_device:
            if dur > 0:
                out.ops.append((name, s, dur / 1e9, e.correlation_id()))
        elif name.startswith(LAUNCH_PREFIX):
            out.launches[e.correlation_id()] = s
    return out


class Paths:
    """The path of program spans open at any moment (outermost first,
    joined by ``/``), else ``harness only`` where a harness span is open,
    else ``untraced``: constant between consecutive span boundaries."""

    def __init__(self, program: Sequence[Span], bench: Sequence[Span] = ()):
        spans = [(n, s, e, True) for n, s, e in program] + [(n, s, e, False) for n, s, e in bench]
        marks = sorted([(s, 1, i) for i, (_, s, _, _) in enumerate(spans)]
                       + [(e, 0, i) for i, (_, _, e, _) in enumerate(spans)])
        open_: Dict[int, tuple] = {}
        self.times: List[float] = []
        self.paths: List[str] = []
        for t, starts, i in marks:
            if starts:
                open_[i] = spans[i]
            else:
                open_.pop(i, None)
            mine = sorted((x for x in open_.values() if x[3]), key=lambda x: (x[1], -x[2]))
            path = ("/".join(x[0] for x in mine) if mine
                    else HARNESS_ONLY if open_ else UNTRACED)
            if self.times and self.times[-1] == t:
                self.paths[-1] = path
            else:
                self.times.append(t)
                self.paths.append(path)

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.times, t) - 1
        return self.paths[i] if i >= 0 else UNTRACED

    def split(self, a: float, b: float, into: Dict[str, float]) -> None:
        """Add the seconds of [a, b) to ``into`` by path."""
        i = bisect.bisect_right(self.times, a) - 1
        while a < b:
            end = self.times[i + 1] if i + 1 < len(self.times) else b
            end = min(end, b)
            path = self.paths[i] if i >= 0 else UNTRACED
            if end > a:
                into[path] = into.get(path, 0.0) + end - a
            a, i = end, i + 1


def idle_gaps(ops, window) -> List[Tuple[float, float]]:
    """The gaps of ``window`` between the union of the operations' intervals."""
    w0, w1 = window
    busy = harness.merge_intervals([(max(s, w0), min(s + d, w1)) for _, s, d, *_ in ops
                                    if s + d > w0 and s < w1])
    gaps, prev = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    return gaps


def attribute(ev: Events, window: Optional[Tuple[float, float]] = None) -> dict:
    """``idle_s`` and ``device_s`` by path of program spans (module
    docstring) inside ``window`` (the traced span; by default the first
    operation's start to the last one's end)."""
    if window is None:
        window = (min(s for _, s, _, _ in ev.ops), max(s + d for _, s, d, _ in ev.ops))
    w0, w1 = window
    paths = Paths(ev.program, ev.bench)
    idle: Dict[str, float] = {}
    for a, b in idle_gaps(ev.ops, window):
        paths.split(a, b, idle)
    device: Dict[str, float] = {}
    for _, s, d, corr in ev.ops:
        seg = min(s + d, w1) - max(s, w0)
        if seg <= 0:
            continue
        t = ev.launches.get(corr)
        key = UNATTRIBUTED if t is None else paths.at(t)
        device[key] = device.get(key, 0.0) + seg
    return {"idle_s": idle, "device_s": device, "window_s": w1 - w0}


def under(shares: Dict[str, float], *names: str, beneath: Optional[str] = None) -> float:
    """Seconds of the paths that hold one of ``names``; with ``beneath``,
    of the paths that hold it, and one of ``names`` after it where given."""
    total = 0.0
    for path, s in shares.items():
        parts = path.split("/")
        if beneath is not None:
            if beneath not in parts:
                continue
            parts = parts[parts.index(beneath) + 1:]
            if not names:
                total += s
                continue
        if any(p in names for p in parts):
            total += s
    return total


# ------------------------------------------------------------ the trace


class ProgramTrace(harness.DeviceTrace):
    """``harness.DeviceTrace`` that also reads the program's spans: the idle
    gaps are named by the innermost span of either, and the result holds
    ``program`` (:func:`attribute` over the traced span)."""

    def stop(self) -> Optional[dict]:
        torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self.recorder.marking = False
        self.prof.__exit__(None, None, None)
        ev = collect(self.prof.profiler.kineto_results.events())
        self.prof = None
        if ev.window is None or not ev.ops:
            self.result = None
            return None
        ops = [(n, s, d) for n, s, d, _ in ev.ops]
        self.result = harness.reduce_trace(ops, ev.window, ev.bench + ev.program)
        self.result["program"] = attribute(ev, ev.window)
        counts: Dict[str, int] = {}
        for name, _, _ in ev.program + ev.bench:
            counts[name] = counts.get(name, 0) + 1
        self.result["program"].update(launch_events=len(ev.launches), span_counts=counts)
        return self.result


# ------------------------------------------------------------ the probe


def _profiled(fn) -> Tuple[dict, float]:
    """(:func:`attribute` of what ``fn`` runs, its wall seconds)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ev = collect(prof.profiler.kineto_results.events())
    if not ev.ops:
        return {"idle_s": {}, "device_s": {}, "window_s": 0.0}, wall
    return attribute(ev), wall


def probe_serve(engine, steps: int = 3) -> dict:
    """``steps`` eager engine steps after one unprofiled eager step; the
    engine's ``use_graph`` is put back after."""
    was, engine.graphs.use_graph = engine.graphs.use_graph, False
    try:
        t0 = time.perf_counter()
        engine.step()
        out, wall = _profiled(lambda: [engine.step() for _ in range(steps)])
    finally:
        engine.graphs.use_graph = was
    return dict(out, steps=steps, seconds=time.perf_counter() - t0, profiled_s=wall)


def probe_train(step, state, batches, seeds, accum: int) -> dict:
    """One whole optimizer step (``accum`` micro-steps) eagerly after one
    unprofiled eager optimizer step, from the feed ``batches``, drawing
    dropout from ``seeds``; the step's ``use_graph`` is put back after."""
    was, step.graphs.use_graph = step.graphs.use_graph, False

    def optimizer_step():
        for _ in range(accum):
            step(state, next(batches), next(seeds))

    try:
        t0 = time.perf_counter()
        optimizer_step()
        out, wall = _profiled(optimizer_step)
    finally:
        step.graphs.use_graph = was
    return dict(out, micro_steps=accum, seconds=time.perf_counter() - t0, profiled_s=wall)


# ------------------------------------------------------------ readings


def _idle_share(rec, *names):
    tr = rec.get("trace") or {}
    prog = tr.get("program")
    if not prog or tr.get("window_s", 0) <= 0:
        return None
    return 100.0 * under(prog["idle_s"], *names) / tr["window_s"]


def idle_admit_share(rec):
    """Idle share of the traced span under ``serve.admit``, in percent."""
    return _idle_share(rec, "serve.admit")


def idle_block_share(rec):
    """Idle share under ``serve.dispatch``, ``serve.commit``, ``serve.retire``."""
    return _idle_share(rec, "serve.dispatch", "serve.commit", "serve.retire")


def idle_feed_share(rec):
    """Idle share under ``data.feed``."""
    return _idle_share(rec, "data.feed")


def moe_dispatch_share(rec):
    """The probe's device seconds under ``moe.route``, ``moe.dispatch`` and
    ``moe.combine`` beneath ``serve.dispatch``, over all beneath it."""
    dev = (rec.get("probe") or {}).get("device_s")
    if not dev:
        return None
    block = under(dev, beneath="serve.dispatch")
    if block <= 0:
        return None
    return 100.0 * under(dev, "moe.route", "moe.dispatch", "moe.combine",
                         beneath="serve.dispatch") / block


def optimizer_share(rec):
    """The probe's device seconds under ``train.optimizer`` over those under
    ``train.forward``, ``train.backward`` and ``train.optimizer``."""
    dev = (rec.get("probe") or {}).get("device_s")
    if not dev:
        return None
    step = under(dev, "train.forward", "train.backward", "train.optimizer")
    if step <= 0:
        return None
    return 100.0 * under(dev, "train.optimizer") / step


#: reading name -> (reader, cells)
READINGS = {
    "idle_admit_share.decode": (idle_admit_share, ("medium_e8.decode_heavy",)),
    "idle_block_share.decode": (idle_block_share, ("medium_e8.decode_heavy",)),
    "moe_dispatch_share.decode": (moe_dispatch_share, ("medium_e8.decode_heavy",)),
    "idle_feed_share.train": (idle_feed_share, ("medium_moe.train_packed_2k",
                                                "medium_moe.train_short_512")),
    "optimizer_share.train": (optimizer_share, ("medium_moe.train_packed_2k",
                                                "medium_moe.train_short_512")),
}


# ------------------------------------------------------------ the run


def install(holder: dict) -> None:
    """Put :class:`ProgramTrace` and the probes in the harness's and the
    drivers' place, for this process's run: the trace reads the program's
    spans; serving probes the engine before ``finish`` frees it; training
    keeps the step and its state and probes them before the reference runs.
    The probe goes into the run's record as ``probe``."""
    import vats_tpu_torch.train as vt
    from benchmark.drivers import serve, train

    harness.DeviceTrace = ProgramTrace
    finish, run_train, check = serve.finish, train.run, train.check
    make_step, make_state = vt.make_train_step, vt.create_train_state

    def serve_finish(ctx, drive, *rest):
        probe = probe_serve(drive.eng)
        out = finish(ctx, drive, *rest)
        out["record"]["probe"] = probe
        return out

    def make_train_step(*a, **k):
        holder["step"] = make_step(*a, **k)
        return holder["step"]

    def create_train_state(*a, **k):
        holder["state"] = make_state(*a, **k)
        return holder["state"]

    def train_check(ctx, *rest):
        from benchmark import traffic as tr
        from vats_tpu_torch.data.feed import device_batches

        m = ctx.config["model"]
        batches = device_batches(tr.lm_batches(ctx.mix, ctx.seed, m["vocab_size"]), ctx.device)
        seeds = (train.step_seed(ctx.seed, 1_000_000 + i) for i in range(1 << 30))
        holder["probe"] = probe_train(holder.pop("step"), holder.pop("state"), batches, seeds,
                                      int(ctx.mix["grad_accum_steps"]))
        import gc

        gc.collect()
        torch.cuda.empty_cache()
        return check(ctx, *rest)

    def train_run(ctx):
        out = run_train(ctx)
        out["record"]["probe"] = holder.pop("probe", None)
        return out

    serve.finish, train.run, train.check = serve_finish, train_run, train_check
    vt.make_train_step, vt.create_train_state = make_train_step, create_train_state


def main(argv=None) -> int:
    process_start = harness.process_start_wall()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from benchmark import run

    install({})
    manifest, ctx = run.make_ctx(args.workload, args.seed, args.seconds, trace=True,
                                 process_start=process_start)
    out = run.drive(ctx)
    rec = out["record"]
    metrics = {}
    for metric in manifest["per_layer"]:
        if run.applies(metric, args.workload):
            metrics[metric["name"]] = harness.load_reader(metric["name"])(rec)
    readings = {name: reader(rec) for name, (reader, cells) in READINGS.items()
                if args.workload in cells}
    tr = rec.get("trace") or {}
    line = {"workload": args.workload, "seed": args.seed, "correct": harness.within(out["checks"]),
            "readings": readings, "metrics": metrics, "breakdown": tr.get("breakdown"),
            "busy_s": tr.get("busy_s"), "window_s": tr.get("window_s"),
            "program": tr.get("program"), "probe": rec.get("probe"),
            "device": out["device"], "checks": out["checks"]}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
