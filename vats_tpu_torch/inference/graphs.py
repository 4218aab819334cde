"""Decode steps captured once as CUDA graphs and replayed.

The JAX package compiles its decode loops (``jax.jit`` over a
``while_loop`` / ``fori_loop``); nothing here has a counterpart there.  In
PyTorch every operation of a decode step is a launch from Python, and at
decode sizes the host takes longer to issue a step than the card takes to
run it.  A :class:`StepGraph` records one step (a model forward and its
sampling, or a block of k of them) into a ``torch.cuda.CUDAGraph`` and
replays it with one call.

A step is a function of tensors that outlive the graph: the caches, tokens,
validity, lengths, logits and, in the serving engine, the static input
buffers its host state is copied into (in stream order, before the replay)
and the static output it is read from (after it).  A replay runs the
recorded kernels on the same addresses, so the step updates all of them in
place.

The first run of a step is its warm-up: it runs eagerly on the graph's side
stream, as a real step, so that what is set up lazily at a first call is set
up outside the capture (cuBLAS's workspace for that stream, kernel modules,
K1/K4's counters for that stream); the capture follows at once, on the same
stream.  Every later run replays the graph.  A capture that meets a host
sync (``.item()``, ``bool(tensor)``, a data-dependent shape) raises, as does
a failed replay: nothing falls back to the eager step on the card.

Draws from a ``torch.Generator`` (``sample_logits``) come from the
generator's state at replay time: the generator is registered with the
graph, so replays draw what eager steps from the same state would.  The
kernels' launch counts (``ops/kernels.count_launch``) grow by the launches
recorded in the capture, once per replay.

On the CPU there are no graphs: the entry points run the same step eagerly.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from vats_tpu_torch.ops import kernels
from vats_tpu_torch.ops.decode_attention import take_counters

#: decode steps between two host checks of whether any row is unfinished
#: (when an EOS is set; each check is a host sync).  A step after every row
#: has finished changes no output, so the check only ends the loop early.
FINISH_CHECK_EVERY = 8


class StepGraph:
    """One step, run eagerly once on a side stream, then captured and
    replayed on the current stream.

    ``body`` takes no argument and returns nothing: it reads and writes
    tensors that outlive the graph.  ``generator``: a ``torch.Generator``
    the step draws from (the default CUDA generator is registered by
    PyTorch itself).  ``stream`` and ``pool`` (``torch.cuda.
    graph_pool_handle()``): a side stream and a memory pool shared by
    graphs that never replay at once and pass nothing to each other through
    the pool."""

    def __init__(self, body: Callable[[], None], device: torch.device, *,
                 generator: Optional[torch.Generator] = None,
                 stream: Optional[torch.cuda.Stream] = None, pool=None):
        self.body = body
        self.device = torch.device(device)
        self.generator = generator
        self.stream = stream if stream is not None else torch.cuda.Stream(self.device)
        self.pool = pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: {counted wrapper: launches recorded in the capture}
        self.tally: Dict[object, int] = {}
        self.replays = 0
        self.capture_s = 0.0
        self._counters = None  # K1/K4's counters the capture holds

    def run(self) -> None:
        """One step: the warm-up and the capture the first time, then a
        replay."""
        if self.graph is None:
            self.warm_up()
            self.capture()
        else:
            self.replay()

    def warm_up(self) -> None:
        """Run the step eagerly on the side stream, ordered after the
        current stream's work and before what follows on it."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            self.body()
        current.wait_stream(self.stream)

    def capture(self) -> None:
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        with kernels.launch_tally() as tally:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                self.body()
        self._counters = take_counters(self.stream)
        self.graph, self.tally = graph, dict(tally)
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1
        for counted, n in self.tally.items():
            counted.launches += n


def run_steps(step: Callable[[], None], n: int, *, device: torch.device,
              use_graph: bool, unfinished: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> Optional[StepGraph]:
    """Run ``step`` ``n`` times: on the card through a :class:`StepGraph`
    when ``use_graph``, else eagerly.  With ``unfinished`` (a [B] bool
    tensor the step updates), stop early once no row is unfinished, asked
    every :data:`FINISH_CHECK_EVERY` steps.  Returns the graph, or None."""
    graph = StepGraph(step, device, generator=generator) if use_graph else None
    for i in range(n):
        if (unfinished is not None and i and i % FINISH_CHECK_EVERY == 0
                and not bool(unfinished.any())):
            break
        if graph is None:
            step()
        else:
            graph.run()
    return graph
