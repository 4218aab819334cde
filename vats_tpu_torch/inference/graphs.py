"""Steps captured once as CUDA graphs and replayed: the port's counterpart
of the JAX package's compiled programs.

In PyTorch every operation is a launch from Python, and at decode sizes,
and for the forwards below, the host takes longer to issue a step than
the card takes to run it.  A :class:`StepGraph` records one step into a
``torch.cuda.CUDAGraph`` and replays it with one call; a :class:`GraphSet`
keeps one per key (a shape), as ``jax.jit`` keeps one program per input
shape.  Each graph stands for a ``jax.jit`` of ``vats_tpu``:

  * the serving engine's tail prefill, one per (bucket, padded group size)
    (``vats_tpu/inference/serving.py:588``), its k-step decode block
    (``:783``) and its speculative verify forward (``:920``);
  * the vision eval step, one per batch shape (``vats_tpu/train/vision.py:190``);
  * the decode step of the ``generate*`` loops (``generate``,
    ``generate_paged``, the image, video and fused-stream loops), each
    compiled there with its ``while_loop`` / ``fori_loop``.

A step is a function of tensors that outlive the graph: the caches, tokens,
validity, lengths, logits, the parameters and the static input buffers its
inputs are copied into (in stream order, before the replay) and the static
outputs it is read from (after it).  A replay runs the recorded kernels on
the same addresses, so the step updates all of them in place.

The first run of a step is its warm-up: it runs eagerly on the graph's side
stream, as a real step, so that what is set up lazily at a first call is set
up outside the capture (cuBLAS's workspace for that stream, kernel modules
and the tensor-map encoder K2 looks up, K1/K4's counters for that stream);
the capture follows at once, on the same stream.  Every later run replays
the graph.  A capture that meets a host sync (``.item()``,
``bool(tensor)``, a data-dependent shape, a copy from pageable host
memory) raises, as does a failed replay: nothing falls back to the eager
step on the card.

Draws from a ``torch.Generator`` (``sample_logits``) come from the
generator's state at replay time: the generator is registered with the
graph, so replays draw what eager steps from the same state would.  The
kernels' launch counts (``ops/kernels.count_launch``) grow by the launches
recorded in the capture, once per replay.

On the CPU there are no graphs: the entry points run the same step eagerly.
"""

from __future__ import annotations

import gc
import time
from collections.abc import Mapping
from typing import Any, Callable, Dict, Hashable, Iterator, Optional, Tuple

import numpy as np
import torch

from vats_tpu_torch.ops import kernels
from vats_tpu_torch.ops.decode_attention import take_counters
from vats_tpu_torch.utils.profiling import annotate

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
        # no garbage collection while capturing: garbage that holds another
        # CUDA graph would destroy it there, which CUDA refuses during
        # a capture, and the capture is then invalid
        collecting = gc.isenabled()
        gc.disable()
        try:
            with kernels.launch_tally() as tally:
                with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                    self.body()
        finally:
            if collecting:
                gc.enable()
        self._counters = take_counters(self.stream)
        self.graph, self.tally = graph, dict(tally)
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1
        for counted, n in self.tally.items():
            counted.launches += n


def copy_to_static(buf: torch.Tensor, src) -> torch.Tensor:
    """Copy ``src`` (a host array or a tensor) into the static buffer
    ``buf``, in stream order.  Host data goes through pinned memory, so the
    copy is queued behind the stream's work and never waits for it (a copy
    from pageable memory would sync, and raise under capture)."""
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(np.array(src))  # a private copy
    if buf.is_cuda and not src.is_cuda:
        src = src.pin_memory()
    return buf.copy_(src, non_blocking=buf.is_cuda)


class _Entry:
    """A key's static input buffers, its body, what a call returns and, once
    captured, its graph."""

    def __init__(self, buffers: Dict[str, torch.Tensor], body: Callable[[], None],
                 outputs: Any):
        self.buffers, self.body, self.outputs = buffers, body, outputs
        self.graph: Optional[StepGraph] = None


#: ``build() -> (buffers, body, outputs)``: a key's static input buffers by
#: name, its body (no argument; reads the buffers, writes the outputs) and
#: what a call returns (the static outputs)
Build = Callable[[], Tuple[Dict[str, torch.Tensor], Callable[[], None], Any]]


class GraphSet(Mapping):
    """One :class:`StepGraph` per key, each over static buffers of its own:
    the port's counterpart of a ``jax.jit`` that compiles one program per
    input shape.  A key is a tuple of shapes, dtypes and flags that the
    caller builds.

    A call copies its inputs into the key's buffers, runs the body (the
    warm-up and the capture the first time, a replay after that) and
    returns the key's static outputs; the caller clones or fetches them
    before the next call of that key.  Every buffer and output is allocated
    by ``build``, outside any capture.  That matters: the graphs of one set
    share one side stream and one memory pool, so a later capture reuses the
    blocks an earlier one freed, and a tensor allocated inside one capture
    and read after another graph's replay could have been overwritten.  So
    nothing but the static buffers and outputs crosses a replay.

    As a mapping: captured key -> its :class:`StepGraph`.  ``entries`` holds
    every key's buffers, also on the CPU and on the eager path, where the
    same body runs with no graph.

    ``use_graph``: replay on the card (the default there; the CPU always
    runs eagerly); False runs every body eagerly over the same buffers.

    Spans (``utils/profiling.annotate``): ``graph.inputs`` over the input
    copies; ``graph.run`` over the body's run, a replay or an eager call
    alike; ``graph.capture`` over a key's warm-up and capture.  Each carries
    the key."""

    def __init__(self, device, *, generator: Optional[torch.Generator] = None):
        self.device = torch.device(device)
        self.generator = generator
        self.use_graph = self.device.type == "cuda"
        self.entries: Dict[Hashable, _Entry] = {}
        self._stream: Optional[torch.cuda.Stream] = None
        self._pool = None

    def __call__(self, key: Hashable, build: Build, inputs: Optional[Dict[str, Any]] = None,
                 *, use_graph: bool = True) -> Any:
        """Run ``key``'s body on ``inputs`` ({buffer name: host array or
        tensor}); ``build`` makes the key's entry the first time.  On the
        card with ``use_graph`` and :attr:`use_graph`, from its graph; else
        eagerly."""
        entry = self.entries.get(key)
        if entry is None:
            entry = self.entries[key] = _Entry(*build())
        if inputs:
            with annotate("graph.inputs"):
                for name, src in inputs.items():
                    copy_to_static(entry.buffers[name], src)
        named = lambda: {"key": str(key)}  # noqa: E731
        if not (use_graph and self.use_graph and self.device.type == "cuda"):
            with annotate("graph.run", named):
                entry.body()
            return entry.outputs
        if entry.graph is None:
            if self._pool is None:
                self._stream = torch.cuda.Stream(self.device)
                self._pool = torch.cuda.graph_pool_handle()
            entry.graph = StepGraph(entry.body, self.device, generator=self.generator,
                                    stream=self._stream, pool=self._pool)
        with annotate("graph.run" if entry.graph.graph is not None else "graph.capture", named):
            entry.graph.run()
        return entry.outputs

    def clear(self) -> None:
        """Drop every entry and graph (the next call of a key builds and
        captures it again)."""
        self.entries.clear()

    def __getitem__(self, key: Hashable) -> StepGraph:
        graph = self.entries[key].graph
        if graph is None:
            raise KeyError(key)
        return graph

    def __iter__(self) -> Iterator[Hashable]:
        return (k for k, e in self.entries.items() if e.graph is not None)

    def __len__(self) -> int:
        return sum(e.graph is not None for e in self.entries.values())

    @property
    def capture_s(self) -> float:
        """Seconds spent capturing, summed over the set's graphs."""
        return sum(g.capture_s for g in self.values())

    @property
    def replays(self) -> int:
        return sum(g.replays for g in self.values())


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
