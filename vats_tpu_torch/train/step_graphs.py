"""Train steps replayed from CUDA graphs: the port's counterpart of the JAX
package's jitted training programs (``vats_tpu/train/loop.py:166`` and
``:189``, ``train/vision.py:176``, ``train/image_gen.py:141`` and ``:174``,
``train/video_gen.py:88`` and ``:152``).

A :class:`TrainGraphs` keeps one graph per key over a
:class:`~vats_tpu_torch.inference.graphs.GraphSet`: a key is what the caller
says changes the program (the batch's shapes and dtypes, flags, and the
position in the accumulation window, which picks ``MultiSteps``' branch).
A call copies the inputs (the batch, the step's seed, host draws) into the
key's static buffers, replays, and returns the key's static outputs.  On
the CPU, or with ``use_graph`` off, the same body runs eagerly over the same
buffers, so graph and eager compute the same thing.

What a replay reads and writes in place, and why each is safe:

  * the parameters, the optimizer's moments and counters and the state's
    counters: allocated outside the captures, and every update is in place
    (``train/optimizer.py``).  The graphs are keyed on their ``data_ptr``s:
    a state whose tensors were replaced (a new state, a load that assigned)
    drops every graph and captures again.  A load in place
    (``load_checkpoint(target=state)``) shows at the next replay;
  * BatchNorm's running statistics (model buffers): updated in place, and
    keyed the same way;
  * the gradients: each ``.grad`` is allocated once for the state, outside
    any capture, and shared by every key; the body zeroes it
    (:func:`zero_grads`) and the backward adds into it.  So a window of k
    accumulation positions holds one set of gradients, as an eager step
    does, and after a call each ``.grad`` holds the gradient of that call's
    run;
  * host state: ``MultiStepsState.mini_step`` is set by the caller after
    the call (:func:`set_accumulation_position`), since a replay runs no
    Python.

Nothing falls back: a capture that meets a host sync raises, as
``StepGraph`` does.  Nor does a capture of a model that keeps a record as a
Python attribute (``MoELayer.record_routing``): a replay runs no Python, so
the record would be left as the capture made it; such a step is refused on
the card unless ``use_graph`` is off.

Graph and eager run the same kernels in the same order, so they are bit
for bit equal wherever the kernels themselves are deterministic.  cuDNN's
default convolution backward may add with atomics (the image- and video-gen
trainers' convolutions): there the two agree bit for bit only under
``torch.backends.cudnn.deterministic = True``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Hashable, Iterable, List, Optional

import torch

from vats_tpu_torch.inference.graphs import Build, GraphSet
from vats_tpu_torch.nn.moe import MoELayer
from vats_tpu_torch.parallel.layout import is_sharded
from vats_tpu_torch.parallel.mesh import ambient_mesh
from vats_tpu_torch.train.optimizer import MultiSteps, MultiStepsState


def state_tensors(*trees) -> List[torch.Tensor]:
    """Every tensor in ``trees`` (tensors, dicts, lists, tuples, dataclasses
    such as a TrainState or an optimizer state), in a fixed order."""
    out: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))

    for t in trees:
        walk(t)
    return out


def zero_grads(params: Iterable[torch.Tensor]) -> None:
    """Zero each parameter's ``.grad`` in place (left None where there is
    none yet), so that the backward adds into the same buffers every step."""
    for p in params:
        if p.grad is not None:
            p.grad.zero_()


def capturable(params: Dict[str, torch.Tensor]) -> bool:
    """False under a mesh or with sharded params: the ranks exchange over
    gloo through host buffers, which a CUDA graph cannot hold, so those
    steps run eagerly."""
    return ambient_mesh() is None and not is_sharded(params)


def _multi_steps(opt_state) -> Optional[MultiStepsState]:
    while opt_state is not None and not isinstance(opt_state, MultiStepsState):
        opt_state = getattr(opt_state, "inner_opt_state", None)
    return opt_state


def accumulation_position(state) -> Optional[int]:
    """``MultiSteps``' position in its window (the branch a step of the
    TrainState ``state`` takes), or None without accumulation."""
    ms = _multi_steps(state.opt_state)
    return None if ms is None else ms.mini_step


def set_accumulation_position(state, position: Optional[int]) -> None:
    ms = _multi_steps(state.opt_state)
    if ms is not None and position is not None:
        ms.mini_step = position


def advance_accumulation(state, position: Optional[int]) -> None:
    """After a step at window ``position``, the host's position moves on, as
    ``MultiSteps.update_`` moves it in an eager step."""
    tx = state.tx
    while tx is not None and not isinstance(tx, MultiSteps):
        tx = getattr(tx, "inner", None)
    if tx is not None and position is not None:
        set_accumulation_position(state, (position + 1) % tx.k)


class TrainGraphs(GraphSet):
    """A :class:`GraphSet` for a train (or eval) step of a model: one CUDA
    graph per key, dropped and captured again when the state's tensors are
    others.

    ``__call__(key, build, inputs, params=..., state=...)``: ``build()`` makes
    the key's ``(buffers, body, outputs)`` as for ``GraphSet``; ``params``
    are the tensors whose ``.grad`` the body's backward fills (none for an
    eval step): each gets one gradient buffer for the state, made here; the
    body zeroes them (:func:`zero_grads`).  ``state`` is every tensor the
    body reads or updates in place (:func:`state_tensors` of the train state
    and the model's buffers).  ``model``: where given, a capture of it is
    refused while one of its modules keeps a host record
    (``record_routing``).  ``use_graph``: as for ``GraphSet``."""

    def __init__(self, device, model: Optional[torch.nn.Module] = None):
        super().__init__(device)
        self._ptrs: Optional[tuple] = None
        self._grads: List[torch.Tensor] = []
        self._recorders = [m for m in (model.modules() if model is not None else ())
                           if isinstance(m, MoELayer)]

    def __call__(self, key: Hashable, build: Build, inputs: Optional[Dict[str, Any]] = None,
                 *, params: Iterable[torch.Tensor] = (), state: Iterable[torch.Tensor] = (),
                 use_graph: bool = True) -> Any:
        params = list(params)
        ptrs = tuple(t.data_ptr() for t in state)
        if ptrs != self._ptrs:
            self.clear()
            self._ptrs = ptrs
            self._grads = [torch.zeros_like(p) for p in params]
        for p, g in zip(params, self._grads):
            p.grad = g
        use_graph = use_graph and self.use_graph and self.device.type == "cuda"
        if use_graph and any(m.record_routing for m in self._recorders):
            raise RuntimeError(
                "a module of this step keeps its routing record (record_routing) as a "
                "Python attribute, which a CUDA graph's replay cannot update; set "
                "`graphs.use_graph = False` to run the step eagerly with the record")
        return super().__call__(key, build, inputs, use_graph=use_graph)

    def clear(self) -> None:
        super().clear()
        self._grads = []
        self._ptrs = None


def clone_outputs(outputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The static outputs copied, so that the next replay of the key leaves
    what a caller holds alone."""
    return {k: v.clone() for k, v in outputs.items()}


def write_outputs(outputs: Dict[str, torch.Tensor], values: Dict[str, torch.Tensor]) -> None:
    """Copy a body's results into its static outputs (made by ``build``)."""
    for k, v in values.items():
        outputs[k].copy_(v)


def scalar_outputs(names: Iterable[str], device, dtypes: Optional[Dict[str, torch.dtype]] = None
                   ) -> Dict[str, torch.Tensor]:
    """Static 0-d outputs (fp32 unless ``dtypes`` says otherwise)."""
    dtypes = dtypes or {}
    return {n: torch.zeros((), dtype=dtypes.get(n, torch.float32), device=device)
            for n in names}


def static_like(x: torch.Tensor, device) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device=device)
