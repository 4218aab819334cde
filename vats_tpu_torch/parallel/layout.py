"""Per-leaf shardings of a model's parameters and optimizer state.

Counterpart of ``tree_shardings`` in ``vats_tpu/parallel/sharded.py`` and of
what GSPMD does with it.  Each module names the logical axes of its
parameters (``param_logical_axes()``: relative name -> one logical name a
dimension, in the port's own layout, so an ``nn.Linear`` weight reads
``(out, in)``, the transpose of the flax kernel's).  The logical rules
(``parallel/mesh.py``) resolve those names to a spec over the mesh; a
parameter with no names, a bias for instance, is replicated, as in JAX.

:meth:`ParamLayout.shard_` keeps on each rank only its block of every
parameter and marks it with a :class:`ShardInfo` (``p.shard_info``); the
optimizer's moments, made from those blocks, get the same mark
(:meth:`ParamLayout.tag`).  Model code reads a marked parameter through
:func:`gathered`, which all-gathers the dimensions that the module does not
compute on its own block: ``fsdp``'s (``embed``) always, ``tensor``'s where
it is a vocabulary or a convolution's output, ``expert``'s in the router.
Its gradient comes back as each rank's block: reduce-scattered where the
ranks along the axis hold different rows of the batch, taken as it is where
they computed the same loss.  The dimensions a module computes on its block
(``heads``, ``kv_heads``, ``mlp``, ``expert_mlp`` over ``tensor``, and
``experts`` over ``expert`` in the experts' own products) stay sharded:
the module runs its share of the work there (``nn/attention.dense``,
``nn/moe``).

After the backward :func:`reduce_gradients` sums each leaf's gradient over
the token axes (data, fsdp, seq) that its gather has not summed already,
and :func:`sharded_global_norm` sums each leaf's squares once: over its
shards, never over its replicas.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import torch
from torch import nn

from vats_tpu_torch.parallel.collectives import all_gather, all_reduce, gather
from vats_tpu_torch.parallel.mesh import (
    TOKEN_AXES,
    Mesh,
    NamedSharding,
    inputs_sharded,
    logical_to_mesh_spec,
)

#: logical dimensions that a module computes on this rank's block when they
#: are sharded over ``tensor``: never gathered on use
TENSOR_LOCAL = ("heads", "kv_heads", "mlp", "expert_mlp")


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    """Where a leaf lives: its mesh, one mesh axis (or None) a dimension,
    the logical names it was resolved from, and the whole leaf's shape."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]
    logical: Tuple[Optional[str], ...]
    shape: Tuple[int, ...]

    def axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.spec if a is not None)

    def shard_numel(self) -> int:
        return math.prod(self.shape) // self.mesh.axis_size(self.axes())


def logical_axes(model: nn.Module) -> Dict[str, Tuple[Optional[str], ...]]:
    """{parameter name: logical names} over every module of ``model`` that
    declares its own (``param_logical_axes()``); unnamed parameters are not
    listed (replicated)."""
    out = {}
    params = dict(model.named_parameters())
    for prefix, module in model.named_modules():
        declare = getattr(module, "param_logical_axes", None)
        if declare is None:
            continue
        for rel, names in declare().items():
            name = f"{prefix}.{rel}" if prefix else rel
            if name not in params:
                raise KeyError(f"{type(module).__name__} names the axes of {rel!r}, "
                               "which it does not hold")
            if len(names) != params[name].dim():
                raise ValueError(f"{name}: {len(names)} logical names for a "
                                 f"{params[name].dim()}-d parameter")
            out[name] = tuple(names)
    return out


def _spec(names, shape, mesh: Mesh, rules, where: str) -> Tuple[Optional[str], ...]:
    spec = logical_to_mesh_spec(names, rules, mesh)
    for dim, axis in enumerate(spec):
        if isinstance(axis, tuple):  # one mesh axis a parameter dimension (the rules')
            raise ValueError(f"{where}: dimension {dim} over several axes {axis}")
        if axis is not None and shape[dim] % mesh.shape[axis]:
            raise ValueError(f"{where}: dimension {dim} of size {shape[dim]} does not "
                             f"divide over {axis} ({mesh.shape[axis]} ranks)")
    return spec


class ParamLayout:
    """The :class:`ShardInfo` of every parameter of ``model`` on ``mesh``."""

    def __init__(self, model: nn.Module, mesh: Mesh, rules=None):
        self.mesh = mesh
        names = logical_axes(model)
        self.infos: Dict[str, ShardInfo] = {}
        for name, p in model.named_parameters():
            if getattr(p, "shard_info", None) is not None:
                raise ValueError(f"{name} is sharded already")
            shape = tuple(p.shape)
            logical = names.get(name, (None,) * len(shape))
            self.infos[name] = ShardInfo(mesh, _spec(logical, shape, mesh, rules, name),
                                         logical, shape)

    def shardings(self) -> Dict[str, NamedSharding]:
        return {n: NamedSharding(self.mesh, i.spec) for n, i in self.infos.items()}

    def shard_(self, model: nn.Module) -> None:
        """Keep only this rank's block of each parameter (in fresh memory,
        so the whole tensor is freed) and mark it."""
        with torch.no_grad():
            for name, p in model.named_parameters():
                info = self.infos[name]
                if getattr(p, "shard_info", None) is not None:
                    raise ValueError(f"{name} is sharded already")
                p.data = shard_of(p.data, info).clone()
                p.shard_info = info

    def tag(self, tree: Any) -> None:
        """Mark every tensor of ``tree`` (optimizer state: dataclasses and
        dicts) that sits under a parameter's name with that parameter's
        :class:`ShardInfo`."""
        if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
            for f in dataclasses.fields(tree):
                self.tag(getattr(tree, f.name))
        elif isinstance(tree, dict):
            for k, v in tree.items():
                if isinstance(v, torch.Tensor):
                    if k in self.infos:
                        v.shard_info = self.infos[k]
                else:
                    self.tag(v)



def _tensors(tree: Any) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def tensor_bytes(tree: Any) -> int:
    """The bytes that ``tree``'s tensors take on this rank."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def spec_bytes(tree: Any) -> int:
    """The bytes a rank's blocks of ``tree``'s tensors take by their specs
    alone (each marked leaf's whole shape over its shards)."""
    total = 0
    for t in _tensors(tree):
        info = getattr(t, "shard_info", None)
        total += (info.shard_numel() if info is not None else t.numel()) * t.element_size()
    return total


def shard_of(x: torch.Tensor, info: ShardInfo) -> torch.Tensor:
    """This rank's block of the whole leaf ``x``."""
    if tuple(x.shape) != info.shape:
        raise ValueError(f"a leaf of shape {tuple(x.shape)} where {info.shape} is sharded")
    return NamedSharding(info.mesh, info.spec).shard(x)


def whole(x: torch.Tensor, info: ShardInfo) -> torch.Tensor:
    """The whole leaf from every rank's block ``x`` (all-gathers over the
    axes of its spec; every rank of them must call it)."""
    for dim, axis in enumerate(info.spec):
        if axis is not None:
            x = all_gather(x.contiguous(), info.mesh, axis, dim)
    return x


def whole_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every sharded parameter whole (every
    rank of its mesh must call it)."""
    infos = {n: getattr(p, "shard_info", None) for n, p in model.named_parameters()}
    out = {}
    for name, t in model.state_dict().items():
        info = infos.get(name)
        out[name] = whole(t, info) if info is not None else t
    return out


def gathered(p: torch.Tensor, keep: Sequence[str] = (),
             reduce: Sequence[str] = ()) -> torch.Tensor:
    """``p`` as the module reads it: every sharded dimension whose logical
    name is not in ``keep`` all-gathered (see the module docstring).  The
    gradient of a gather is reduce-scattered over ``fsdp`` when the ranks
    hold their own rows of the batch (``mesh.batch_sharded()``) and over the
    axes in ``reduce`` (ranks that split the work otherwise); elsewhere each
    rank takes its block of the gradient it computed.  An unmarked ``p``
    comes back as it is."""
    info = getattr(p, "shard_info", None)
    if info is None:
        return p
    summed = set(reduce)
    if inputs_sharded():
        summed.update(TOKEN_AXES)
    x = p
    for dim, axis in enumerate(info.spec):
        if axis is None or info.logical[dim] in keep:
            continue
        x = gather(x, info.mesh, axis, dim, reduce=axis in summed)
    return x


def split_over(p: torch.Tensor, axis: str) -> Tuple[Optional[Mesh], int]:
    """(mesh, ranks) of ``axis`` when ``p`` is sharded over it, else
    (None, 1)."""
    info = getattr(p, "shard_info", None)
    if info is None or axis not in info.spec:
        return None, 1
    return info.mesh, info.mesh.shape[axis]


def reduce_gradients(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                     mesh: Mesh, *, average: bool = False) -> None:
    """Sum each gradient in place over the token axes (data, fsdp, seq) of
    ``mesh`` that its gather on use did not sum (a leaf sharded over fsdp
    was reduce-scattered there), one all-reduce a group of leaves with the
    same axes and dtype; with ``average``, divide by the token shards (the
    gradients of a mean over each rank's rows)."""
    groups: Dict[Tuple, list] = {}
    for name, g in grads.items():
        info = getattr(params[name], "shard_info", None)
        done = set(info.axes()) if info is not None else set()
        axes = tuple(a for a in TOKEN_AXES if mesh.shape.get(a, 1) > 1 and a not in done)
        groups.setdefault((axes, g.dtype), []).append(g)
    n_shards = mesh.axis_size(TOKEN_AXES)
    for (axes, _), gs in groups.items():
        if axes:
            flat = all_reduce(torch.cat([g.reshape(-1) for g in gs]), mesh, axes)
            for g, part in zip(gs, flat.split([g.numel() for g in gs])):
                g.copy_(part.view_as(g))
        if average and n_shards > 1:
            for g in gs:
                g.div_(n_shards)


def is_sharded(params: Dict[str, torch.Tensor]) -> bool:
    """True when some leaf lives on this rank as a block of itself."""
    return any(getattr(p, "shard_info", None) is not None and p.shard_info.axes()
               for p in params.values())


def sharded_global_norm(params: Dict[str, torch.Tensor],
                        grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The fp32 global L2 norm of gradients laid out as ``params``: each
    leaf's squares summed over its shards once.  A rank adds a leaf's
    squares where it is the first of the leaf's replicas (coordinate 0 on
    every axis the leaf is not sharded over), then one all-reduce over the
    whole mesh gives every rank the same norm (a NaN anywhere reaches
    all)."""
    mesh = next(p.shard_info.mesh for p in params.values()
                if getattr(p, "shard_info", None) is not None)
    coords = mesh.coords()
    names = list(grads)
    norms = torch._foreach_norm([grads[n].float() for n in names])
    weights = []
    for n in names:
        info = getattr(params[n], "shard_info", None)
        mine = set(info.axes()) if info is not None else set()
        weights.append(float(all(coords[a] == 0 for a in mesh.axis_names if a not in mine)))
    sq = torch.stack(norms).square()
    local = (sq * torch.tensor(weights, device=sq.device)).sum()
    return torch.sqrt(all_reduce(local, mesh, mesh.axis_names))
