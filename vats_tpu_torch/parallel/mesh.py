"""The rank mesh and the logical-axis rules.

Counterpart of ``vats_tpu/parallel/mesh.py``.  The JAX package lays its
devices on five named axes (``data, fsdp, expert, tensor, seq``) and lets
XLA place the collectives; here every rank is one process of a
``torch.distributed`` world and holds only its own shards, so the program
runs the collectives itself (``parallel/collectives.py``).

  * :func:`create_device_mesh` / :func:`create_mesh` lay the world's ranks
    on the five axes, with the JAX package's size rules (at most one -1,
    the product must match the rank count).  :class:`Mesh` makes the process
    group of each axis (or set of axes) at its first use, one group per
    coordinate of the other axes.  Every rank must ask for the same groups
    in the same order, as every rank of an SPMD program does.
  * ``with mesh:`` makes the mesh ambient (:func:`ambient_mesh`): model code
    routes attention through ring or Ulysses context parallelism only under
    a mesh whose ``seq`` axis is > 1.  Under ``with mesh:`` alone each rank
    holds whole inputs.  Under ``with mesh.batch_sharded():`` (what
    ``parallel/sharded.py``'s step enters) each rank holds its shard as
    :func:`batch_sharding` cuts it: its rows over ``data`` x ``fsdp`` and
    its tokens ``[r * tl, (r + 1) * tl)`` over ``seq``; the loss, the MoE
    router's statistics and capacity and the sequence positions are then
    made global.  Parameters sharded over ``fsdp``, ``tensor`` or
    ``expert`` carry their own mesh (``parallel/layout.py``).
  * The logical-axis rules and their resolution are the JAX package's,
    copied; :func:`logical_to_mesh_spec` returns a plain tuple where JAX
    returns a ``PartitionSpec``.  :func:`with_logical_constraint` is a no-op
    (nothing reshards an eager tensor).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# Physical mesh axis names, in priority order.
#   data:   pure data parallelism (batch)
#   fsdp:   fully-sharded data parallelism (batch + param/optimizer sharding)
#   expert: MoE expert parallelism (all_to_all token dispatch)
#   tensor: tensor parallelism (attention heads / FFN hidden dim)
#   seq:    sequence/context parallelism (ring attention)
MESH_AXES: Tuple[str, ...] = ("data", "fsdp", "expert", "tensor", "seq")

# Logical axis name -> candidate mesh axes (first available wins).
DEFAULT_LOGICAL_AXIS_RULES: Tuple[Tuple[str, Optional[Sequence[str]]], ...] = (
    ("batch", ("data", "fsdp")),
    ("activation_batch", ("data", "fsdp")),
    ("activation_seq", "seq"),
    ("activation_embed", "tensor"),
    ("activation_heads", "tensor"),
    ("activation_kv", None),
    ("embed", "fsdp"),
    ("vocab", "tensor"),
    ("heads", "tensor"),
    ("kv_heads", "tensor"),
    ("head_dim", None),
    ("mlp", "tensor"),
    ("experts", "expert"),
    ("expert_mlp", "tensor"),
    ("conv_in", None),
    ("conv_out", "tensor"),
    ("norm", None),
)

#: the axes a token's batch row and position are sharded over: the loss, the
#: router's statistics and the gradients are summed over these
TOKEN_AXES: Tuple[str, ...] = ("data", "fsdp", "seq")


def logical_axis_rules(
    overrides: Optional[Sequence[Tuple[str, Optional[Sequence[str]]]]] = None,
) -> Tuple[Tuple[str, Optional[Sequence[str]]], ...]:
    """Return logical->mesh axis rules, with optional per-call overrides."""
    if not overrides:
        return DEFAULT_LOGICAL_AXIS_RULES
    merged = dict(DEFAULT_LOGICAL_AXIS_RULES)
    merged.update(dict(overrides))
    return tuple(merged.items())


def _world() -> Tuple[int, int]:
    """(world size, this rank): (1, 0) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def create_device_mesh(
    *,
    data: int = 1,
    fsdp: int = -1,
    expert: int = 1,
    tensor: int = 1,
    seq: int = 1,
    devices: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """An ndarray of ranks shaped for :data:`MESH_AXES` (``devices``: the
    ranks to lay out, the whole world by default).

    Exactly one axis may be -1 (absorbs all remaining ranks)."""
    devices = list(devices if devices is not None else range(_world()[0]))
    sizes = [data, fsdp, expert, tensor, seq]
    n_unknown = sum(1 for s in sizes if s == -1)
    if n_unknown > 1:
        raise ValueError(f"At most one mesh axis may be -1, got sizes {sizes}")
    known = math.prod(s for s in sizes if s != -1)
    if n_unknown == 1:
        if len(devices) % known != 0:
            raise ValueError(
                f"Device count {len(devices)} not divisible by fixed mesh "
                f"axes product {known}"
            )
        sizes = [len(devices) // known if s == -1 else s for s in sizes]
    elif known != len(devices):
        raise ValueError(
            f"Mesh sizes {sizes} (product {known}) != device count {len(devices)}"
        )
    return np.array(devices).reshape(sizes)


# Process-wide, not per thread: on the card the autograd engine runs the
# backward, and the forwards that activation checkpointing recomputes in it,
# on a thread of its own, which must see the mesh its forward ran under.
_AMBIENT: List[Tuple["Mesh", bool]] = []  # (mesh, inputs sharded), innermost last


class Mesh:
    """Ranks laid on named axes, with a process group per axis set.

    ``devices`` is the ndarray of ranks; ``shape`` maps each axis name to
    its size, as a JAX mesh's does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str] = MESH_AXES):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d rank array for axes {self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, self.devices.shape))
        self._groups: Dict[Tuple[str, ...], Tuple[object, List[int]]] = {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def axis_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape.get(a, 1) for a in axes)

    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on every axis."""
        rank = _world()[1]
        where = np.argwhere(self.devices == rank)
        if len(where) != 1:
            raise RuntimeError(f"rank {rank} is not in {self}")
        return dict(zip(self.axis_names, (int(c) for c in where[0])))

    def axis_index(self, axis: str) -> int:
        return self.coords()[axis]

    def shard_index(self, axes: Sequence[str]) -> int:
        """This rank's index along ``axes`` taken together, the first axis
        major (the order JAX shards one dimension over several axes)."""
        c = self.coords()
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + c[a]
        return idx

    def group(self, axes: Sequence[str]):
        """(process group, member ranks in shard order) of the ranks that
        share this rank's coordinates off ``axes``; the group is None where
        they are this rank alone.  The groups of every coordinate are made
        together at the first call (``new_group`` is collective over the
        world)."""
        axes = tuple(axes)
        if axes not in self._groups:
            rest = [a for a in self.axis_names if a not in axes]
            moved = np.moveaxis(
                self.devices,
                [self.axis_names.index(a) for a in rest + list(axes)],
                list(range(len(self.axis_names))),
            ).reshape(-1, self.axis_size(axes))
            rank = _world()[1]
            mine = None
            for members in moved.tolist():
                if len(members) > 1:
                    if not dist.is_initialized():
                        raise RuntimeError(
                            f"{self} spans {self.devices.size} ranks: initialize "
                            "torch.distributed first (parallel.multihost)")
                    pg = dist.new_group(members)
                else:
                    pg = None
                if rank in members:
                    mine = (pg, members)
            if mine is None:
                raise RuntimeError(f"rank {rank} is not in {self}")
            self._groups[axes] = mine
        return self._groups[axes]

    def __enter__(self) -> "Mesh":
        _AMBIENT.append((self, False))
        return self

    def __exit__(self, *exc) -> None:
        _AMBIENT.pop()

    @contextlib.contextmanager
    def batch_sharded(self) -> Iterator["Mesh"]:
        """The mesh made ambient, with each rank holding its shard of the
        inputs as :func:`batch_sharding` cuts them."""
        _AMBIENT.append((self, True))
        try:
            yield self
        finally:
            _AMBIENT.pop()


def create_mesh(
    *,
    data: int = 1,
    fsdp: int = -1,
    expert: int = 1,
    tensor: int = 1,
    seq: int = 1,
    devices: Optional[Sequence[int]] = None,
) -> Mesh:
    """Create the framework's standard 5-axis mesh over the world's ranks.

    Default: all ranks on the ``fsdp`` axis, as in the JAX package."""
    return Mesh(create_device_mesh(data=data, fsdp=fsdp, expert=expert,
                                   tensor=tensor, seq=seq, devices=devices))


def logical_to_mesh_spec(
    logical_axes: Sequence[Optional[str]],
    rules: Optional[Sequence[Tuple[str, Optional[Sequence[str]]]]] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple:
    """Resolve a tuple of logical axis names to a partition spec (a tuple:
    per dimension None, a mesh axis, or a tuple of mesh axes).

    A rule whose mesh axis does not exist in ``mesh`` (or has size 1) resolves
    to None (replicated) so code is portable across mesh shapes.
    """
    rules = rules or DEFAULT_LOGICAL_AXIS_RULES
    table = dict(rules)
    used: set = set()
    spec = []
    for name in logical_axes:
        if name is None:
            spec.append(None)
            continue
        target = table.get(name)
        if target is None:
            spec.append(None)
            continue
        if isinstance(target, str):
            target = (target,)
        chosen = []
        for axis in target:
            if axis in used:
                continue
            if mesh is not None and mesh.shape.get(axis, 1) == 1:
                continue
            chosen.append(axis)
            used.add(axis)
        if not chosen:
            spec.append(None)
        elif len(chosen) == 1:
            spec.append(chosen[0])
        else:
            spec.append(tuple(chosen))
    return tuple(spec)


def ambient_mesh() -> Optional[Mesh]:
    """The Mesh of the enclosing ``with mesh:`` context, or None."""
    return _AMBIENT[-1][0] if _AMBIENT else None


def inputs_sharded() -> bool:
    """True under ``with mesh.batch_sharded():`` (each rank holds its shard
    of the batch and of the sequence)."""
    return bool(_AMBIENT) and _AMBIENT[-1][1]


def sharded_mesh() -> Optional[Mesh]:
    """The ambient mesh under ``mesh.batch_sharded()`` when it spans more
    than one rank, else None."""
    mesh = ambient_mesh()
    if mesh is None or not inputs_sharded() or mesh.devices.size == 1:
        return None
    return mesh


def sharded_token_mesh() -> Optional[Mesh]:
    """The ambient mesh when the inputs are sharded over more than one rank
    of :data:`TOKEN_AXES` (the loss and the router's statistics are then
    sums over ranks), else None."""
    mesh = ambient_mesh()
    if mesh is None or not inputs_sharded() or mesh.axis_size(TOKEN_AXES) == 1:
        return None
    return mesh


def with_logical_constraint(x, logical_axes: Sequence[Optional[str]]):
    """No-op: an eager tensor is already laid out on its rank."""
    return x


class NamedSharding:
    """A partition spec over a mesh; :meth:`shard` cuts this rank's block
    out of a whole array."""

    def __init__(self, mesh: Mesh, spec: Tuple):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh}, {self.spec})"

    def shard(self, x):
        """This rank's block of ``x`` (a tensor or numpy array; numpy comes
        back as a tensor).  A dimension that its shards do not divide
        raises, as a JAX sharding of it does."""
        x = torch.as_tensor(x)
        for dim, axes in enumerate(self.spec[: x.dim()]):
            if axes is None:
                continue
            axes = (axes,) if isinstance(axes, str) else tuple(axes)
            n = self.mesh.axis_size(axes)
            if x.shape[dim] % n != 0:
                raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not "
                                 f"divide over {axes} ({n} shards)")
            size = x.shape[dim] // n
            x = x.narrow(dim, self.mesh.shard_index(axes) * size, size)
        return x


def named_sharding(mesh: Mesh, *logical_axes: Optional[str]) -> NamedSharding:
    """NamedSharding for data arrays, resolved via the default rules."""
    return NamedSharding(mesh, logical_to_mesh_spec(logical_axes, mesh=mesh))
