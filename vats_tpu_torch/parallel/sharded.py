"""Sharded train-step construction over a rank mesh.

Counterpart of ``vats_tpu/parallel/sharded.py`` for meshes whose ``fsdp``,
``expert`` and ``tensor`` axes are 1: data and sequence (context)
parallelism.  Parameters and optimizer state are replicated on every rank;
each rank takes its rows of the batch over ``data`` and its tokens over
``seq`` (:func:`batch_sharding`), runs forward and backward under
``with mesh.batch_sharded():`` (attention through ring or Ulysses, global
positions, the loss and the router's statistics summed over the ranks),
and all-reduces the gradients over data x seq before the clip and the
optimizer, so every rank applies the same update.  FSDP, tensor and expert
sharding are not ported yet (ROADMAP item 19) and raise.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from vats_tpu_torch.parallel.collectives import all_reduce
from vats_tpu_torch.parallel.mesh import TOKEN_AXES, Mesh, NamedSharding, named_sharding


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Rows over data+fsdp, the sequence over seq."""
    return named_sharding(mesh, "batch", "activation_seq")


def choose_mesh_shape(
    n_devices: int, *, context_parallel: bool = False
) -> Dict[str, int]:
    """A sensible default factorization of n devices over the 5 mesh axes,
    exercising dp/fsdp/ep/tp when enough devices exist.  With
    ``context_parallel`` the ``seq`` axis gets 2 shards (for models routing
    attention through ring/Ulysses, configs' ``context_parallel`` field)."""
    if context_parallel:
        if n_devices >= 8 and n_devices % 8 == 0:
            return dict(
                data=n_devices // 8, fsdp=2, expert=1, tensor=2, seq=2
            )
        if n_devices == 4:
            return dict(data=1, fsdp=2, expert=1, tensor=1, seq=2)
        if n_devices == 2:
            return dict(data=1, fsdp=1, expert=1, tensor=1, seq=2)
        raise ValueError(
            f"context-parallel mesh needs an even device count, got {n_devices}"
        )
    if n_devices >= 8 and n_devices % 8 == 0:
        return dict(
            data=n_devices // 8, fsdp=2, expert=2, tensor=2, seq=1
        )
    if n_devices == 4:
        return dict(data=1, fsdp=2, expert=1, tensor=2, seq=1)
    if n_devices == 2:
        return dict(data=1, fsdp=2, expert=1, tensor=1, seq=1)
    return dict(data=1, fsdp=n_devices, expert=1, tensor=1, seq=1)


def _check_replicated(model, mesh: Mesh) -> None:
    """Raise unless every rank holds the same parameters (one fp64 checksum
    pair per rank, compared by a max and a min over the world)."""
    params = list(model.parameters())
    sums = torch.zeros(2, dtype=torch.float64, device=params[0].device)
    for i, p in enumerate(params):
        s = p.detach().double().sum()
        sums += torch.stack([s, s * (i + 1) ** 0.5])
    axes = mesh.axis_names
    hi = all_reduce(sums, mesh, axes, op=torch.distributed.ReduceOp.MAX)
    lo = all_reduce(sums, mesh, axes, op=torch.distributed.ReduceOp.MIN)
    if not torch.equal(hi, lo):
        raise ValueError("make_sharded_train: the ranks hold different parameters; "
                         "build the model from one seed (or load one state) on each")


def make_sharded_train(
    model,
    training_args,
    mesh: Mesh,
    sample_batch: Dict[str, Any],
    *,
    num_training_steps: int = 1000,
    train_step_fn: Optional[Callable] = None,
    tx=None,
) -> Tuple[Callable, Callable, NamedSharding]:
    """Build (sharded_init, sharded_train_step, batch sharding).

    sharded_init() -> TrainState over ``model``'s parameters, after checking
    that every rank holds the same ones (the model is built from one seed,
    or loaded from one state, on every rank).
    sharded_train_step(state, batch, rng) -> (state, metrics): ``batch`` is
    the whole batch (every rank passes the same arrays, tensors or numpy),
    ``rng`` the step's dropout seed; metrics are global.

    ``sample_batch`` fixes the shapes: the mesh's data x fsdp ranks must
    divide its rows and its seq ranks its sequence."""
    from vats_tpu_torch.train.loop import make_train_step_fn
    from vats_tpu_torch.train.optimizer import create_optimizer
    from vats_tpu_torch.train.state import create_train_state

    for axis in ("fsdp", "expert", "tensor"):
        if mesh.shape.get(axis, 1) > 1:
            raise NotImplementedError(
                f"make_sharded_train: a mesh with {axis} > 1 (FSDP, tensor and expert "
                "sharding, ROADMAP item 19's remainder) is not ported yet")
    sharding = batch_sharding(mesh)
    for key, x in sample_batch.items():
        sharding.shard(x)  # raises where the mesh does not divide the batch
    if tx is None:
        tx = create_optimizer(training_args, num_training_steps)
    raw_step = train_step_fn or make_train_step_fn(model, training_args)
    device = next(model.parameters()).device
    n_shards = mesh.axis_size(TOKEN_AXES)

    def init():
        _check_replicated(model, mesh)
        return create_train_state(model, tx)

    def step(state, batch, rng):
        local = {k: sharding.shard(v).to(device) for k, v in batch.items()}
        # a dropout seed of its own for each shard of the batch
        seed = (int(rng) * n_shards + mesh.shard_index(TOKEN_AXES)) % (1 << 62)
        with mesh.batch_sharded():
            return raw_step(state, local, seed)

    return init, step, sharding
