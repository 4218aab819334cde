"""Sharded train-step construction over a rank mesh.

Counterpart of ``vats_tpu/parallel/sharded.py``.  Where JAX jits the step
with a ``NamedSharding`` a leaf and lets GSPMD place the collectives, each
rank here holds only its own shards and runs the collectives itself, so the
sharded step computes the single-process step's function:

  * parameters and optimizer state: each leaf as the block that its logical
    axes and the rules give it (``parallel/layout.py``; :func:`tree_shardings`
    lists them) -- ``embed`` over ``fsdp``, ``heads`` / ``kv_heads`` /
    ``mlp`` / ``expert_mlp`` / ``vocab`` / ``conv_out`` over ``tensor``,
    ``experts`` over ``expert``; the rest replicated;
  * the batch: each rank takes its rows over data x fsdp and its tokens
    over seq (:func:`batch_sharding`); the ``expert`` and ``tensor`` ranks
    of a row block hold the same rows;
  * the forward and backward run under ``with mesh.batch_sharded():`` --
    an fsdp-sharded weight all-gathered where it is used and its gradient
    reduce-scattered, attention and SwiGLU on this rank's heads and hidden
    units (tensor parallelism), the MoE's tokens exchanged with their
    experts' ranks by all_to_all over ``expert`` with the global capacity
    (``nn/moe.py``), ring or Ulysses attention over ``seq``, the loss and the
    router's statistics global;
  * each gradient is then summed over the token axes its gather did not sum,
    the global norm counts each leaf once, and AdamW updates every shard in
    place, so every rank applies its block of the single-process update.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from vats_tpu_torch.parallel.collectives import all_reduce
from vats_tpu_torch.parallel.layout import ParamLayout, reduce_gradients
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


def _sharding_tree(tree, shardings: Dict[str, NamedSharding], replicated: NamedSharding):
    if isinstance(tree, torch.Tensor):
        return replicated
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _sharding_tree(getattr(tree, f.name), shardings, replicated)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: shardings[k] if k in shardings and isinstance(v, torch.Tensor)
                else _sharding_tree(v, shardings, replicated) for k, v in tree.items()}
    return None


def tree_shardings(model, mesh: Mesh, rules=None, tx=None) -> Dict[str, Any]:
    """One ``NamedSharding`` a leaf of the train state over ``model`` (the
    JAX package's ``tree_shardings`` of the state): ``params`` by name, and
    with ``tx`` its ``opt_state`` (a moment takes its parameter's
    sharding, a counter is replicated), then the step counters."""
    layout = ParamLayout(model, mesh, rules)
    shardings = layout.shardings()
    replicated = NamedSharding(mesh, ())
    out = {"params": shardings}
    if tx is not None:
        shapes = {n: torch.empty(i.shape, device="meta") for n, i in layout.infos.items()}
        out["opt_state"] = _sharding_tree(tx.init(shapes), shardings, replicated)
    out.update(step=replicated, tokens_seen=replicated, skipped_steps=replicated)
    return out


class _AveragedGradients:
    """A caller's optimizer seen through a sharded step: the gradients of a
    mean over each rank's rows are summed over the token axes and divided
    by their shards first (``layout.reduce_gradients``)."""

    def __init__(self, inner, mesh: Mesh):
        self.inner, self.mesh = inner, mesh

    def init(self, params):
        return self.inner.init(params)

    def update_(self, params, grads, state):
        reduce_gradients(params, grads, self.mesh, average=True)
        return self.inner.update_(params, grads, state)


def make_sharded_train(
    model,
    training_args,
    mesh: Mesh,
    sample_batch: Dict[str, Any],
    *,
    num_training_steps: int = 1000,
    rules=None,
    train_step_fn: Optional[Callable] = None,
    tx=None,
) -> Tuple[Callable, Callable, Dict[str, Any]]:
    """Build (sharded_init, sharded_train_step, state_shardings).

    sharded_init() -> TrainState laid out per the logical rules: after
    checking that every rank holds the same parameters (the model is built
    from one seed, or loaded from one state, on every rank), each rank keeps
    only its block of every parameter, and the optimizer state is made from
    those blocks.
    sharded_train_step(state, batch, rng) -> (state, metrics): ``batch`` is
    the whole batch (every rank passes the same arrays, tensors or numpy),
    ``rng`` the step's dropout seed; metrics are global.
    state_shardings: :func:`tree_shardings` of the state.

    ``sample_batch`` fixes the shapes: the mesh's data x fsdp ranks must
    divide its rows and its seq ranks its sequence.  A caller's
    ``train_step_fn(state, batch, rng)`` (a vision step, say) runs on this
    rank's shard of the batch and updates through ``state.apply_gradients``
    the gradients of its loss's mean over those rows: they are averaged over
    the shards before the optimizer reads them, and its floating scalar
    metrics are averaged too."""
    from vats_tpu_torch.train.loop import make_train_step_fn
    from vats_tpu_torch.train.optimizer import create_optimizer
    from vats_tpu_torch.train.state import create_train_state

    sharding = batch_sharding(mesh)
    for key, x in sample_batch.items():
        sharding.shard(x)  # raises where the mesh does not divide the batch
    if tx is None:
        tx = create_optimizer(training_args, num_training_steps)
    layout = ParamLayout(model, mesh, rules)  # raises where a rule does not divide
    state_shardings = tree_shardings(model, mesh, rules, tx)
    caller = train_step_fn is not None
    raw_step = train_step_fn or make_train_step_fn(model, training_args)
    device = next(model.parameters()).device
    n_shards = mesh.axis_size(TOKEN_AXES)

    def init():
        _check_replicated(model, mesh)
        layout.shard_(model)
        state = create_train_state(model, _AveragedGradients(tx, mesh) if caller else tx)
        layout.tag(state.opt_state)
        return state

    def step(state, batch, rng):
        local = {k: sharding.shard(v).to(device) for k, v in batch.items()}
        # a dropout seed of its own for each shard of the batch
        seed = (int(rng) * n_shards + mesh.shard_index(TOKEN_AXES)) % (1 << 62)
        with mesh.batch_sharded():
            state, metrics = raw_step(state, local, seed)
        if caller and n_shards > 1:
            metrics = {k: all_reduce(v, mesh, TOKEN_AXES) / n_shards
                       if torch.is_tensor(v) and v.dim() == 0 and v.is_floating_point()
                       else v for k, v in metrics.items()}
        return state, metrics

    return init, step, state_shardings
