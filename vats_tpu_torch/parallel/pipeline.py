"""GPipe pipeline parallelism over a mesh axis.

Counterpart of ``vats_tpu/parallel/pipeline.py``.  Layer-stacked parameters
are split over S stages on their leading (layer) axis; the state flows from
stage to stage while M microbatches fill the pipe: M + S - 1 ticks, bubble
(S - 1) / (M + S - 1).  The stage axis is any axis of the mesh (the JAX
tests use ``seq``).  Where JAX runs the ticks in one ``shard_map`` and
discards a bubble tick's result with ``where``, each rank here runs them
in Python and knows at every tick whether it holds a microbatch, so a
stage computes only on its M active ticks and passes the state through on
the others (same values; its blocks run M times a call, not M + S - 1).

At every tick every rank shifts its state one stage forward
(:func:`~vats_tpu_torch.parallel.collectives.ppermute`, whose backward
shifts the gradient back), bubbles included, and one token threads the
shifts, so that each rank's backward runs all of them, latest first.  The
input, which every rank holds alike, enters through ``copy_to`` (its
gradient, which only stage 0's injections make, all-reduced); the last
stage's outputs leave through ``global_sum`` with zeros on the other ranks
(the gradient as it is): every rank returns the same outputs, computes the
same loss, and no gradient is counted S times.

  * :func:`pipeline_apply`: any ``block_fn(stage_params, state)`` over a
    pytree of state (each leaf [batch, ...], split into microbatches), with
    the JAX signature.
  * :func:`pipeline_text_lm_apply`: ``TextLM``'s blocks staged, the
    embedding, the final norm and the readout outside the pipe.
  * :func:`stage_model`: a ``TextLM`` cut to this rank's blocks, so that a
    rank holds only the weights its stage runs.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn
from torch.utils import _pytree as pytree

from vats_tpu_torch.parallel.collectives import (
    _block, _TieFn, copy_to, global_sum, ppermute)
from vats_tpu_torch.parallel.mesh import Mesh


def _microbatch_rows(leaves, m: int) -> int:
    if not leaves:
        raise ValueError("pipeline_apply needs at least one state leaf")
    batch = leaves[0].shape[0]
    for leaf in leaves:
        if leaf.shape[0] != batch:
            raise ValueError(
                f"all state leaves must share the batch axis: {leaf.shape[0]} != {batch}")
    if batch % m != 0:
        raise ValueError(f"batch {batch} not divisible by microbatches {m}")
    return batch // m


def _run_stage(stage_fn, params, state, spec):
    out, out_spec = pytree.tree_flatten(stage_fn(params, pytree.tree_unflatten(state, spec)))
    if out_spec != spec or any((a.shape, a.dtype) != (b.shape, b.dtype)
                               for a, b in zip(out, state)):
        raise ValueError("block_fn must return its state's structure, shapes and dtypes")
    return out


def _pipeline(stage_fn: Callable, local_params, x, mesh: Mesh, axis_name: str, m: int):
    """GPipe over ``axis_name`` with this rank's ``local_params``."""
    leaves, spec = pytree.tree_flatten(x)
    mb = _microbatch_rows(leaves, m)
    n, s = mesh.shape[axis_name], mesh.axis_index(axis_name)
    axes = (axis_name,)
    token = torch.zeros((), device=leaves[0].device, requires_grad=True)
    token, *inputs = _TieFn.apply(token, *[copy_to(a, mesh, axes) for a in leaves])
    state = [torch.zeros_like(a[:mb]) for a in inputs]
    emitted = []
    for t in range(m + n - 1):
        if s == 0 and t < m:  # stage 0 injects microbatch t
            state = [a[t * mb:(t + 1) * mb] for a in inputs]
        if 0 <= t - s < m:
            state = _run_stage(stage_fn, local_params, state, spec)
            if s == n - 1:  # the last stage emits microbatch t - (S - 1)
                emitted.append(state)
        state, token = ppermute(state, mesh, axis_name, 1, token=token)
    if s == n - 1:
        outputs = [torch.cat(parts) for parts in zip(*emitted)]
    else:
        outputs = [torch.zeros_like(a) for a in inputs]
    _, *out = _TieFn.apply(token, *[global_sum(o, mesh, axes) for o in outputs])
    return pytree.tree_unflatten(out, spec)


def pipeline_apply(
    block_fn: Callable,
    stacked_params,
    x,
    *,
    mesh: Mesh,
    axis_name: str,
    num_microbatches: int,
):
    """Run ``block_fn`` over pipeline stages.

    block_fn(stage_params, state) -> state applies ONE stage's layers; each
    rank gets its [L/S, ...] block of every leaf of ``stacked_params`` (a
    pytree of tensors stacked on a leading layer axis).  x: a pytree whose
    leaves are [M * mb, ...] batches (or a single tensor), alike on every
    rank, split into M microbatches along axis 0.  Returns the same pytree
    with every microbatch passed through all stages in order, on every
    rank: what applying the stages one after another gives."""
    n = mesh.shape[axis_name]
    p_leaves, p_spec = pytree.tree_flatten(stacked_params)
    for p in p_leaves:
        if p.shape[0] % n != 0:
            raise ValueError(f"a stacked leaf's {p.shape[0]} layers do not split over "
                             f"{n} stages")
    local = pytree.tree_unflatten([_block(p, mesh, axis_name, 0) for p in p_leaves], p_spec)
    return _pipeline(block_fn, local, x, mesh, axis_name, num_microbatches)


def _stage_range(num_layers: int, mesh: Mesh, axis_name: str) -> range:
    n = mesh.shape[axis_name]
    if num_layers % n != 0:
        raise ValueError(f"num_layers ({num_layers}) must divide into {n} stages")
    per = num_layers // n
    s = mesh.axis_index(axis_name)
    return range(s * per, (s + 1) * per)


def stage_model(model, mesh: Mesh, axis_name: str = "stage"):
    """Cut a whole ``TextLM`` to this rank's stage, in place: the blocks
    ``[s * L/S, (s + 1) * L/S)`` (renumbered from 0; ``model.stage_layers``
    holds their indices in the whole model), ``token_embed``, ``norm`` and
    ``lm_head`` whole.  Returns the model."""
    want = _stage_range(model.cfg.num_layers, mesh, axis_name)
    if len(model.layers) != model.cfg.num_layers:
        raise ValueError(f"stage_model needs the whole model's {model.cfg.num_layers} "
                         f"blocks, got {len(model.layers)}")
    model.layers = nn.ModuleList(list(model.layers)[want.start:want.stop])
    model.stage_layers = want
    return model


def _stage_blocks(model, mesh: Mesh, axis_name: str):
    want = _stage_range(model.cfg.num_layers, mesh, axis_name)
    held = getattr(model, "stage_layers", range(len(model.layers)))
    if held == want:
        return list(model.layers)
    if held == range(model.cfg.num_layers):
        return list(model.layers)[want.start:want.stop]
    raise ValueError(f"the model holds blocks {held.start}..{held.stop - 1}, this rank's "
                     f"stage runs {want.start}..{want.stop - 1}")


def pipeline_text_lm_apply(
    model,
    input_ids: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
    *,
    mesh: Mesh,
    axis_name: str = "stage",
    num_microbatches: int,
):
    """TextLM forward with the block stack staged across ``axis_name``.

    ``model`` is the whole ``TextLM`` (each rank runs its stage's blocks of
    it) or this rank's :func:`stage_model`.  num_layers must divide into
    the stage count.  The embedding, the final norm and the readout run
    outside the pipe; the blocks run deterministically, without remat.
    Returns (logits [B, T, V] fp32, aux_loss scalar): the numbers of
    ``model(..., deterministic=True)``, with the MoE's capacity and aux
    taken per microbatch."""
    blocks = _stage_blocks(model, mesh, axis_name)
    x = model.embed(input_ids)
    b = input_ids.shape[0]
    state = {
        "x": x,
        # per-example aux shares: summed at the end = sum of block auxes
        "aux": torch.zeros((b,), dtype=torch.float32, device=x.device),
    }
    if padding_mask is not None:
        state["mask"] = padding_mask.to(torch.int8)
    mb = b // num_microbatches

    def stage_fn(stage_blocks, st):
        mask = st["mask"].bool() if "mask" in st else None
        h, aux = st["x"], st["aux"]
        for blk in stage_blocks:
            h, _, a = blk(h, mask, deterministic=True)
            aux = aux + a.float() / mb
        out = {"x": h, "aux": aux}
        if "mask" in st:
            out["mask"] = st["mask"]
        return out

    out = _pipeline(stage_fn, blocks, state, mesh, axis_name, num_microbatches)
    return model.unembed(model.norm(out["x"])), out["aux"].sum()
