"""The collectives that ring and Ulysses attention and the sharded step run.

Counterparts of the JAX package's in-``shard_map`` collectives, over the
process groups of a :class:`~vats_tpu_torch.parallel.mesh.Mesh`:

  * :func:`shift`: every rank sends to the rank ``distance`` ahead of it
    along an axis and receives from the one as far behind (``ppermute``
    with a ``(s, s + d)`` permutation), by ``batch_isend_irecv``; the
    tensors travel packed in one byte buffer; :func:`ppermute` is its
    autograd pair (the gradient shifted back);
  * :func:`all_to_all`: the tiled ``all_to_all`` (split one dimension over
    the axis, concatenate what arrives on another), differentiable;
  * :func:`all_gather`: the tiled ``all_gather`` along a dimension, and
    :func:`reduce_scatter`, its conjugate (each rank gets its block of the
    sum);
  * :func:`all_reduce` over a set of axes, and :func:`global_sum`, its
    differentiable form for a sum that every rank's loss reads alike.

The autograd pairs that sharding runs (Megatron's conjugates, and the
gather of a shard on use):

  * :func:`gather` (all_gather forward; backward reduce-scatter where the
    ranks along the axis computed different parts of the loss, ``reduce``,
    else this rank's block of the gradient, which every rank holds alike);
  * :func:`copy_to` (identity forward, all-reduce backward): where a tensor
    that every rank holds alike feeds work split over the axis;
  * :func:`global_sum` (all-reduce forward, identity backward): where the
    split work's partial sums join;
  * :func:`split` (this rank's block forward, all_gather backward): the
    expert ranks' share of the tokens that every one of them holds.

Backends are the caller's choice (``parallel/multihost.py``).  NCCL moves
CUDA tensors between GPUs and needs one GPU per rank.  gloo moves CPU
tensors only: on gloo a CUDA tensor is staged through a host buffer (copied
to the CPU, exchanged, copied back), which is what lets several ranks share
one GPU.  ``traffic`` counts the bytes each rank sends and splits the
seconds a rank spends in its collectives three ways: ``wait_s``, waiting for
the work already queued on the device before a tensor can leave it (the
compute that produced it, not communication); ``staging_s``, the copies to
and from host buffers alone; ``exchange_s``, the backend's own send,
receive or reduction, which includes waiting for the other ranks.
``traffic["by_axis"]`` splits the bytes by the axes of the group they went
over (keys like ``"fsdp"`` or ``"data+fsdp+seq"``).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: per-process totals: bytes sent by shift / all_to_all / all_gather /
#: all_reduce, calls, and seconds (see the module docstring)
traffic = {"bytes": 0, "calls": 0, "wait_s": 0.0, "staging_s": 0.0, "exchange_s": 0.0,
           "by_axis": {}}

_ALIGN = 256  # byte offset of each tensor in a packed buffer (TMA wants 16)


def reset_traffic() -> None:
    traffic.update(bytes=0, calls=0, wait_s=0.0, staging_s=0.0, exchange_s=0.0,
                   by_axis={})


def _staged(group, x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    # the copy to pageable memory would wait for every queued kernel: wait
    # apart, so staging_s times the copy alone
    t0 = time.perf_counter()
    torch.cuda.current_stream(x.device).synchronize()
    t1 = time.perf_counter()
    traffic["wait_s"] += t1 - t0
    y = x.cpu()
    traffic["staging_s"] += time.perf_counter() - t1
    return y


def _to_device(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    t0 = time.perf_counter()
    y = x.to(device)
    if y.is_cuda:
        torch.cuda.current_stream(device).synchronize()
    traffic["staging_s"] += time.perf_counter() - t0
    return y


def _count(nbytes: int, t0: float, axes: Sequence[str]) -> None:
    """Count one collective of ``nbytes`` sent over ``axes``, begun at ``t0``."""
    traffic["exchange_s"] += time.perf_counter() - t0
    traffic["bytes"] += int(nbytes)
    traffic["calls"] += 1
    key = "+".join(axes)
    traffic["by_axis"][key] = traffic["by_axis"].get(key, 0) + int(nbytes)


def _pack(tensors: Sequence[torch.Tensor]):
    """One uint8 buffer holding every tensor at a 256-byte aligned offset,
    and the offsets."""
    offsets, total = [], 0
    for x in tensors:
        offsets.append(total)
        total += -(-x.numel() * x.element_size() // _ALIGN) * _ALIGN
    buf = torch.empty(total, dtype=torch.uint8, device=tensors[0].device)
    for x, off in zip(tensors, offsets):
        n = x.numel() * x.element_size()
        buf[off:off + n].copy_(x.contiguous().reshape(-1).view(torch.uint8))
    return buf, offsets


def _unpack(buf: torch.Tensor, offsets, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out = []
    for x, off in zip(like, offsets):
        n = x.numel() * x.element_size()
        out.append(buf[off:off + n].view(x.dtype).view(x.shape))
    return out


def shift(tensors: Sequence[torch.Tensor], mesh, axis: str, distance: int = 1
          ) -> List[torch.Tensor]:
    """Each rank sends ``tensors`` to the rank ``distance`` ahead of it along
    ``axis`` (cyclically) and returns what the rank as far behind sent it:
    same shapes and dtypes, on the same device, in fresh memory."""
    group, members = mesh.group((axis,))
    n = len(members)
    d = distance % n
    if n == 1 or d == 0:
        return [x.clone() for x in tensors]
    c = members.index(dist.get_rank())
    dst, src = members[(c + d) % n], members[(c - d) % n]
    buf, offsets = _pack(tensors)
    dev = buf.device
    staged = _staged(group, buf)
    send = _to_host(buf) if staged else buf
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, group),
           dist.P2POp(dist.irecv, recv, src, group)]
    t0 = time.perf_counter()
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    _count(send.numel(), t0, (axis,))
    if staged:
        recv = _to_device(recv, dev)
    return _unpack(recv, offsets, tensors)


class _ShiftFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, token, mesh, axis, distance, *tensors):
        ctx.args = (mesh, axis, distance)
        ctx.floating = [x.is_floating_point() for x in tensors]
        out = shift(tensors, mesh, axis, distance)
        ctx.mark_non_differentiable(*[y for y, f in zip(out, ctx.floating) if not f])
        return (token.clone(), *out)

    @staticmethod
    def backward(ctx, g_token, *grads):
        mesh, axis, distance = ctx.args
        send = [g for g, f in zip(grads, ctx.floating) if f]
        back = iter(shift(send, mesh, axis, -distance) if send else ())
        return (g_token, None, None, None,
                *[next(back) if f else None for f in ctx.floating])


class _TieFn(torch.autograd.Function):
    """Identity on a token and tensors: the backward reaches all of them
    once it reaches any (integer tensors carry no gradient)."""

    @staticmethod
    def forward(ctx, token, *tensors):
        ctx.floating = [x.is_floating_point() for x in tensors]
        out = [x.view_as(x) for x in tensors]
        ctx.mark_non_differentiable(*[y for y, f in zip(out, ctx.floating) if not f])
        return (token.view_as(token), *out)

    @staticmethod
    def backward(ctx, g_token, *grads):
        return (g_token, *[g if f else None for g, f in zip(grads, ctx.floating)])


def ppermute(tensors: Sequence[torch.Tensor], mesh, axis: str, distance: int = 1,
             token: Optional[torch.Tensor] = None
             ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """:func:`shift` under autograd: the forward shifts ``tensors`` (any
    dtypes; integer ones carry no gradient) by ``distance`` along ``axis``,
    the backward shifts their gradients back by ``-distance``
    (``ppermute``'s transpose).  Returns (the shifted tensors, a token).

    Every rank must run the backward of every shift, in the same order.
    ``token`` (a 0-d floating tensor that requires grad; a fresh one when
    None) makes that hold whatever the tensors require: the shift is
    recorded on every rank, and passing the returned token to the next
    shift chains the two, so the backward runs the later one first on every
    rank."""
    if token is None:
        token = torch.zeros((), device=tensors[0].device, requires_grad=True)
    token, *out = _ShiftFn.apply(token, mesh, axis, distance, *tensors)
    return out, token


def _all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int, concat_dim: int
                ) -> torch.Tensor:
    group, members = mesh.group((axis,))
    n = len(members)
    if n == 1:
        return x
    if x.shape[split_dim] % n != 0:
        raise ValueError(f"all_to_all: dimension {split_dim} of size "
                         f"{x.shape[split_dim]} does not split over {n} ranks")
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    dev = send.device
    staged = _staged(group, send)
    if staged:
        send = _to_host(send)
    recv = torch.empty_like(send)
    t0 = time.perf_counter()
    dist.all_to_all_single(recv, send, group=group)
    _count(send.numel() * send.element_size() * (n - 1) // n, t0, (axis,))
    if staged:
        recv = _to_device(recv, dev)
    return torch.cat(list(recv.unbind(0)), dim=concat_dim)


class _AllToAllFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return _all_to_all(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return _all_to_all(g.contiguous(), mesh, axis, concat_dim, split_dim), None, None, None, None


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int, concat_dim: int
               ) -> torch.Tensor:
    """Tiled all_to_all along ``axis``: ``x`` split into as many chunks as
    the axis has ranks along ``split_dim``, chunk j sent to the j-th rank,
    the chunks received concatenated along ``concat_dim`` in rank order
    (``jax.lax.all_to_all(..., tiled=True)``).  Its gradient is the
    all_to_all back."""
    return _AllToAllFn.apply(x, mesh, axis, split_dim, concat_dim)


def all_gather(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    """Tiled all_gather along ``axis`` (one axis, or several in the mesh's
    order): every rank's ``x`` concatenated along ``dim`` in shard order.
    Not differentiable (see :func:`gather`)."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    group, members = mesh.group(axes)
    if members != sorted(members):  # the backend concatenates in rank order
        raise ValueError(f"all_gather over {axes}: give the axes in the mesh's order")
    if len(members) == 1:
        return x
    x = x.contiguous()
    dev = x.device
    staged = _staged(group, x)
    if staged:
        x = _to_host(x)
    parts = [torch.empty_like(x) for _ in members]
    t0 = time.perf_counter()
    dist.all_gather(parts, x, group=group)
    _count(x.numel() * x.element_size(), t0, axes)
    out = torch.cat(parts, dim=dim)
    return _to_device(out, dev) if staged else out


def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The sum of every rank's ``x`` along ``axis``, of which this rank gets
    its block along ``dim`` (``x``'s size there divided by the ranks), as
    :func:`all_gather` along ``dim`` would have laid it."""
    group, members = mesh.group((axis,))
    n = len(members)
    if n == 1:
        return x.clone()
    if x.shape[dim] % n != 0:
        raise ValueError(f"reduce_scatter: dimension {dim} of size {x.shape[dim]} does "
                         f"not split over {n} ranks")
    dev = x.device
    staged = _staged(group, x)
    if staged:
        x = _to_host(x)
    chunks = [c.contiguous() for c in x.chunk(n, dim)]
    out = torch.empty_like(chunks[0])
    t0 = time.perf_counter()
    dist.reduce_scatter(out, chunks, group=group)
    _count(x.numel() * x.element_size() * (n - 1) // n, t0, (axis,))
    return _to_device(out, dev) if staged else out


def _block(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = mesh.shape[axis]
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(axis) * size, size)


class _GatherFn(torch.autograd.Function):
    """:func:`all_gather` under autograd (see :func:`gather`)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, reduce):
        ctx.args = (mesh, axis, dim, reduce)
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, reduce = ctx.args
        if mesh.shape[axis] == 1:
            return g, None, None, None, None
        g = (reduce_scatter(g.contiguous(), mesh, axis, dim) if reduce
             else _block(g, mesh, axis, dim).contiguous())
        return g, None, None, None, None


def gather(x: torch.Tensor, mesh, axis: str, dim: int, reduce: bool = True) -> torch.Tensor:
    """Every rank's shard ``x`` concatenated along ``dim`` (an all_gather
    over ``axis``) under autograd.  With ``reduce`` the ranks' losses read
    the whole differently (each its own rows of the batch): a shard's
    gradient is the sum of every rank's gradient of its block, a
    reduce-scatter.  Without it every rank computed the same loss from the
    whole, so its gradient is already complete and a rank takes its
    block."""
    return _GatherFn.apply(x, mesh, axis, dim, reduce)


class _SplitFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _block(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return all_gather(g.contiguous(), mesh, axis, dim), None, None, None


def split(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of an ``x`` that every rank along
    ``axis`` holds alike, under autograd: the backward gathers the blocks'
    gradients, so every rank's ``x`` gets the whole gradient."""
    if mesh.shape[axis] == 1:
        return x
    if x.shape[dim] % mesh.shape[axis] != 0:
        raise ValueError(f"split: dimension {dim} of size {x.shape[dim]} does not split "
                         f"over {axis} ({mesh.shape[axis]} ranks)")
    return _SplitFn.apply(x, mesh, axis, dim)


class _CopyToFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return all_reduce(g.contiguous(), mesh, axes), None, None


def copy_to(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """``x`` as it is, under autograd, where every rank along ``axes`` holds
    it alike and feeds it to its own part of work split over them: the
    backward sums the parts' gradients (an all-reduce)."""
    if mesh.axis_size(axes) == 1:
        return x
    return _CopyToFn.apply(x, mesh, tuple(axes))


def all_reduce(x: torch.Tensor, mesh, axes: Sequence[str],
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the ranks that share this rank's coordinates off
    ``axes`` (a new tensor; ``x`` is left as it was)."""
    group, members = mesh.group(tuple(axes))
    if len(members) == 1:
        return x.clone()
    dev = x.device
    staged = _staged(group, x)
    y = _to_host(x) if staged else x.clone()
    if not y.is_contiguous():
        y = y.contiguous()
    t0 = time.perf_counter()
    dist.all_reduce(y, op=op, group=group)
    _count(y.numel() * y.element_size(), t0, axes)
    return _to_device(y, dev) if staged else y


class _GlobalSumFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def global_sum(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axes``, under autograd: every
    rank's loss reads the same sum, so the gradient of a rank's own term is
    the incoming gradient as it is (the conjugate of :func:`copy_to`)."""
    if mesh.axis_size(axes) == 1:
        return x
    return _GlobalSumFn.apply(x, mesh, tuple(axes))
