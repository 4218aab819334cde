"""K8: the AdamW update and the gradient accumulation step over every leaf
of a model in one pass (``csrc/adamw.cu``).

``train/optimizer.py``'s AdamW and MultiSteps hand their leaves here as
lists, in one order:

  * :func:`adamw_update_`: optax's adamw update of every leaf in place
    (params, first and second moments), from the step's coefficients
    (:class:`Coeffs`, 0-d fp32 device tensors made by the optimizer), the
    clip's ``scale`` and the skip's ``finite`` flag where given; with
    ``reset_grads`` it also leaves every gradient as ``g * 0`` (MultiSteps'
    accumulator, reset after the boundary's update).
  * :func:`accumulate_`: MultiSteps' running mean of the gradients,
    ``acc += (g - acc) / count``.

Each launches K8 once when every tensor it is given is a CUDA tensor, and
runs its plain per-leaf version (:func:`adamw_update_ref`,
:func:`accumulate_ref`) when every tensor is on the CPU; tensors on more
than one device raise.  K8 computes the plain version's operations in its
order with its roundings, so on the card the two are bit-equal (the card
tests hold them so).  Both take params (and their grads and second moments)
in fp32 or bf16, first moments in fp32 or bf16, all contiguous, and raise
on any other, so a CPU run refuses what the card would.  Each returns the
number of leaves K8 took (all or none), which the optimizer keeps as its
``leaves_fused`` tally.

K8 reads its leaves from a device table (:class:`LeafTables`) built once
for a set of tensors, keyed on their ``data_ptr``s; the build copies from
the host, so it has to happen outside a CUDA graph capture (a train step's
eager warm-up builds it; a capture without one raises).
``adamw_update_.launches`` and ``accumulate_.launches`` count K8's
launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from vats_tpu_torch.ops import kernels

#: elements a chunk of K8's walk (``CHUNK`` in csrc/adamw.cu)
CHUNK = 8192
#: int64 words of a leaf's table row (``ROW`` in csrc/adamw.cu)
ROW = 8
#: kind bits of a table row: param dtype bf16, mu bf16, every pointer
#: 16-byte aligned
T_BF16, M_BF16, ALIGNED = 1, 2, 4
_DTYPES = (torch.float32, torch.bfloat16)


class Coeffs(NamedTuple):
    """An update's coefficients, 0-d fp32 tensors on the leaves' device:
    the bias corrections ``1 - b^n``, the moments' decays and gains (1 and 0
    on a skipped step) and the negated learning rate (0 when skipped)."""

    bc1: torch.Tensor
    bc2: torch.Tensor
    d1: torch.Tensor
    c1: torch.Tensor
    d2: torch.Tensor
    c2: torch.Tensor
    neg_lr: torch.Tensor


# --- plain versions ---------------------------------------------------------

def adamw_update_ref(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                     mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor], k: Coeffs,
                     eps: float, weight_decay: float, scale: Optional[torch.Tensor] = None,
                     finite: Optional[torch.Tensor] = None, reset_grads: bool = False) -> None:
    """optax's adamw, leaf by leaf, operation for operation:

      g   = where(finite, g * scale, 0)
      mu  = d1 * mu + c1 * g                  (fp32; d1 * mu in mu's dtype)
      nu  = d2 * nu + c2 * g * g
      u   = (mu / bc1) / (sqrt(nu / bc2) + eps) + wd * p
      p  += neg_lr * u

    and with ``reset_grads`` then ``g *= 0`` (optax's ``(1 - emit) * acc``)."""
    for p, grad, mu, nu in zip(params, grads, mus, nus):
        g = grad.to(p.dtype)
        if scale is not None:
            g = g * scale.to(g.dtype)
        if finite is not None:
            g = torch.where(finite, g, torch.zeros((), dtype=g.dtype, device=g.device))
        mu32 = (mu * k.d1.to(mu.dtype)).float() + k.c1 * g
        nu.mul_(k.d2).add_(k.c2 * (g * g))
        u = (mu32 / k.bc1) / (torch.sqrt(nu / k.bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p
        p.add_(u * k.neg_lr)
        mu.copy_(mu32)
        if reset_grads:
            grad.mul_(0)


def accumulate_ref(accs: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                   count: int) -> None:
    """acc += (g - acc) / count, leaf by leaf: the mean of ``count``
    gradients from that of the first ``count - 1``."""
    for acc, g in zip(accs, grads):
        acc.add_((g.to(acc.dtype) - acc) / count)


# --- the leaf table -----------------------------------------------------------

def chunk_starts(numels: Sequence[int]) -> Tuple[List[int], int]:
    """Each leaf's first chunk of K8's walk (chunks of CHUNK elements, leaf
    after leaf; an empty leaf has none), and the chunks of all leaves."""
    chunk0, c = [], 0
    for n in numels:
        chunk0.append(c)
        c += -(-int(n) // CHUNK)
    return chunk0, c


class LeafTables:
    """K8's device tables for the sets of leaves one optimizer updates,
    keyed on the leaves' ``data_ptr``s, lengths and dtypes.  A table is
    built from the host, so only outside a capture.  One that a capture
    used is kept while this object lives (a replay of the graph reads it);
    of the others only the last is kept."""

    def __init__(self):
        self._tables: Dict[tuple, Tuple[torch.Tensor, int]] = {}
        self._captured: set = set()

    def get(self, leaves: List[Tuple[torch.Tensor, ...]], kinds: List[int]
            ) -> Tuple[torch.Tensor, int]:
        """(table [n, ROW] int64 on the leaves' device, chunks) for
        ``leaves`` (tuples of up to four tensors of one length)."""
        key = tuple((*(t.data_ptr() for t in leaf), leaf[0].numel(), kind)
                    for leaf, kind in zip(leaves, kinds))
        capturing = torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
        found = self._tables.get(key)
        if found is None:
            if capturing:
                raise RuntimeError(
                    "K8's leaf table for these tensors was not built before this CUDA "
                    "graph capture: run the update once eagerly first (a train step's "
                    "warm-up does)")
            chunk0, n_chunks = chunk_starts([leaf[0].numel() for leaf in leaves])
            rows = [[*(t.data_ptr() for t in leaf), *[0] * (4 - len(leaf)), leaf[0].numel(),
                     c0, kind, 0] for leaf, kind, c0 in zip(leaves, kinds, chunk0)]
            found = (torch.tensor(rows, dtype=torch.int64, device=leaves[0][0].device),
                     n_chunks)
            self._tables = {k: v for k, v in self._tables.items() if k in self._captured}
            self._tables[key] = found
        if capturing:
            self._captured.add(key)
        return found


# --- kernels ----------------------------------------------------------------

def _device(tensors: Sequence[torch.Tensor]) -> torch.device:
    """The one device every tensor lies on: the card (K8) or the CPU (the
    plain version)."""
    devs = {t.device for t in tensors}
    kernels.require(len(devs) == 1, "K8's leaves and coefficients must lie on one device, "
                                    f"not on {sorted(map(str, devs))}")
    dev = devs.pop()
    kernels.require(dev.type in ("cuda", "cpu"), f"K8's leaves lie on {dev}")
    return dev


def _check_leaf(i: int, p: torch.Tensor, others: Sequence[Tuple[str, torch.Tensor]]) -> None:
    """What K8 takes, held on either device: p in fp32 or bf16, contiguous
    tensors of p's shape."""
    kernels.require(p.dtype in _DTYPES, f"leaf {i}: K8 takes fp32 or bf16, got {p.dtype}")
    for name, t in (("param", p), *others):
        kernels.require(t.is_contiguous(), f"leaf {i}'s {name} must be contiguous")
        kernels.require(t.shape == p.shape, f"leaf {i}'s {name} has shape {tuple(t.shape)}, "
                                            f"not the param's {tuple(p.shape)}")


def _kind(leaf: Tuple[torch.Tensor, ...]) -> int:
    aligned = all(t.data_ptr() % 16 == 0 for t in leaf)
    return (T_BF16 if leaf[0].dtype == torch.bfloat16 else 0) | (ALIGNED if aligned else 0)


def _ptr(t: Optional[torch.Tensor], name: str, dtype: torch.dtype) -> ctypes.c_void_p:
    if t is None:
        return ctypes.c_void_p(None)
    kernels.check_cuda_tensor(t, name, dtype=dtype, shape=())
    return kernels.ptr(t)


def adamw_update_(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                  mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor], k: Coeffs,
                  eps: float, weight_decay: float, *, tables: LeafTables,
                  scale: Optional[torch.Tensor] = None, finite: Optional[torch.Tensor] = None,
                  reset_grads: bool = False) -> int:
    """The AdamW update of every leaf in place (:func:`adamw_update_ref`'s
    arithmetic); grads and second moments in their param's dtype, first
    moments in fp32 or bf16.  Returns the leaves K8 took."""
    if not params:
        return 0
    extra = [t for t in (scale, finite) if t is not None]
    dev = _device([*params, *grads, *mus, *nus, *k, *extra])
    leaves = list(zip(params, grads, mus, nus, strict=True))
    for i, (p, g, mu, nu) in enumerate(leaves):
        kernels.require(g.dtype == nu.dtype == p.dtype and mu.dtype in _DTYPES,
                        f"leaf {i}: grad {g.dtype} and nu {nu.dtype} must be the param's "
                        f"{p.dtype}, mu fp32 or bf16, got {mu.dtype}")
        _check_leaf(i, p, (("grad", g), ("mu", mu), ("nu", nu)))
    if dev.type == "cpu":
        adamw_update_ref(params, grads, mus, nus, k, eps, weight_decay, scale, finite,
                         reset_grads)
        return 0
    kinds = [_kind(leaf) | (M_BF16 if leaf[2].dtype == torch.bfloat16 else 0)
             for leaf in leaves]
    coef = [_ptr(t, f"coefficient {name}", torch.float32) for name, t in zip(Coeffs._fields, k)]
    table, n_chunks = tables.get(leaves, kinds)
    lib = _lib()
    rc = lib.vats_adamw_update(
        kernels.ptr(table), len(leaves), n_chunks, *coef, _ptr(scale, "scale", torch.float32),
        _ptr(finite, "finite", torch.bool), float(eps), float(weight_decay),
        int(bool(weight_decay)), int(reset_grads), kernels.stream_ptr(table))
    kernels.check(lib, rc, "adamw_update_")
    if n_chunks:
        kernels.count_launch(adamw_update_)
    return len(leaves)


adamw_update_.launches = 0


def accumulate_(accs: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], count: int, *,
                tables: LeafTables) -> int:
    """acc += (g - acc) / count for every leaf in place
    (:func:`accumulate_ref`'s arithmetic); grads in their accumulator's
    dtype.  Returns the leaves K8 took."""
    if not accs:
        return 0
    kernels.require(count >= 1, f"count {count}: the mean of at least one gradient")
    dev = _device([*accs, *grads])
    leaves = list(zip(accs, grads, strict=True))
    for i, (acc, g) in enumerate(leaves):
        kernels.require(g.dtype == acc.dtype,
                        f"leaf {i}: grad {g.dtype} must be the accumulator's {acc.dtype}")
        _check_leaf(i, acc, (("grad", g),))
    if dev.type == "cpu":
        accumulate_ref(accs, grads, count)
        return 0
    table, n_chunks = tables.get(leaves, [_kind(leaf) for leaf in leaves])
    lib = _lib()
    rc = lib.vats_accumulate(kernels.ptr(table), len(leaves), n_chunks, int(count),
                             kernels.stream_ptr(table))
    kernels.check(lib, rc, "accumulate_")
    if n_chunks:
        kernels.count_launch(accumulate_)
    return len(leaves)


accumulate_.launches = 0


def _lib() -> ctypes.CDLL:
    lib = kernels.load("adamw")
    if not getattr(lib, "_vats_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vats_adamw_update.argtypes = [vp, i, i] + [vp] * 9 + [f, f, i, i, vp]
        lib.vats_accumulate.argtypes = [vp, i, i, i, vp]
        for fn in (lib.vats_adamw_update, lib.vats_accumulate):
            fn.restype = ctypes.c_int
        lib._vats_typed = True
    return lib
