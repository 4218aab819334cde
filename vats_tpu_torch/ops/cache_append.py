"""K3: the dense-cache append, redesigned as the fused decode prologue.

Counterpart of ``vats_tpu/ops/cache_append.py`` (``_append_kernel`` behind
``append_token_inplace``) and of the chain that a decode step (T == 1) runs
between the QKV product and the attention of every layer: L2 QK-norm, 1-D
interleaved RoPE, the head-dim pad and the KV commit (XLA fuses that chain
under ``jit`` in the JAX package).  One kernel body, ``csrc/cache_append.cu``,
behind three wrappers:

  * :func:`append_token_inplace`: one token's K/V into the dense
    :class:`~vats_tpu_torch.nn.kv_cache.KVCache` (the JAX sequence-minor
    layout ``[L, B, G, hd_pad, S]``) at ``min(length, S-1)``, in place;
  * :func:`dense_decode_prologue`: QK-norm and RoPE of one token's q and k
    at position ``length``, k and v committed into the dense cache (column
    ``min(length, S-1)``, or ``length % S`` in a ring), q returned padded to
    ``hd_pad`` for the cached attention;
  * :func:`paged_decode_prologue`: the same norm and RoPE at each row's own
    ``lengths[b]``; q and k returned in the layout K1/K4 take, which commit
    them (``ops/decode_attention.py``).

On CUDA tensors each wrapper launches the kernel once and counts it; it
reads ``length`` / ``lengths`` on the device (no host sync), so a CUDA graph
captures it.  On CPU tensors each runs its plain version: the unfused chain
(:func:`~vats_tpu_torch.nn.norms.l2_normalize`,
:func:`~vats_tpu_torch.nn.rope.apply_rope_1d`, the pad and
:func:`append_token_ref`), op for op.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from vats_tpu_torch.nn.norms import l2_normalize
from vats_tpu_torch.nn.rope import apply_rope_1d
from vats_tpu_torch.ops import kernels

# kernel modes (csrc/cache_append.cu)
_APPEND, _DENSE, _RING, _PAGED = 0, 1, 2, 3


def append_token_ref(
    k: torch.Tensor,
    v: torch.Tensor,
    layer_idx: int,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    length: torch.Tensor,
) -> None:
    """Plain version: the same in-place write with PyTorch indexing."""
    s = k.shape[-1]
    pos = torch.clamp(length.reshape(1).long(), 0, s - 1)
    k[layer_idx].index_copy_(-1, pos, k_new.to(k.dtype)[..., None])
    v[layer_idx].index_copy_(-1, pos, v_new.to(v.dtype)[..., None])


def append_token_inplace(
    k: torch.Tensor,
    v: torch.Tensor,
    layer_idx: int,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    length: torch.Tensor,
) -> None:
    """Write one token's K/V at position ``length`` (clamped to S-1) of
    layer ``layer_idx``, in place.

    k, v: [L, B, G, hd_pad, S]; k_new, v_new: [B, G, hd_pad]; length: int32
    scalar tensor (the caller folds a ring cache's modulo into it)."""
    if not k.is_cuda:
        append_token_ref(k, v, layer_idx, k_new, v_new, length)
        return
    l, b, g, d, s = k.shape
    _check_cache(k, v, layer_idx)
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        kernels.check_cuda_tensor(t, name, dtype=k.dtype, shape=(b, g, d))
        kernels.require(t.data_ptr() % (2 * t.element_size()) == 0,
                        f"{name} must be aligned to a pair of elements")
    _check_length(length, ())
    _launch(k_new, k_new, v_new, length, None, None, k, v, _APPEND, False, layer_idx,
            hq=0, g=g, hd=d)
    kernels.count_launch(append_token_inplace)


def rope_qk_ref(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, *,
                theta: float, qk_norm: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain prologue of q and k [B, T, H, hd]: L2 QK-norm (when
    ``qk_norm``), then 1-D RoPE at ``positions`` ([T] or [B, T])."""
    if qk_norm:
        q = l2_normalize(q)
        k = l2_normalize(k)
    return apply_rope_1d(q, positions, theta), apply_rope_1d(k, positions, theta)


def _pad_to(x: torch.Tensor, d: int) -> torch.Tensor:
    return x if x.shape[-1] == d else F.pad(x, (0, d - x.shape[-1]))


def dense_decode_prologue_ref(q, k, v, cache_k, cache_v, length, layer_idx, *,
                              theta: float, qk_norm: bool, ring: bool) -> torch.Tensor:
    """Plain version of :func:`dense_decode_prologue`: the unfused chain."""
    positions = length + torch.arange(q.shape[1], device=q.device)
    q, k = rope_qk_ref(q, k, positions, theta=theta, qk_norm=qk_norm)
    s, hdp = cache_k.shape[-1], cache_k.shape[3]
    k_new = _pad_to(k, hdp).to(cache_k.dtype)
    v_new = _pad_to(v, hdp).to(cache_v.dtype)
    write_pos = torch.remainder(length, s) if ring else length
    append_token_ref(cache_k, cache_v, layer_idx, k_new[:, 0], v_new[:, 0], write_pos)
    return _pad_to(q, hdp)


def dense_decode_prologue(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    length: torch.Tensor,
    layer_idx: int,
    inv_freq: torch.Tensor,
    *,
    theta: float,
    qk_norm: bool,
    ring: bool,
) -> torch.Tensor:
    """One decode token of one layer over the dense cache, in one launch:
    q, k L2-normalised (``qk_norm``) and rotated at position ``length``;
    k, v written zero-padded into column ``min(length, S-1)`` (``length %
    S`` when ``ring``) of layer ``layer_idx``, in place.  Returns q
    zero-padded to hd_pad, [B, 1, Hq, hd_pad].

    q [B, 1, Hq, hd], k, v [B, 1, G, hd] (views of the projection are
    fine: each head contiguous); cache_k, cache_v [L, B, G, hd_pad, S];
    length an int32 scalar tensor; inv_freq the fp32 ``rope_inv_freq(hd,
    theta)`` of q's device (``theta`` is what the plain version reads)."""
    if not q.is_cuda:
        return dense_decode_prologue_ref(q, k, v, cache_k, cache_v, length, layer_idx,
                                         theta=theta, qk_norm=qk_norm, ring=ring)
    b, _, hq, hd = q.shape
    g, d = cache_k.shape[2], cache_k.shape[3]
    _check_cache(cache_k, cache_v, layer_idx)
    _check_sources(q, k, v, cache_k.dtype, inv_freq)
    kernels.require(cache_k.shape[1] == b and k.shape[2] == g and hd <= d,
                    f"cache {tuple(cache_k.shape)} does not hold q {tuple(q.shape)}")
    _check_length(length, ())
    q_out = torch.empty((b, 1, hq, d), dtype=q.dtype, device=q.device)
    _launch(q, k, v, length, inv_freq, q_out, cache_k, cache_v,
            _RING if ring else _DENSE, qk_norm, layer_idx, hq=hq, g=g, hd=hd)
    kernels.count_launch(dense_decode_prologue)
    return q_out


def paged_decode_prologue_ref(q, k, v, lengths, *, theta: float, qk_norm: bool):
    """Plain version of :func:`paged_decode_prologue`: the unfused chain."""
    positions = lengths[:, None] + torch.arange(q.shape[1], device=q.device)[None, :]
    q, k = rope_qk_ref(q, k, positions, theta=theta, qk_norm=qk_norm)
    return q[:, 0], k[:, 0], v[:, 0]


def paged_decode_prologue(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    inv_freq: torch.Tensor,
    *,
    theta: float,
    qk_norm: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode token of one layer over the paged cache, in one launch:
    q, k L2-normalised (``qk_norm``) and rotated at each row's position
    ``lengths[b]``.  Returns (q [B, Hq, hd], k [B, G, hd], v [B, G, hd]),
    what ``paged_decode_attention_commit`` takes (q and k are views of one
    buffer, v a view of the input); nothing is committed here.

    q [B, 1, Hq, hd], k, v [B, 1, G, hd]; lengths int32 [B]; inv_freq as in
    :func:`dense_decode_prologue`."""
    if not q.is_cuda:
        return paged_decode_prologue_ref(q, k, v, lengths, theta=theta, qk_norm=qk_norm)
    b, _, hq, hd = q.shape
    g = k.shape[2]
    _check_sources(q, k, v, q.dtype, inv_freq)
    _check_length(lengths, (b,))
    out = torch.empty((b, hq + g, hd), dtype=q.dtype, device=q.device)
    _launch(q, k, v, lengths, inv_freq, out, None, None, _PAGED, qk_norm, 0,
            hq=hq, g=g, hd=hd)
    kernels.count_launch(paged_decode_prologue)
    return out[:, :hq], out[:, hq:], v[:, 0]


append_token_inplace.launches = 0
dense_decode_prologue.launches = 0
paged_decode_prologue.launches = 0

_ENTRY = {
    torch.bfloat16: "vats_decode_prologue_bf16",
    torch.float32: "vats_decode_prologue_f32",
}


def _check_cache(k, v, layer_idx):
    kernels.require(k.dtype in _ENTRY, f"unsupported cache dtype {k.dtype}")
    kernels.require(k.dim() == 5 and 0 <= layer_idx < k.shape[0],
                    f"layer {layer_idx} out of range of a cache {tuple(k.shape)}")
    for name, t in (("k", k), ("v", v)):
        kernels.check_cuda_tensor(t, name, dtype=k.dtype, shape=k.shape)
    kernels.require(k.shape[3] % 2 == 0 and k.shape[3] <= 128,
                    f"stored head dim {k.shape[3]} must be even and at most 128")


def _check_sources(q, k, v, dtype, inv_freq):
    """q [B, 1, Hq, hd], k, v [B, 1, G, hd] of ``dtype``, each head a
    contiguous run of hd elements, every row start aligned to a pair."""
    b, t, _, hd = q.shape
    g = k.shape[2]
    kernels.require(t == 1, f"the decode prologue takes one token a row, got {t}")
    kernels.require(hd % 2 == 0 and hd <= 128, f"head dim {hd} must be even and <= 128")
    kernels.require(b <= 65535, f"batch {b} beyond the grid")
    for name, x, h in (("q", q, q.shape[2]), ("k", k, g), ("v", v, g)):
        kernels.check_cuda_tensor(x, name, dtype=dtype, shape=(b, 1, h, hd), strided=True)
        kernels.require(x.stride(2) == hd and x.stride(0) % 2 == 0
                        and x.data_ptr() % (2 * x.element_size()) == 0,
                        f"{name}: each row's heads must be contiguous and pair-aligned")
        kernels.require(not (torch.is_grad_enabled() and x.requires_grad),
                        f"{name} requires grad: the decode prologue has no backward")
    kernels.check_cuda_tensor(inv_freq, "inv_freq", dtype=torch.float32, shape=(hd // 2,))
    kernels.require(inv_freq.device == q.device, "inv_freq must be on q's device")


def _check_length(length, shape):
    kernels.check_cuda_tensor(length, "length", dtype=torch.int32)
    kernels.require(tuple(length.shape) == shape or (shape == () and length.numel() == 1),
                    f"length must have shape {shape}, got {tuple(length.shape)}")


def _launch(q, k, v, pos, inv_freq, q_out, cache_k, cache_v, mode, qk_norm,
            layer_idx, *, hq, g, hd):
    """One launch on the current stream; raises on a CUDA error.  Row
    strides come from dim 0 of q, k and v."""
    none = ctypes.c_void_p(None)
    b = k.shape[0]
    d, s = (cache_k.shape[3], cache_k.shape[4]) if cache_k is not None else (hd, 1)
    lib = _lib()
    rc = getattr(lib, _ENTRY[k.dtype])(
        kernels.ptr(q), kernels.ptr(k), kernels.ptr(v),
        q.stride(0), k.stride(0), v.stride(0), kernels.ptr(pos),
        kernels.ptr(inv_freq) if inv_freq is not None else none,
        kernels.ptr(q_out) if q_out is not None else none,
        kernels.ptr(cache_k) if cache_k is not None else none,
        kernels.ptr(cache_v) if cache_v is not None else none,
        mode, int(qk_norm), b, hq, g, hd, d, s, layer_idx, kernels.stream_ptr(k),
    )
    kernels.check(lib, rc, "decode_prologue")


def _lib() -> ctypes.CDLL:
    lib = kernels.load("cache_append")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
                       + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib
