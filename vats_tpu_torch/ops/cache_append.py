"""K3: in-place single-token append into the dense KV cache.

Counterpart of ``vats_tpu/ops/cache_append.py`` (``_append_kernel`` behind
``append_token_inplace``).  The dense :class:`~vats_tpu_torch.nn.kv_cache.
KVCache` keeps the JAX package's sequence-minor layout ``[L, B, G, hd_pad,
S]``; one decode step writes each row's new K/V at position
``min(length, S-1)`` of one layer.  On a CUDA tensor the write is the
hand-written kernel in ``csrc/cache_append.cu``, which reads ``length`` on
the device (no host sync); on a CPU tensor it is :func:`append_token_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from vats_tpu_torch.ops import kernels


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
    kernels.require(k.dtype in _ENTRY, f"unsupported cache dtype {k.dtype}")
    kernels.require(0 <= layer_idx < l, f"layer {layer_idx} out of range")
    for name, t in (("k", k), ("v", v)):
        kernels.check_cuda_tensor(t, name, dtype=k.dtype, shape=(l, b, g, d, s))
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        kernels.check_cuda_tensor(t, name, dtype=k.dtype, shape=(b, g, d))
    kernels.check_cuda_tensor(length, "length", dtype=torch.int32)
    kernels.require(length.numel() == 1, "length must be a scalar tensor")
    lib = _lib()
    fn = getattr(lib, _ENTRY[k.dtype])
    rc = fn(
        kernels.ptr(k), kernels.ptr(v), kernels.ptr(k_new), kernels.ptr(v_new),
        kernels.ptr(length), layer_idx, b, g, d, s, kernels.stream_ptr(k),
    )
    kernels.check(lib, rc, "cache_append")
    kernels.count_launch(append_token_inplace)


append_token_inplace.launches = 0

_ENTRY = {
    torch.bfloat16: "vats_cache_append_bf16",
    torch.float32: "vats_cache_append_f32",
}


def _lib() -> ctypes.CDLL:
    lib = kernels.load("cache_append")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
