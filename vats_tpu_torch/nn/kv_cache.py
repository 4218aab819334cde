"""Dense KV cache (sequence-minor layout), updated in place.

Counterpart of ``vats_tpu/nn/kv_cache.py``: pre-allocated
``[num_layers, B, kv_heads, head_dim_pad, max_seq_len]`` buffers (the JAX
layout, kept so the two packages compare like with like), a scalar
``length`` that lives on the device, and an optional sliding-window ring
mode where slot = absolute position % S.  Writes happen in place (the JAX
cache is a functional pytree that XLA updates in place under donation);
methods return ``self`` for call-site parity.

The attention's decode step (T == 1) goes through :meth:`decode_token`:
K3's dense prologue (``ops/cache_append.py``), which norms and rotates the
token's q and k and commits k and v in one launch on CUDA, for every S (the
JAX package takes its append kernel only when S is a multiple of 128, a TPU
tiling rule).  :meth:`update_layer` at T == 1 takes K3's append-only mode.
The clamp ``min(length, S-1)`` is semantics and stays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from vats_tpu_torch.ops import cache_append


def _pad_head_dim(head_dim: int) -> int:
    """Stored head dim: padded to the 8-element granule (60 -> 64)."""
    return -(-head_dim // 8) * 8


def ring_slots_for_window(left_window: int, min_extra: int = 1) -> int:
    """Buffer slots for a sliding-window ring cache: the window plus the
    current token, rounded up to 128 (the JAX package's sizing, kept so
    both packages allocate the same ring)."""
    return -(-(left_window + min_extra) // 128) * 128


@dataclass
class KVCache:
    k: torch.Tensor  # [L, B, G, hd_pad, S]
    v: torch.Tensor  # [L, B, G, hd_pad, S]
    length: torch.Tensor  # int32 scalar on the cache's device
    head_dim: int = 0  # logical head dim
    ring: bool = False

    @classmethod
    def create(
        cls,
        num_layers: int,
        batch_size: int,
        max_seq_len: int,
        kv_heads: int,
        head_dim: int,
        dtype: torch.dtype = torch.bfloat16,
        ring: bool = False,
        device=None,
    ) -> "KVCache":
        shape = (
            num_layers, batch_size, kv_heads, _pad_head_dim(head_dim), max_seq_len
        )
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            length=torch.zeros((), dtype=torch.int32, device=device),
            head_dim=head_dim,
            ring=ring,
        )

    @property
    def max_seq_len(self) -> int:
        return self.k.shape[-1]

    def _pad_kv(self, x: torch.Tensor) -> torch.Tensor:
        hd_pad = self.k.shape[3]
        if x.shape[-1] == hd_pad:
            return x
        return torch.nn.functional.pad(x, (0, hd_pad - x.shape[-1]))

    def update_layer(
        self, layer_idx: int, k_new: torch.Tensor, v_new: torch.Tensor
    ) -> "KVCache":
        """Write [B, T, G, hd] keys/values at offset ``length`` for one layer.
        Does not advance ``length`` (call :meth:`advance` after all layers)."""
        k_new = self._pad_kv(k_new).to(self.k.dtype)
        v_new = self._pad_kv(v_new).to(self.v.dtype)
        s = self.max_seq_len
        t = k_new.shape[1]
        write_pos = torch.remainder(self.length, s) if self.ring else self.length
        if t == 1:
            cache_append.append_token_inplace(
                self.k, self.v, layer_idx,
                k_new[:, 0].contiguous(), v_new[:, 0].contiguous(), write_pos,
            )
            return self
        dev = self.k.device
        if self.ring:
            # prefill into the ring: only the most recent S positions survive,
            # written at their modulo slots (unique since keep <= S)
            keep = min(t, s)
            pos0 = self.length + (t - keep)
            slots = torch.remainder(pos0 + torch.arange(keep, device=dev), s)
            src_k, src_v = k_new[:, -keep:], v_new[:, -keep:]
        else:
            # dynamic_update_slice semantics: the start clamps so T fits
            start = torch.clamp(self.length, max=s - t)
            slots = start + torch.arange(t, device=dev)
            src_k, src_v = k_new, v_new
        self.k[layer_idx].index_copy_(-1, slots, src_k.permute(0, 2, 3, 1))
        self.v[layer_idx].index_copy_(-1, slots, src_v.permute(0, 2, 3, 1))
        return self

    def decode_token(
        self,
        layer_idx: int,
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        inv_freq: torch.Tensor,
        *,
        theta: float,
        qk_norm: bool,
    ) -> torch.Tensor:
        """One decode token ([B, 1, H, hd] q, k, v from the projection):
        q and k L2-normalised (``qk_norm``) and rotated at position
        ``length``, k and v written at offset ``length`` for one layer (as
        :meth:`update_layer`), in one launch on the card.  Returns q
        zero-padded to the stored head dim.  Does not advance ``length``."""
        return cache_append.dense_decode_prologue(
            q, k, v, self.k, self.v, self.length, layer_idx, inv_freq,
            theta=theta, qk_norm=qk_norm, ring=self.ring,
        )

    def slot_positions(self, extra: int = 0) -> torch.Tensor:
        """[S] int32: absolute position held by each ring slot, counting
        ``extra`` tokens appended this step; negative for unwritten slots."""
        s = self.max_seq_len
        total = self.length + extra
        slot = torch.arange(s, dtype=torch.int32, device=self.k.device)
        return slot + torch.div(total - 1 - slot, s, rounding_mode="floor") * s

    def advance(self, num_tokens: int) -> "KVCache":
        """Advance ``length`` in place: it keeps its storage, so a captured
        decode step reads and writes the same tensor at every replay."""
        self.length.add_(num_tokens)
        return self

    def layer_t(self, layer_idx: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Native full-buffer views for a layer: ([B, G, hd_pad, S], same)."""
        return self.k[layer_idx], self.v[layer_idx]

    def valid_mask(self, batch_size: int, extra: int = 0) -> torch.Tensor:
        """[B, S] bool: True where a slot holds a written entry, counting
        ``extra`` tokens appended this step."""
        s = self.max_seq_len
        pos = torch.arange(s, device=self.k.device)[None, :]
        return (pos < self.length + extra).expand(batch_size, s)
