"""GQA attention with sliding windows, QK-norm, RoPE and three cache paths.

Counterpart of ``vats_tpu/nn/attention.py`` (``Attention``,
``AttentionBlock``, ``select_attention_impl``):

  qkv projection (fused or split, optional bias) -> optional L2 QK-norm
  -> RoPE at absolute positions -> grouped attention -> output projection.

Attention runs by one of these paths:
  * uncached: ``ops/flash_attention.flash_attention`` (K2, or K2' with K5a
    and K5b under autograd when training) or the plain PyTorch attention,
    chosen by :func:`select_attention_impl`; key padding and segment ids
    reach it as in the JAX module;
  * dense cache (``nn/kv_cache.KVCache``): the plain cached attention over
    the buffer, or over the ring (``_ring_cached_attention``); at T == 1
    the QK-norm, RoPE, pad and commit of the token are one launch of K3's
    dense prologue (``KVCache.decode_token``);
  * paged cache (``ops/decode_attention.PagedKVCache``): T == 1 through K3's
    paged prologue (QK-norm and RoPE in one launch), then K1 (K4 for an
    int8 pool, with its scales), which attends and commits the token in one
    launch; a fresh-cache prefill through K2 or the plain
    attention, then a whole-page append (quantized for an int8 pool); a
    prefill into a non-fresh cache through ``append_tokens`` +
    ``gather_dense_t`` (int8 pages dequantized into bf16) +
    ``cached_decode_attention``.

Only 1-D RoPE and ``context_parallel='none'`` are ported; the other modes
raise.  The JAX module's logical-sharding constraints have no counterpart in
one-chip serving.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vats_tpu_torch.nn.dropout import SITE_ATTN, dropout
from vats_tpu_torch.nn.initializers import input_proj_init_, output_proj_init_
from vats_tpu_torch.nn.kv_cache import KVCache
from vats_tpu_torch.nn.norms import RMSNorm, l2_normalize
from vats_tpu_torch.nn.rope import apply_rope_1d, rope_inv_freq
from vats_tpu_torch.ops import cache_append
from vats_tpu_torch.ops.attention_ref import (
    cached_decode_attention,
    dot_product_attention,
)
from vats_tpu_torch.ops.decode_attention import paged_decode_attention_commit
from vats_tpu_torch.ops.flash_attention import flash_attention

#: below this sequence length 'auto' takes the plain attention, as in the
#: JAX package (the flash kernel has no blocks to skip at short lengths)
FLASH_MIN_SEQ_LEN = 256


def select_attention_impl(
    impl: str,
    *,
    seq_len: Optional[int] = None,
    device: Optional[torch.device] = None,
) -> str:
    """'auto' picks the flash kernel ('flash') on a CUDA device for
    sequences of at least FLASH_MIN_SEQ_LEN, the plain attention ('xla', the
    config value shared with the JAX package) otherwise.  Where the JAX
    package picks 'flash' on a TPU, this picks it on the card."""
    if impl != "auto":
        return impl
    if seq_len is not None and seq_len < FLASH_MIN_SEQ_LEN:
        return "xla"
    if device is not None and torch.device(device).type == "cuda":
        return "flash"
    return "xla"


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax DenseGeneral(dtype=...) semantics: inputs, weight and bias are
    cast to the compute dtype before the product."""
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class Attention(nn.Module):
    def __init__(
        self,
        d_model: int,
        num_heads: int,
        query_groups: int,
        rope_theta: float = 10000.0,
        softmax_scale: Optional[float] = None,
        use_proj_bias: bool = False,
        use_qkv_proj: bool = True,
        use_qk_norm: bool = True,
        num_layers: int = 1,
        impl: str = "auto",
        rope_type: str = "1d",
        context_parallel: str = "none",
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        if d_model % num_heads != 0:
            raise ValueError(
                f"d_model ({d_model}) must be divisible by num_heads ({num_heads})"
            )
        if num_heads % query_groups != 0:
            raise ValueError(
                f"num_heads ({num_heads}) must be divisible by query_groups "
                f"({query_groups})"
            )
        if rope_type != "1d":
            raise NotImplementedError(
                f"rope_type={rope_type!r} is not ported yet (only '1d')"
            )
        if context_parallel != "none":
            raise NotImplementedError(
                f"context_parallel={context_parallel!r} is not ported yet"
            )
        self.d_model = d_model
        self.num_heads = num_heads
        self.query_groups = query_groups
        self.rope_theta = rope_theta
        self.softmax_scale = softmax_scale
        self.use_qkv_proj = use_qkv_proj
        self.use_qk_norm = use_qk_norm
        self.num_layers = num_layers
        self.impl = impl
        self.dtype = dtype
        hd, h, g = self.head_dim, num_heads, query_groups
        lin = lambda i, o: nn.Linear(  # noqa: E731
            i, o, bias=use_proj_bias, dtype=param_dtype, device=device
        )
        if use_qkv_proj:
            self.w_qkv = lin(d_model, (h + 2 * g) * hd)
        else:
            self.w_q = lin(d_model, h * hd)
            self.w_k = lin(d_model, g * hd)
            self.w_v = lin(d_model, g * hd)
        self.w_o = lin(h * hd, d_model)
        # the decode prologue's fp32 RoPE table per device, made at first use
        # on that device by rope_inv_freq (as apply_rope_1d makes it); not a
        # buffer: a model built on the meta device could not move it
        self._rope_tables = {}

    def _rope_table(self, device: torch.device) -> torch.Tensor:
        table = self._rope_tables.get(device)
        if table is None:
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                # made here, the table would be filled only by replays
                raise RuntimeError(
                    "decode prologue: no RoPE table for this device yet; run the "
                    "step once before capturing it")
            table = rope_inv_freq(self.head_dim, self.rope_theta, device=device)
            self._rope_tables[device] = table
        return table

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        ins = [self.w_qkv] if self.use_qkv_proj else [self.w_q, self.w_k, self.w_v]
        for lin in ins:
            input_proj_init_(
                lin.weight, self.num_layers, (lin.in_features, lin.out_features),
                generator,
            )
        output_proj_init_(self.w_o.weight, self.num_layers, generator)
        with torch.no_grad():
            for lin in ins + [self.w_o]:
                if lin.bias is not None:
                    lin.bias.zero_()

    def project_qkv(self, x: torch.Tensor):
        b, t, _ = x.shape
        h, g, hd = self.num_heads, self.query_groups, self.head_dim
        if self.use_qkv_proj:
            qkv = dense(self.w_qkv, x, self.dtype)
            q, k, v = torch.split(qkv, [h * hd, g * hd, g * hd], dim=-1)
        else:
            q = dense(self.w_q, x, self.dtype)
            k = dense(self.w_k, x, self.dtype)
            v = dense(self.w_v, x, self.dtype)
        return q.reshape(b, t, h, hd), k.reshape(b, t, g, hd), v.reshape(b, t, g, hd)

    def forward(
        self,
        x: torch.Tensor,
        *,
        causal: bool = True,
        left_window: int = -1,
        right_window: int = -1,
        padding_mask: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
        paged_cache=None,
        layer_idx: int = 0,
        segment_ids: Optional[torch.Tensor] = None,
    ):
        """x: [B, T, d_model] -> ([B, T, d_model], updated cache or None).

        padding_mask: bool, True = valid token; [B, T] for uncached forwards.
        With a dense ``cache`` it may instead be [B, max_seq_len], a validity
        mask over the whole buffer kept by the generation loop."""
        b, t, _ = x.shape
        q, k, v = self.project_qkv(x)
        # a decode token's QK-norm and RoPE run inside K3's prologue
        decode = t == 1 and (cache is not None or paged_cache is not None)
        if self.use_qk_norm and not decode:
            q = l2_normalize(q)
            k = l2_normalize(k)
        scale = (
            self.softmax_scale
            if self.softmax_scale is not None
            else 1.0 / float(self.head_dim) ** 0.5
        )
        if causal:
            right_window = 0

        if paged_cache is not None:
            out, new_cache = self._paged_attention(
                q, k, v, paged_cache, layer_idx, padding_mask, scale, left_window
            )
        elif cache is None:
            positions = torch.arange(t, device=x.device)
            q = apply_rope_1d(q, positions, self.rope_theta)
            k = apply_rope_1d(k, positions, self.rope_theta)
            impl = select_attention_impl(self.impl, seq_len=t, device=q.device)
            attend = flash_attention if impl == "flash" else dot_product_attention
            out = attend(
                q, k, v, scale=scale, causal=causal, left_window=left_window,
                right_window=right_window, kv_valid=padding_mask,
                q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
            )
            new_cache = None
        else:
            start = cache.length
            positions = start + torch.arange(t, device=x.device)
            if decode:
                q = cache.decode_token(
                    layer_idx, q, k, v, self._rope_table(x.device),
                    theta=self.rope_theta, qk_norm=self.use_qk_norm,
                )
                new_cache = cache
            else:
                q = apply_rope_1d(q, positions, self.rope_theta)
                k = apply_rope_1d(k, positions, self.rope_theta)
                new_cache = cache.update_layer(layer_idx, k, v)
            if cache.ring:
                out = self._ring_cached_attention(
                    q, k, v, new_cache, positions, padding_mask, scale,
                    causal, left_window, right_window, b, t, layer_idx,
                )
            else:
                k_buf, v_buf = new_cache.layer_t(layer_idx)
                s = new_cache.max_seq_len
                kv_valid = new_cache.valid_mask(b, extra=t)
                if padding_mask is not None:
                    if padding_mask.shape[-1] == s:
                        kv_valid = kv_valid & padding_mask.bool()
                    else:
                        kv_valid = kv_valid & self._merge_padding(
                            padding_mask, start, b, s
                        )
                out = self._attend_buffer(
                    q, k_buf, v_buf, scale=scale, causal=causal,
                    left_window=left_window, right_window=right_window,
                    q_positions=positions,
                    kv_positions=torch.arange(s, device=x.device),
                    kv_valid=kv_valid,
                )

        out = out.reshape(b, t, self.num_heads * self.head_dim)
        return dense(self.w_o, out, self.dtype), new_cache

    def _attend_buffer(self, q, k_buf, v_buf, **kw):
        """cached_decode_attention with q zero-padded to the stored head dim
        (the pad rows of the buffer are zero; a decode prologue's q comes
        padded) and the output sliced back."""
        if q.shape[-1] != k_buf.shape[2]:
            q = F.pad(q, (0, k_buf.shape[2] - q.shape[-1]))
        return cached_decode_attention(q, k_buf, v_buf, **kw)[..., :self.head_dim]

    def _ring_cached_attention(
        self, q, k, v, cache, positions, padding_mask, scale,
        causal, left_window, right_window, b, t, layer_idx,
    ):
        """Attention against a sliding-window ring cache.  Prefill (t > 1,
        from an empty cache) attends its own window; decode attends the ring
        with each slot's absolute position rebuilt from the ring arithmetic."""
        if t > 1:
            kv_valid = None
            if padding_mask is not None:
                kv_valid = padding_mask.bool()[:, :t]
            impl = select_attention_impl(self.impl, seq_len=t, device=q.device)
            attend = flash_attention if impl == "flash" else dot_product_attention
            return attend(
                q, k, v, scale=scale, causal=causal, left_window=left_window,
                right_window=right_window, kv_valid=kv_valid,
            )
        k_buf, v_buf = cache.layer_t(layer_idx)
        s = cache.max_seq_len
        slot_pos = cache.slot_positions(extra=t)  # [S] absolute, < 0 unwritten
        kv_valid = (slot_pos[None, :] >= 0).expand(b, s)
        if padding_mask is not None and padding_mask.shape[-1] != s:
            idx = torch.clamp(slot_pos, 0, padding_mask.shape[-1] - 1).long()
            kv_valid = kv_valid & padding_mask.bool()[:, idx]
        elif padding_mask is not None:
            kv_valid = kv_valid & padding_mask.bool()
        return self._attend_buffer(
            q, k_buf, v_buf, scale=scale, causal=causal,
            left_window=left_window, right_window=right_window,
            q_positions=positions, kv_positions=slot_pos, kv_valid=kv_valid,
        )

    def _paged_attention(
        self, q, k, v, paged_cache, layer_idx, padding_mask, scale, left_window
    ):
        """Ragged-batch causal attention over a PagedKVCache; each row's
        positions start at its own ``lengths[b]``."""
        b, t = q.shape[0], q.shape[1]
        lengths = paged_cache.lengths
        if t == 1:
            q1, k1, v1 = cache_append.paged_decode_prologue(
                q, k, v, lengths, self._rope_table(q.device),
                theta=self.rope_theta, qk_norm=self.use_qk_norm,
            )
            out = paged_decode_attention_commit(
                q1, paged_cache.kv_pages, layer_idx, paged_cache.page_table,
                lengths, scale=scale, k_cur=k1, v_cur=v1,
                kv_scales=paged_cache.kv_scales,
            )
            paged_cache.fresh = False
            return out[:, None], paged_cache

        positions = lengths[:, None] + torch.arange(t, device=q.device)[None, :]
        q = apply_rope_1d(q, positions, self.rope_theta)
        k = apply_rope_1d(k, positions, self.rope_theta)

        if paged_cache.fresh:
            # fresh-cache prefill: every row starts at 0, so attention is
            # plain causal over this window; the pages still get the roped K/V
            impl = select_attention_impl(self.impl, seq_len=t, device=q.device)
            attend = flash_attention if impl == "flash" else dot_product_attention
            out = attend(
                q, k, v, scale=scale, causal=True, left_window=left_window,
                right_window=0, kv_valid=padding_mask,
            )
            return out, paged_cache.append_window_pages(layer_idx, k, v)

        # prefill into a cache with history: append the window, gather the
        # pages and attend the whole buffer with masks
        new_cache = paged_cache.append_tokens(layer_idx, k, v)
        k_buf, v_buf = new_cache.gather_dense_t(layer_idx)
        s = k_buf.shape[-1]
        buf_pos = torch.arange(s, device=q.device)[None, :]
        kv_valid = buf_pos < (lengths + t)[:, None]
        if padding_mask is not None:
            in_window = (buf_pos >= lengths[:, None]) & kv_valid
            rel = torch.clamp(buf_pos - lengths[:, None], 0, t - 1)
            window_valid = torch.gather(padding_mask.bool(), 1, rel)
            kv_valid = kv_valid & torch.where(in_window, window_valid, True)
        out = self._attend_buffer(
            q, k_buf, v_buf, scale=scale, causal=True, left_window=left_window,
            q_positions=positions, kv_positions=torch.arange(s, device=q.device),
            kv_valid=kv_valid,
        )
        return out, new_cache

    @staticmethod
    def _merge_padding(padding_mask, start, b, max_s):
        """A [B, T] window mask placed at ``start`` of an all-valid [B, S]
        mask (dynamic_update_slice semantics: the start clamps to fit)."""
        t = padding_mask.shape[-1]
        start = torch.clamp(start, max=max_s - t)
        pos = torch.arange(max_s, device=padding_mask.device)[None, :]
        rel = pos - start
        in_window = (rel >= 0) & (rel < t)
        window = torch.gather(
            padding_mask.bool(), 1, torch.clamp(rel, 0, t - 1).expand(b, max_s)
        )
        return torch.where(in_window, window, True)


class AttentionBlock(nn.Module):
    """Pre-RMSNorm -> Attention -> dropout -> residual."""

    def __init__(
        self,
        d_model: int,
        num_heads: int,
        query_groups: int,
        rope_theta: float = 10000.0,
        softmax_scale: Optional[float] = None,
        use_proj_bias: bool = False,
        use_qkv_proj: bool = True,
        use_qk_norm: bool = True,
        dropout: float = 0.0,
        eps: float = 1e-7,
        num_layers: int = 1,
        impl: str = "auto",
        rope_type: str = "1d",
        context_parallel: str = "none",
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.dropout = dropout
        self.norm = RMSNorm(d_model, eps, dtype, param_dtype, device=device)
        self.attn = Attention(
            d_model, num_heads, query_groups, rope_theta=rope_theta,
            softmax_scale=softmax_scale, use_proj_bias=use_proj_bias,
            use_qkv_proj=use_qkv_proj, use_qk_norm=use_qk_norm,
            num_layers=num_layers, impl=impl, rope_type=rope_type,
            context_parallel=context_parallel, dtype=dtype,
            param_dtype=param_dtype, device=device,
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.norm.weight.fill_(1.0)
        self.attn.reset_parameters(generator)

    def forward(self, x, *, deterministic: bool = True,
                dropout_seed: Optional[int] = None, **kw) -> Tuple:
        out, new_cache = self.attn(self.norm(x), **kw)
        out = dropout(out, self.dropout, deterministic=deterministic,
                      seed=dropout_seed, layer=kw.get("layer_idx", 0),
                      site=SITE_ATTN)
        return x + out, new_cache
