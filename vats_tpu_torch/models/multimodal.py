"""Fused text+image+video token-stream decoder.

Counterpart of ``vats_tpu/models/multimodal.py``.  One decoder-only
transformer models the fused stream

    [text prompt][image raster tokens][video raster tokens]

with a single KV cache (dense or paged), an offset-partitioned vocabulary
(text [0, Vt), image [Vt, Vt+Vi), video [Vt+Vi, Vt+Vi+Vv)) with one
embedding table and a tied head, and modality-dependent RoPE: each token's
rotation is the 1-D one at its stream position for text, the raster 2-D NTK
one inside the image grid and the raster 3-D NTK one inside the video grid.
:func:`multimodal_rope_angles` makes the [B, T, hd/2] (cos, sin) table once
a forward; every layer's ``AttentionBlock`` (``rope_type="none"``) takes it
as ``rope_angles``.  A decode token (T == 1) therefore runs K3's prologue in
table mode (paged, or dense) reading that very table, then K1 on the paged
cache; a fresh paged prefill of at least ``FLASH_MIN_SEQ_LEN`` tokens runs
K2 on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vats_tpu_torch.configs.multimodal import MultimodalStreamArgs
from vats_tpu_torch.device import resolve_device, resolve_dtype
from vats_tpu_torch.models.image_gen import _step_seed
from vats_tpu_torch.nn.activations import FFNBlock
from vats_tpu_torch.nn.attention import AttentionBlock, dense, embed_rows
from vats_tpu_torch.nn.dropout import SITE_EMBED, Seed, dropout
from vats_tpu_torch.nn.initializers import embed_init_, head_init_
from vats_tpu_torch.nn.kv_cache import KVCache
from vats_tpu_torch.nn.norms import RMSNorm
from vats_tpu_torch.nn.rope import rope_2d_ntk_cos_sin, rope_3d_ntk_cos_sin, rope_cos_sin
from vats_tpu_torch.ops.decode_attention import PagedKVCache

MODALITY_TEXT = 0
MODALITY_IMAGE = 1
MODALITY_VIDEO = 2


def multimodal_rope_angles(
    cfg: MultimodalStreamArgs,
    modality: torch.Tensor,
    local_pos: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token fp32 (cos, sin) of shape modality.shape + [hd/2].

    modality: int (0 text, 1 image, 2 video); local_pos: the segment-local
    position (text: stream index; image / video: raster index in the grid).
    Each token takes the table of its own stack's rotation: the 1-D one
    (``rope_cos_sin``), the raster 2-D NTK one over the image grid
    (``rope_2d_ntk_cos_sin``) or the raster 3-D NTK one over the video grid
    (``rope_3d_ntk_cos_sin``); cos and sin are elementwise, so each token's
    row is bit-equal to that stack's.  No host sync, so a captured decode
    step makes it on the card."""
    hd, theta, ntk = cfg.head_dim, cfg.rope_theta, cfg.ntk_scale_factor
    text = rope_cos_sin(local_pos, hd, theta)
    image = rope_2d_ntk_cos_sin(local_pos, hd, cfg.image_grid_w, theta, ntk)
    video = rope_3d_ntk_cos_sin(local_pos, hd, cfg.video_grid_h, cfg.video_grid_w, theta, ntk)
    m = modality[..., None]
    return tuple(torch.where(m == MODALITY_TEXT, t, torch.where(m == MODALITY_IMAGE, i, v))
                 for t, i, v in zip(text, image, video))


class MultimodalLM(nn.Module):
    """Decoder-only transformer over the fused stream, on ``device`` (the
    card unless the caller asks for the CPU), weights from ``seed``;
    ``device="meta"`` builds the shapes only."""

    def __init__(self, cfg: MultimodalStreamArgs, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = resolve_dtype(cfg.dtype)
        pdt = resolve_dtype(cfg.param_dtype)
        n = cfg.num_layers
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.d_model, dtype=pdt, device=dev)
        self.attn_blocks = nn.ModuleList([
            AttentionBlock(cfg.d_model, cfg.num_heads, cfg.query_groups,
                           rope_theta=cfg.rope_theta, softmax_scale=cfg.softmax_scale,
                           use_proj_bias=cfg.use_proj_bias, use_qkv_proj=cfg.use_qkv_proj,
                           use_qk_norm=cfg.use_qk_norm, dropout=cfg.dropout,
                           eps=cfg.rms_norm_eps, num_layers=n, impl=cfg.attention_impl,
                           rope_type="none", dtype=self.dtype, param_dtype=pdt, device=dev)
            for _ in range(n)])
        self.ffn_blocks = nn.ModuleList([
            FFNBlock(cfg.d_model, cfg.d_ffn, cfg.dropout, cfg.rms_norm_eps, n, self.dtype,
                     pdt, device=dev)
            for _ in range(n)])
        self.norm = RMSNorm(cfg.d_model, cfg.rms_norm_eps, self.dtype, pdt, device=dev)
        self.lm_head = None
        if not cfg.tie_weights:
            self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False, dtype=pdt,
                                     device=dev)
        if dev.type != "meta":
            self.reset_parameters(torch.Generator(device=dev).manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.norm.weight.device

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        embed_init_(self.token_embed.weight, generator)
        for a, f in zip(self.attn_blocks, self.ffn_blocks):
            a.reset_parameters(generator)
            f.reset_parameters(generator)
        with torch.no_grad():
            self.norm.weight.fill_(1.0)
        if self.lm_head is not None:
            head_init_(self.lm_head.weight, generator)

    def forward(
        self,
        token_ids: torch.Tensor,
        modality: torch.Tensor,
        local_pos: torch.Tensor,
        padding_mask: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
        paged_cache: Optional[PagedKVCache] = None,
        deterministic: bool = True,
        readout_positions: Optional[torch.Tensor] = None,
        dropout_seed: Optional[Seed] = None,
    ):
        """token_ids [B, T] fused-vocabulary ids; modality, local_pos
        [B, T].  Returns (fp32 logits [B, T, vocab], the cache or None);
        ``readout_positions`` [B]: logits only at these per-row positions
        ([B, 1, vocab]).  A paged cache advances each row by its true token
        count (ragged prefill), a dense one by T."""
        cfg = self.cfg
        seed = _step_seed(deterministic, cfg.dropout, dropout_seed)
        x = embed_rows(self.token_embed.weight, token_ids).to(self.dtype)
        x = dropout(x, cfg.dropout, deterministic=deterministic, seed=seed, layer=-1,
                    site=SITE_EMBED)
        rope_angles = multimodal_rope_angles(cfg, modality, local_pos)
        t = token_ids.shape[1]
        # a fresh paged cache lets every layer's T > 1 window skip the page
        # gather; layer 0's append clears the flag, so re-pin it for the rest
        fresh0 = paged_cache is not None and paged_cache.fresh and t > 1
        for i, (a, f) in enumerate(zip(self.attn_blocks, self.ffn_blocks)):
            if fresh0 and i > 0:
                paged_cache.fresh = True
            x, _ = a(x, causal=True, padding_mask=padding_mask, cache=cache,
                     paged_cache=paged_cache, layer_idx=i, rope_angles=rope_angles,
                     deterministic=deterministic, dropout_seed=seed)
            x = f(x, deterministic=deterministic, dropout_seed=seed, layer_idx=i)
        new_cache = cache
        if paged_cache is not None:
            paged_cache.fresh = False
            if padding_mask is not None and t > 1:
                counts = padding_mask.to(torch.int32).sum(dim=1)
            else:
                counts = torch.full((token_ids.shape[0],), t, dtype=torch.int32,
                                    device=x.device)
            new_cache = paged_cache.advance_by(counts)
        elif cache is not None:
            new_cache = cache.advance(t)

        x = self.norm(x)
        if readout_positions is not None:
            idx = readout_positions.long()[:, None, None].expand(-1, 1, x.shape[-1])
            x = torch.gather(x, 1, idx)
        if self.lm_head is None:
            # flax Embed.attend: both operands in the compute dtype
            w = self.token_embed.weight
            logits = F.linear(x.to(w.dtype).to(self.dtype), w.to(self.dtype))
        else:
            logits = dense(self.lm_head, x, self.dtype)
        return logits.float(), new_cache

    def init_cache(self, batch_size: int, max_len: Optional[int] = None) -> KVCache:
        cfg = self.cfg
        return KVCache.create(
            num_layers=cfg.num_layers, batch_size=batch_size,
            max_seq_len=max_len or cfg.max_seq_len, kv_heads=cfg.query_groups,
            head_dim=cfg.head_dim, dtype=self.dtype, device=self.device)

    def init_paged_cache(self, batch_size: int, max_len: Optional[int] = None,
                         page_size: int = 128) -> PagedKVCache:
        cfg = self.cfg
        return PagedKVCache.create(
            num_layers=cfg.num_layers, batch_size=batch_size,
            max_seq_len=max_len or cfg.max_seq_len, kv_heads=cfg.query_groups,
            head_dim=cfg.head_dim, page_size=page_size, dtype=self.dtype,
            device=self.device)


def stream_layout(cfg: MultimodalStreamArgs, text_len: int,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(modality [S], local_pos [S]) int32 of the canonical fused layout
    [text_len][image_tokens][video_tokens]."""
    n_img, n_vid = cfg.image_tokens, cfg.video_tokens
    i32 = dict(dtype=torch.int32, device=device)
    modality = torch.cat([torch.full((text_len,), MODALITY_TEXT, **i32),
                          torch.full((n_img,), MODALITY_IMAGE, **i32),
                          torch.full((n_vid,), MODALITY_VIDEO, **i32)])
    local_pos = torch.cat([torch.arange(text_len, **i32), torch.arange(n_img, **i32),
                           torch.arange(n_vid, **i32)])
    return modality, local_pos
