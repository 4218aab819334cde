"""ViT-3D video encoder with factorized spatio-temporal attention.

Counterpart of ``vats_tpu/models/vit3d.py``:

  per-frame bilinear resize -> pad / truncate to max_frames (frame mask)
  -> bias-free Conv3d(k=p, s=p) patchify -> frame mask onto the patch grid
  -> N x [SpatioTemporalAttentionBlock -> FFNBlock] -> RMSNorm
  -> [B, gT*gH*gW, d_model] features, or a masked-mean classifier head.

The attention is sequential and shares one ``w_qkv`` and one ``w_o``: a
spatial pass over [B*gT, gH*gW] tokens (3-D RoPE on the h and w thirds),
then a temporal pass over the spatial output transposed to [B*gH*gW, gT]
(RoPE on the t third).  The temporal mask is the patch mask transposed
the same way; the original repository viewed it without the transpose,
which scrambles it, and the JAX package fixed that.

Attention runs the plain ``ops/attention_ref.dot_product_attention`` on the
card and the CPU alike, with ``window_size`` as left / right windows and
the mask as ``kv_valid``: the JAX model calls XLA's attention here, never
its flash kernel (short sequences, where the kernel loses).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vats_tpu_torch.configs.vit3d import ViT3DArgs
from vats_tpu_torch.device import resolve_device, resolve_dtype
from vats_tpu_torch.models.vit2d import resize_bilinear
from vats_tpu_torch.nn.activations import FFNBlock
from vats_tpu_torch.nn.attention import dense
from vats_tpu_torch.nn.dropout import SITE_ATTN, Seed, dropout
from vats_tpu_torch.nn.initializers import input_proj_init_, normal_, output_proj_init_
from vats_tpu_torch.nn.norms import RMSNorm, l2_normalize
from vats_tpu_torch.nn.rope import apply_rope_3d_axial
from vats_tpu_torch.ops.attention_ref import dot_product_attention


class PatchEmbeddings3D(nn.Module):
    def __init__(self, cfg: ViT3DArgs, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = resolve_dtype(cfg.dtype)
        self.projection = nn.Conv3d(
            cfg.C_in, cfg.d_model, cfg.patch_size, stride=cfg.patch_size, bias=False,
            dtype=resolve_dtype(cfg.param_dtype), device=device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        pt, ph, pw = self.cfg.patch_size
        normal_(self.projection.weight,
                math.sqrt(2.0 / (pt * ph * pw * self.cfg.d_model)), generator)

    def forward(self, x: torch.Tensor, frame_mask: Optional[torch.Tensor] = None,
                use_padding: bool = True):
        """[B, C, T, H, W] -> ([B, gT, gH*gW, d], patch_mask [B, N] or None,
        (gT, gH, gW)); frame_mask [B, T] bool marks the valid frames."""
        cfg = self.cfg
        if x.dim() != 5:
            raise ValueError(f"expected [B, C, T, H, W], got {tuple(x.shape)}")
        b, _, t = x.shape[:3]
        x = resize_bilinear(x.to(self.dtype), cfg.target_size)
        mf = cfg.max_frames
        if frame_mask is None and use_padding:
            frame_mask = torch.ones((b, t), dtype=torch.bool, device=x.device)
        if t < mf:
            x = F.pad(x, (0, 0, 0, 0, 0, mf - t))
            if frame_mask is not None:
                frame_mask = F.pad(frame_mask.bool(), (0, mf - t), value=False)
        elif t > mf:
            x = x[:, :, :mf]
            if frame_mask is not None:
                frame_mask = frame_mask[:, :mf]
        pt, ph, pw = cfg.patch_size
        gt, gh, gw = mf // pt, cfg.target_size[0] // ph, cfg.target_size[1] // pw
        x = F.conv3d(x, self.projection.weight.to(self.dtype), stride=cfg.patch_size)
        x = x.permute(0, 2, 3, 4, 1).reshape(b, gt, gh * gw, cfg.d_model)
        patch_mask = None
        if frame_mask is not None:
            # a temporal cell is valid when any of its pt frames is
            cells = frame_mask.bool().reshape(b, gt, pt).any(dim=-1)
            patch_mask = cells[:, :, None].expand(b, gt, gh * gw).reshape(b, gt * gh * gw)
        return x, patch_mask, (gt, gh, gw)


class SpatioTemporalAttention(nn.Module):
    """Sequential factorized attention with shared projections."""

    def __init__(self, cfg: ViT3DArgs, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = resolve_dtype(cfg.dtype)
        h, g, hd = cfg.num_heads, cfg.query_groups, cfg.head_dim
        lin = lambda i, o: nn.Linear(  # noqa: E731
            i, o, bias=cfg.use_proj_bias, dtype=resolve_dtype(cfg.param_dtype),
            device=device)
        self.w_qkv = lin(cfg.d_model, (h + 2 * g) * hd)
        self.w_o = lin(h * hd, cfg.d_model)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        n = self.cfg.num_layers
        w = self.w_qkv
        input_proj_init_(w.weight, n, (w.in_features, w.out_features), generator)
        output_proj_init_(self.w_o.weight, n, generator)
        with torch.no_grad():
            for lin in (self.w_qkv, self.w_o):
                if lin.bias is not None:
                    lin.bias.zero_()

    def _attend(self, x2d, grid_shape, mode: str, kv_valid):
        """x2d [B', L, d] (B' = B*gT spatial, B*gH*gW temporal) -> [B', L, h*hd]."""
        cfg = self.cfg
        bp, l, _ = x2d.shape
        h, g, hd = cfg.num_heads, cfg.query_groups, cfg.head_dim
        q, k, v = dense(self.w_qkv, x2d, self.dtype).split([h * hd, g * hd, g * hd], dim=-1)
        q, k, v = q.reshape(bp, l, h, hd), k.reshape(bp, l, g, hd), v.reshape(bp, l, g, hd)
        if cfg.use_qk_norm:
            q, k = l2_normalize(q), l2_normalize(k)
        gt, gh, gw = grid_shape
        q = apply_rope_3d_axial(q, gt, gh, gw, cfg.rope_theta, mode=mode)
        k = apply_rope_3d_axial(k, gt, gh, gw, cfg.rope_theta, mode=mode)
        left, right = cfg.window_size
        out = dot_product_attention(q, k, v, scale=cfg.softmax_scale, causal=False,
                                    left_window=left, right_window=right,
                                    kv_valid=kv_valid)
        return out.reshape(bp, l, h * hd)

    def forward(self, x: torch.Tensor, grid_shape: Tuple[int, int, int],
                patch_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, gT, HW, d] -> [B, gT, HW, d]."""
        b, gt, hw, d = x.shape
        spatial_mask = temporal_mask = None
        if patch_mask is not None:
            m = patch_mask.reshape(b, gt, hw)
            spatial_mask = m.reshape(b * gt, hw)
            temporal_mask = m.transpose(1, 2).reshape(b * hw, gt)
        s = self._attend(x.reshape(b * gt, hw, d), grid_shape, "spatial", spatial_mask)
        s = s.reshape(b, gt, hw, -1)
        tmp = s.transpose(1, 2).reshape(b * hw, gt, -1)
        t_out = self._attend(tmp, grid_shape, "temporal", temporal_mask)
        out = t_out.reshape(b, hw, gt, -1).transpose(1, 2)  # [B, gT, HW, h*hd]
        return dense(self.w_o, out, self.dtype)


class SpatioTemporalAttentionBlock(nn.Module):
    """x + dropout(attention(rms_norm(x)))."""

    def __init__(self, cfg: ViT3DArgs, device=None):
        super().__init__()
        self.cfg = cfg
        dtype, param_dtype = resolve_dtype(cfg.dtype), resolve_dtype(cfg.param_dtype)
        self.norm = RMSNorm(cfg.d_model, cfg.rms_norm_eps, dtype, param_dtype, device=device)
        self.attention = SpatioTemporalAttention(cfg, device=device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.norm.weight.fill_(1.0)
        self.attention.reset_parameters(generator)

    def forward(self, x, grid_shape, patch_mask, layer_idx: int = 0,
                deterministic: bool = True, dropout_seed: Optional[Seed] = None):
        h = self.attention(self.norm(x), grid_shape, patch_mask)
        h = dropout(h, self.cfg.dropout, deterministic=deterministic, seed=dropout_seed,
                    layer=layer_idx, site=SITE_ATTN)
        return x + h


class VideoTransformerBlock(nn.Module):
    def __init__(self, cfg: ViT3DArgs, device=None):
        super().__init__()
        dtype, param_dtype = resolve_dtype(cfg.dtype), resolve_dtype(cfg.param_dtype)
        self.attention_block = SpatioTemporalAttentionBlock(cfg, device=device)
        self.ffn_block = FFNBlock(
            d_model=cfg.d_model, d_ffn=cfg.d_ffn, dropout=cfg.dropout,
            eps=cfg.rms_norm_eps, num_layers=cfg.num_layers, dtype=dtype,
            param_dtype=param_dtype, device=device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.attention_block.reset_parameters(generator)
        self.ffn_block.reset_parameters(generator)

    def forward(self, x, grid_shape, patch_mask, layer_idx: int = 0,
                deterministic: bool = True, dropout_seed: Optional[Seed] = None):
        x = self.attention_block(x, grid_shape, patch_mask, layer_idx, deterministic,
                                 dropout_seed)
        b, gt, hw, d = x.shape
        x = self.ffn_block(x.reshape(b, gt * hw, d), deterministic=deterministic,
                           dropout_seed=dropout_seed, layer_idx=layer_idx)
        return x.reshape(b, gt, hw, d)


class VideoTransformer(nn.Module):
    """ViT-3D on ``device`` (the card unless the caller asks for the CPU),
    weights drawn from ``torch.Generator`` seeded by ``seed``;
    ``device="meta"`` builds the shapes only."""

    def __init__(self, cfg: ViT3DArgs, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = resolve_dtype(cfg.dtype)
        param_dtype = resolve_dtype(cfg.param_dtype)
        self.patch_embeddings = PatchEmbeddings3D(cfg, device=dev)
        self.layers = nn.ModuleList(
            [VideoTransformerBlock(cfg, device=dev) for _ in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.d_model, cfg.rms_norm_eps, self.dtype, param_dtype,
                            device=dev)
        self.classifier = (
            nn.Linear(cfg.d_model, cfg.num_classes, dtype=param_dtype, device=dev)
            if cfg.use_classifier_head else None
        )
        if dev.type != "meta":
            self.reset_parameters(torch.Generator(device=dev).manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.norm.weight.device

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.patch_embeddings.reset_parameters(generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        with torch.no_grad():
            self.norm.weight.fill_(1.0)
        if self.classifier is not None:
            normal_(self.classifier.weight, self.cfg.d_model ** -0.5, generator)
            with torch.no_grad():
                self.classifier.bias.zero_()

    def forward(self, x: torch.Tensor, frame_mask: Optional[torch.Tensor] = None,
                use_padding: bool = True, deterministic: bool = True,
                dropout_seed: Optional[Seed] = None) -> torch.Tensor:
        """[B, C, T, H, W] -> [B, gT*gH*gW, d_model] features, or
        [B, num_classes] fp32 logits when cfg.use_classifier_head."""
        cfg = self.cfg
        if not deterministic and cfg.dropout > 0 and dropout_seed is None:
            dropout_seed = int(torch.randint(0, 1 << 62, (1,)))
        x, patch_mask, grid = self.patch_embeddings(x, frame_mask, use_padding)
        remat = cfg.use_checkpointing and not deterministic and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            args = (x, grid, patch_mask, i, deterministic, dropout_seed)
            if remat:
                x = checkpoint(layer, *args, use_reentrant=False, preserve_rng_state=False)
            else:
                x = layer(*args)
        feats = self.norm(x).reshape(x.shape[0], -1, cfg.d_model)
        if self.classifier is None:
            return feats
        if patch_mask is not None:
            m = patch_mask[..., None].to(feats.dtype)
            pooled = (feats * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
        else:
            pooled = feats.mean(dim=1)
        return dense(self.classifier, pooled, self.dtype).float()
