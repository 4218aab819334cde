"""ViT-2D image encoder.

Counterpart of ``vats_tpu/models/vit2d.py``:

  proportional bilinear resize -> center crop -> Conv2d(k=p, s=p) patchify
  -> dropout -> N x (AttentionBlock(2-D axial RoPE, non-causal) -> FFNBlock)
  -> RMSNorm -> [B, num_patches, d_model] features, or pooled (mean / max)
  -> classifier -> [B, num_classes] fp32 logits when ``cfg.num_classes``.

Attention goes through ``nn/attention.py`` with ``cfg.attention_impl``: on
the card 'auto' picks the flash kernels once the grid has at least
``FLASH_MIN_SEQ_LEN`` patches (K2 in a forward without gradient; K2', K5a
and K5b under autograd), the plain attention below that and on the CPU.
Training with ``use_checkpointing`` wraps each block in
``torch.utils.checkpoint`` (the JAX ``nn.remat``): its forward, attention
included, runs again in the backward.

The resize is ``jax.image.resize``'s computation (:func:`resize_bilinear`):
a weight matrix per resized axis, in x's dtype, and one contraction an
axis, each rounded to x's dtype, in the order ``jnp.einsum`` picks.  In
bf16 it is bit-equal to JAX's on the CPU.  Patches flatten row-major over
(gH, gW), the order the RoPE positions assume.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vats_tpu_torch.configs.vit2d import ViT2DArgs
from vats_tpu_torch.device import no_tf32, resolve_device, resolve_dtype
from vats_tpu_torch.nn.activations import FFNBlock
from vats_tpu_torch.nn.attention import AttentionBlock, dense
from vats_tpu_torch.nn.dropout import SITE_EMBED, Seed, dropout
from vats_tpu_torch.nn.initializers import normal_
from vats_tpu_torch.nn.norms import RMSNorm
from vats_tpu_torch.parallel.layout import gathered


@functools.lru_cache(maxsize=64)
def _weight_mat(m: int, n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """[m, n]: ``jax.image``'s ``compute_weight_mat`` for a resize of an axis
    from m to n samples (scale n / m, no translation) with the linear
    (triangle) kernel, widened by 1 / scale when it shrinks (the antialias),
    each column normalised to sum 1, in ``dtype``.

    Computed in fp32 on the CPU, as XLA computes it: the sample positions
    (i + 0.5) / scale - 0.5 round once, as the fused multiply-add of XLA's
    vectorised loop does (rounding the product first moves a position by an
    fp32 ulp, which moves weights by far more than their own rounding when
    the positions are large).  Cached per device, so a CUDA graph replays
    with the matrices made in its warm-up."""
    f32 = torch.float32
    inv_scale = 1.0 / (n / m)
    kernel_scale = torch.tensor(max(inv_scale, 1.0), dtype=f32)
    inv32 = float(torch.tensor(inv_scale, dtype=f32))
    sample = ((torch.arange(n, dtype=f32) + 0.5).double() * inv32 - 0.5).to(f32)
    x = (sample[None, :] - torch.arange(m, dtype=f32)[:, None]).abs() / kernel_scale
    w = torch.clamp(1.0 - x.abs(), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(f32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    # no weight where the sample lies wholly outside the input
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(dtype).to(device)


def _resize_order(bc: int, hw: Tuple[int, int], size: Tuple[int, int]) -> str:
    """The pairwise order ``jnp.einsum`` (opt_einsum's 'optimal' path for
    three operands) takes for x [bc, H, W] and the two weight matrices: the
    cheapest of H first, W first and the matrices' outer product first in
    its flop count, the earlier of equals."""
    (h_in, w_in), (h, w) = hw, size
    flops = {"H": 2 * bc * w_in * h * (h_in + w),
             "W": 2 * bc * h_in * w * (w_in + h),
             "outer": h_in * w_in * h * w * (1 + 2 * bc)}
    return min(flops, key=flops.get)  # min keeps the first of equal costs


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """[..., H, W] -> [..., h, w]: ``jax.image.resize(method='bilinear')``
    with its rounding.  Each resized axis has a weight matrix in x's dtype
    (:func:`_weight_mat`; an axis whose size stays is left out); x is
    contracted with them one at a time, each product summed in full fp32
    (no TF32 on the card) and rounded to x's dtype, in
    :func:`_resize_order`'s order.  With no axis resized, x is returned."""
    (h_in, w_in), (h, w) = x.shape[-2:], tuple(size)
    dt, dev = x.dtype, x.device
    wh = _weight_mat(h_in, h, dt, dev).float() if h != h_in else None
    ww = _weight_mat(w_in, w, dt, dev).float() if w != w_in else None
    if wh is None and ww is None:
        return x
    first = "H" if ww is None else "W" if wh is None else _resize_order(
        x.numel() // (h_in * w_in), (h_in, w_in), (h, w))
    with no_tf32():
        if first == "outer":
            kron = (wh[:, None, :, None] * ww[None, :, None, :]).to(dt).float()
            y = x.float().flatten(-2) @ kron.reshape(h_in * w_in, h * w)
            return y.to(dt).reshape(*x.shape[:-2], h, w)
        for axis in ("H", "W") if first == "H" else ("W", "H"):
            if axis == "H" and wh is not None:
                x = (wh.T @ x.float()).to(dt)
            elif axis == "W" and ww is not None:
                x = (x.float() @ ww).to(dt)
    return x


def resize_and_center_crop(x: torch.Tensor, target_size: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, target, target]: the short side resized to
    ``target_size`` (the long one in proportion), then the center cropped."""
    _, _, h, w = x.shape
    scale = target_size / min(h, w)
    new_h, new_w = int(round(h * scale)), int(round(w * scale))
    x = resize_bilinear(x, (new_h, new_w))
    # lax.dynamic_slice clamps its start so the slice fits
    top = min(max((new_h - target_size) // 2, 0), new_h - target_size)
    left = min(max((new_w - target_size) // 2, 0), new_w - target_size)
    return x[:, :, top:top + target_size, left:left + target_size]


class PatchEmbeddings2D(nn.Module):
    """Raw [B, C, H, W] pixels -> [B, num_patches, d_model]."""

    def __init__(self, patch_size: int, target_size: int, c_in: int, d_model: int,
                 dtype=torch.float32, param_dtype=torch.float32, device=None):
        super().__init__()
        self.patch_size, self.target_size = patch_size, target_size
        self.c_in, self.d_model, self.dtype = c_in, d_model, dtype
        self.proj = nn.Conv2d(c_in, d_model, patch_size, stride=patch_size,
                              dtype=param_dtype, device=device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        p = self.patch_size
        normal_(self.proj.weight, math.sqrt(2.0 / (p * p * self.d_model)), generator)
        with torch.no_grad():
            self.proj.bias.zero_()

    def param_logical_axes(self):
        return {"proj.weight": ("conv_out", "conv_in", None, None)}  # OIHW

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4:
            raise ValueError(f"expected [B, C, H, W], got {tuple(x.shape)}")
        if x.shape[1] != self.c_in:
            raise ValueError(f"expected {self.c_in} channels, got {x.shape[1]}")
        dt = self.dtype
        x = resize_and_center_crop(x.to(dt), self.target_size)
        w = self.proj
        x = F.conv2d(x, gathered(w.weight).to(dt), w.bias.to(dt), stride=self.patch_size)
        return x.flatten(2).transpose(1, 2)  # [B, gH*gW, d], row-major


class SpatialTransformerBlock(nn.Module):
    """Non-causal attention block (2-D axial RoPE) + FFN block."""

    def __init__(self, cfg: ViT2DArgs, device=None):
        super().__init__()
        self.cfg = cfg
        dtype, param_dtype = resolve_dtype(cfg.dtype), resolve_dtype(cfg.param_dtype)
        self.attention_block = AttentionBlock(
            d_model=cfg.d_model, num_heads=cfg.num_heads,
            query_groups=cfg.query_groups, rope_theta=cfg.rope_theta,
            softmax_scale=cfg.softmax_scale, use_proj_bias=cfg.use_proj_bias,
            use_qkv_proj=cfg.use_fused_proj, use_qk_norm=cfg.use_qk_norm,
            dropout=cfg.dropout, eps=cfg.rms_norm_eps, num_layers=cfg.num_layers,
            impl=cfg.attention_impl, rope_type="2d_axial", dtype=dtype,
            param_dtype=param_dtype, device=device,
        )
        self.ffn_block = FFNBlock(
            d_model=cfg.d_model, d_ffn=cfg.d_ffn, dropout=cfg.dropout,
            eps=cfg.rms_norm_eps, num_layers=cfg.num_layers, dtype=dtype,
            param_dtype=param_dtype, device=device,
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.attention_block.reset_parameters(generator)
        self.ffn_block.reset_parameters(generator)

    def forward(self, x, grid_shape: Tuple[int, int], layer_idx: int = 0,
                deterministic: bool = True, dropout_seed: Optional[Seed] = None):
        cfg = self.cfg
        left = cfg.left_window if cfg.use_windowed_attn else -1
        right = cfg.right_window if cfg.use_windowed_attn else -1
        x, _ = self.attention_block(
            x, causal=False, left_window=left, right_window=right,
            grid_shape=grid_shape, layer_idx=layer_idx, deterministic=deterministic,
            dropout_seed=dropout_seed,
        )
        return self.ffn_block(x, deterministic=deterministic, dropout_seed=dropout_seed,
                              layer_idx=layer_idx)


class ImageEncoder(nn.Module):
    """ViT-2D on ``device`` (the card unless the caller asks for the CPU),
    weights drawn from ``torch.Generator`` seeded by ``seed``;
    ``device="meta"`` builds the shapes only."""

    def __init__(self, cfg: ViT2DArgs, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = resolve_dtype(cfg.dtype)
        param_dtype = resolve_dtype(cfg.param_dtype)
        self.patch_embeddings = PatchEmbeddings2D(
            cfg.patch_size, cfg.target_size, cfg.C_in, cfg.d_model, self.dtype,
            param_dtype, device=dev,
        )
        self.layers = nn.ModuleList(
            [SpatialTransformerBlock(cfg, device=dev) for _ in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.d_model, cfg.rms_norm_eps, self.dtype, param_dtype,
                            device=dev)
        self.classifier = (
            nn.Linear(cfg.d_model, cfg.num_classes, dtype=param_dtype, device=dev)
            if cfg.num_classes is not None else None
        )
        if dev.type != "meta":
            self.reset_parameters(torch.Generator(device=dev).manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.norm.weight.device

    def param_logical_axes(self):
        return {"classifier.weight": ("vocab", "embed")} if self.classifier is not None else {}

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

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                dropout_seed: Optional[Seed] = None) -> torch.Tensor:
        """[B, C, H, W] -> [B, num_patches, d_model] features, or
        [B, num_classes] fp32 logits when cfg.num_classes is set.
        dropout_seed: the step's dropout seed, an int or an int64 device
        tensor (drawn from the default CPU generator when dropout is on and
        none is given)."""
        cfg = self.cfg
        if not deterministic and cfg.dropout > 0 and dropout_seed is None:
            dropout_seed = int(torch.randint(0, 1 << 62, (1,)))
        x = self.patch_embeddings(x)
        x = dropout(x, cfg.dropout, deterministic=deterministic, seed=dropout_seed,
                    layer=-1, site=SITE_EMBED)
        grid = (cfg.grid_size, cfg.grid_size)
        remat = cfg.use_checkpointing and not deterministic and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            args = (x, grid, i, deterministic, dropout_seed)
            if remat:
                x = checkpoint(layer, *args, use_reentrant=False, preserve_rng_state=False)
            else:
                x = layer(*args)
        x = self.norm(x)
        if self.classifier is None:
            return x
        pooled = x.mean(dim=1) if cfg.pooling == "mean" else x.amax(dim=1)
        return dense(self.classifier, pooled, self.dtype).float()


#: the original repository's public name
ImageEncoderTransformer = ImageEncoder
