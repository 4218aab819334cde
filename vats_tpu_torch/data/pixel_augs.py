"""On-card pixel augmentations: AutoAugment (IMAGENET policy), random
rotation, random erasing.

Counterpart of ``vats_tpu/data/pixel_augs.py``: the original repository's
host-side torchvision battery (RandomRotation(15), AutoAugment(IMAGENET),
RandomErasing) as batched tensor ops on [B, C, H, W] images in [0, 1],
run inside the train step where the images are.  Geometric warps are
gathers (inverse affine about the image center, nearest sample, zero
fill); photometric ops follow PIL / torchvision on [0, 1] floats.

Every op is a function of (images [B, C, H, W], magnitude): the magnitude
is a scalar or one value per image ([B]).  The random wrappers draw from an
explicit ``torch.Generator`` on the images' device and hand their draws to
a deterministic core (:func:`autoaugment_apply`, :func:`rotate`,
:func:`erase_boxes`) that the tests call with given draws; the
``*_from_uniforms`` functions take the draws as uniforms (the train step's
battery makes them from its device seed, so it replays from a CUDA graph).
Constants reach the device once (:func:`device_constant`) and Python numbers
by fills: nothing copies from the host inside a step.  AutoAugment
applies, for each of a sub-policy's two stages, every op the policy has at
that stage to the whole batch and keeps each image's own (the JAX
package's ``vmap`` of ``lax.switch`` computes every branch too); no
Python loop runs over images.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _per_image(m, images: torch.Tensor) -> torch.Tensor:
    """A magnitude as an fp32 [B] tensor on the images' device (a Python
    number by a fill, never a host-to-device copy, which a CUDA graph
    capture refuses)."""
    if not isinstance(m, torch.Tensor):
        return torch.full((images.shape[0],), float(m), dtype=torch.float32,
                          device=images.device)
    m = m.to(device=images.device, dtype=torch.float32)
    return m.expand(images.shape[0]) if m.dim() == 0 else m


_CONSTANTS: Dict[Tuple[str, torch.device, torch.dtype], torch.Tensor] = {}


def device_constant(name: str, value, device, dtype=None) -> torch.Tensor:
    """``value`` (an array) on ``device``, made once per (name, device,
    dtype) and kept: the first call (eager, a graph's warm-up) copies it
    from the host, so a capture only reads it."""
    key = (name, torch.device(device), dtype)
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.as_tensor(np.asarray(value), device=device, dtype=dtype)
    return t


# --- geometric warps ----------------------------------------------------------


def _affine_nearest(images: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Warp [B, C, H, W] by per-image inverse-affine [B, 2, 3] matrices that
    map output (x, y) to source (x, y), both about the image center;
    samples outside the image are 0."""
    b, c, h, w = images.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=images.device) - cy
    xs = torch.arange(w, dtype=torch.float32, device=images.device) - cx
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    a = inv[:, :, :, None, None]  # [B, 2, 3, 1, 1]
    sx = a[:, 0, 0] * xx + a[:, 0, 1] * yy + a[:, 0, 2] + cx  # [B, H, W]
    sy = a[:, 1, 0] * xx + a[:, 1, 1] * yy + a[:, 1, 2] + cy
    ix, iy = torch.round(sx).to(torch.int64), torch.round(sy).to(torch.int64)
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    flat = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(b, 1, h * w)
    out = torch.gather(images.reshape(b, c, h * w), 2, flat.expand(b, c, h * w))
    return torch.where(valid[:, None], out.reshape(b, c, h, w),
                       torch.zeros((), dtype=images.dtype, device=images.device))


def _matrix(images, rows) -> torch.Tensor:
    """[B, 2, 3] from two rows of three [B] (or scalar) entries."""
    b = images.shape[0]
    return torch.stack([torch.stack([_per_image(v, images).expand(b) for v in r], -1)
                        for r in rows], 1)


def rotate(images: torch.Tensor, degrees) -> torch.Tensor:
    """Rotate by ``degrees`` (positive counterclockwise, PIL's convention)."""
    rad = _per_image(degrees, images) * -(math.pi / 180.0)
    cos, sin = torch.cos(rad), torch.sin(rad)
    return _affine_nearest(images, _matrix(images, ((cos, sin, 0.0), (-sin, cos, 0.0))))


def shear_x(images, v):
    return _affine_nearest(images, _matrix(images, ((1.0, v, 0.0), (0.0, 1.0, 0.0))))


def shear_y(images, v):
    return _affine_nearest(images, _matrix(images, ((1.0, 0.0, 0.0), (v, 1.0, 0.0))))


def translate_x(images, frac):
    w = images.shape[3]
    shift = -_per_image(frac, images) * w
    return _affine_nearest(images, _matrix(images, ((1.0, 0.0, shift), (0.0, 1.0, 0.0))))


def translate_y(images, frac):
    h = images.shape[2]
    shift = -_per_image(frac, images) * h
    return _affine_nearest(images, _matrix(images, ((1.0, 0.0, 0.0), (0.0, 1.0, shift))))


# --- photometric ops ----------------------------------------------------------


def _col(m, images) -> torch.Tensor:
    """A magnitude broadcast over [B, C, H, W]."""
    return _per_image(m, images)[:, None, None, None]


def _grayscale(images: torch.Tensor) -> torch.Tensor:
    r, g, b = images[:, 0], images[:, 1], images[:, 2]
    return 0.299 * r + 0.587 * g + 0.114 * b  # [B, H, W]


def _blend(a: torch.Tensor, b: torch.Tensor, factor) -> torch.Tensor:
    """PIL's enhancer: factor 0 gives a (the degenerate image), 1 gives b."""
    return torch.clamp(a + _col(factor, b) * (b - a), 0.0, 1.0)


def color(images, factor):
    return _blend(_grayscale(images)[:, None].expand_as(images), images, factor)


def contrast(images, factor):
    mean = (torch.round(_grayscale(images) * 255.0) / 255.0).mean(dim=(1, 2))
    return _blend(mean[:, None, None, None].expand_as(images), images, factor)


def brightness(images, factor):
    return _blend(torch.zeros_like(images), images, factor)


def sharpness(images, factor):
    """Blend with PIL's SMOOTH filter (3x3, centre 5, /13, zero padded);
    the border pixels keep their values, as torchvision's do."""
    b, c, h, w = images.shape
    kern = device_constant("smooth", np.array([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0],
                                               [1.0, 1.0, 1.0]]) / 13.0,
                           images.device, images.dtype)
    smoothed = F.conv2d(images.reshape(b * c, 1, h, w), kern[None, None],
                        padding=1).reshape(b, c, h, w)
    rows = torch.arange(h, device=images.device)[:, None]
    cols = torch.arange(w, device=images.device)[None, :]
    interior = (rows > 0) & (rows < h - 1) & (cols > 0) & (cols < w - 1)
    return _blend(torch.where(interior, smoothed, images), images, factor)


def posterize(images, bits):
    """Keep the top ``bits`` bits of each 8-bit channel value."""
    x = torch.clamp(torch.round(images * 255.0), 0, 255).to(torch.int32)
    shift = (8 - _per_image(bits, images).to(torch.int32))[:, None, None, None]
    return ((x >> shift) << shift).to(images.dtype) / 255.0


def solarize(images, threshold):
    return torch.where(images >= _col(threshold, images), 1.0 - images, images)


def invert(images, _=None):
    return 1.0 - images


def autocontrast(images, _=None):
    lo = images.amin(dim=(2, 3), keepdim=True)
    hi = images.amax(dim=(2, 3), keepdim=True)
    scale = torch.where(hi > lo, 1.0 / torch.clamp(hi - lo, min=1e-12), 1.0)
    off = torch.where(hi > lo, lo, 0.0)
    return torch.clamp((images - off) * scale, 0.0, 1.0)


def equalize(images, _=None):
    """torchvision's per-channel histogram equalization, batched: a
    [B*C, 256] histogram by ``scatter_add_``, its cumulative sum as the
    lookup table; a channel whose step is 0 keeps its values."""
    b, c, h, w = images.shape
    x = torch.clamp(torch.round(images * 255.0), 0, 255).to(torch.int64).reshape(b * c, h * w)
    hist = torch.zeros((b * c, 256), dtype=torch.int64, device=images.device)
    hist.scatter_add_(1, x, torch.ones_like(x))
    bins = torch.arange(256, device=images.device)
    idx_last = torch.where(hist > 0, bins, -1).amax(dim=1, keepdim=True)
    last_count = torch.gather(hist, 1, idx_last)
    step = (h * w - last_count) // 255  # [B*C, 1]
    lut = (torch.cumsum(hist, 1) + step // 2) // torch.clamp(step, min=1)
    lut = torch.clamp(F.pad(lut[:, :-1], (1, 0)), 0, 255)
    eq = torch.gather(lut, 1, x).to(images.dtype) / 255.0
    out = torch.where(step == 0, images.reshape(b * c, h * w), eq)
    return out.reshape(b, c, h, w)


def identity(images, _=None):
    return images


# --- AutoAugment, IMAGENET policy ---------------------------------------------

#: op table: id -> op(images, magnitude)
OPS = (identity, shear_x, shear_y, translate_x, translate_y, rotate, color,
       posterize, solarize, contrast, sharpness, brightness, autocontrast,
       equalize, invert)
_OP_ID = {
    "Identity": 0, "ShearX": 1, "ShearY": 2, "TranslateX": 3, "TranslateY": 4,
    "Rotate": 5, "Color": 6, "Posterize": 7, "Solarize": 8, "Contrast": 9,
    "Sharpness": 10, "Brightness": 11, "AutoContrast": 12, "Equalize": 13,
    "Invert": 14,
}
_SIGNED = {"ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
           "Color", "Contrast", "Sharpness", "Brightness"}
_ENHANCERS = ("Color", "Contrast", "Sharpness", "Brightness")


def _magnitude(name: str, idx) -> float:
    """torchvision's magnitude bins (10), in the ops' units."""
    if idx is None:
        return 0.0
    if name in ("ShearX", "ShearY"):
        return float(np.linspace(0.0, 0.3, 10)[idx])
    if name in ("TranslateX", "TranslateY"):
        return float(np.linspace(0.0, 150.0 / 331.0, 10)[idx])
    if name == "Rotate":
        return float(np.linspace(0.0, 30.0, 10)[idx])
    if name in _ENHANCERS:
        # enhancer factor = 1 + sign * m
        return float(np.linspace(0.0, 0.9, 10)[idx])
    if name == "Posterize":
        return float(8 - int(round(idx * 4 / 9)))
    if name == "Solarize":
        return float(np.linspace(255.0, 0.0, 10)[idx] / 255.0)
    return 0.0


#: torchvision's IMAGENET policy: 25 sub-policies of two (op, p, magnitude bin)
IMAGENET_POLICY = (
    (("Posterize", 0.4, 8), ("Rotate", 0.6, 9)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, None)),
    (("Equalize", 0.8, None), ("Equalize", 0.6, None)),
    (("Posterize", 0.6, 7), ("Posterize", 0.6, 6)),
    (("Equalize", 0.4, None), ("Solarize", 0.2, 4)),
    (("Equalize", 0.4, None), ("Rotate", 0.8, 8)),
    (("Solarize", 0.6, 3), ("Equalize", 0.6, None)),
    (("Posterize", 0.8, 5), ("Equalize", 1.0, None)),
    (("Rotate", 0.2, 3), ("Solarize", 0.6, 8)),
    (("Equalize", 0.6, None), ("Posterize", 0.4, 6)),
    (("Rotate", 0.8, 8), ("Color", 0.4, 0)),
    (("Rotate", 0.4, 9), ("Equalize", 0.6, None)),
    (("Equalize", 0.0, None), ("Equalize", 0.8, None)),
    (("Invert", 0.6, None), ("Equalize", 1.0, None)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Rotate", 0.8, 8), ("Color", 1.0, 2)),
    (("Color", 0.8, 8), ("Solarize", 0.8, 7)),
    (("Sharpness", 0.4, 7), ("Invert", 0.6, None)),
    (("ShearX", 0.6, 5), ("Equalize", 1.0, None)),
    (("Color", 0.4, 0), ("Equalize", 0.6, None)),
    (("Equalize", 0.4, None), ("Solarize", 0.2, 4)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, None)),
    (("Invert", 0.6, None), ("Equalize", 1.0, None)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Equalize", 0.8, None), ("Equalize", 0.6, None)),
)
_P_OP = np.array([[_OP_ID[s[0]] for s in sp] for sp in IMAGENET_POLICY], np.int64)
_P_PROB = np.array([[s[1] for s in sp] for sp in IMAGENET_POLICY], np.float32)
_P_MAG = np.array([[_magnitude(s[0], s[2]) for s in sp] for sp in IMAGENET_POLICY],
                  np.float32)
_P_SIGNED = np.array([[s[0] in _SIGNED for s in sp] for sp in IMAGENET_POLICY])
_P_ENHANCER = np.array([[s[0] in _ENHANCERS for s in sp] for sp in IMAGENET_POLICY])


def autoaugment_apply(images: torch.Tensor, sub_policy: torch.Tensor, uniforms: torch.Tensor,
                      signs: torch.Tensor) -> torch.Tensor:
    """AutoAugment given its draws: image i takes sub-policy
    ``sub_policy[i]`` (in [0, 25)); its stage s applies when
    ``uniforms[i, s]`` < the stage's p, with ``signs[i, s]`` (+-1) on a
    signed magnitude.  images [B, C, H, W] in [0, 1]; computed in fp32."""
    dev = images.device
    sp = sub_policy.to(dev).long()
    img = images.float()
    table = {name: device_constant(name, arr, dev) for name, arr in (
        ("policy_op", _P_OP), ("policy_mag", _P_MAG), ("policy_signed", _P_SIGNED),
        ("policy_enhancer", _P_ENHANCER), ("policy_prob", _P_PROB))}
    for stage in range(2):
        op_id = table["policy_op"][:, stage][sp]
        m = table["policy_mag"][:, stage][sp]
        sign = torch.where(table["policy_signed"][:, stage][sp],
                           signs[:, stage].to(dev).float(), 1.0)
        m = torch.where(table["policy_enhancer"][:, stage][sp], 1.0 + sign * m, sign * m)
        prob = table["policy_prob"][:, stage][sp]
        applied = img
        for op in sorted(set(_P_OP[:, stage].tolist())):
            chosen = (op_id == op)[:, None, None, None]
            applied = torch.where(chosen, OPS[op](img, m), applied)
        keep = (uniforms[:, stage].to(dev) < prob)[:, None, None, None]
        img = torch.where(keep, applied, img)
    return img.to(images.dtype)


def autoaugment_imagenet(gen: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    """AutoAugment (IMAGENET policy) on [B, C, H, W] in [0, 1]: per image a
    sub-policy, per stage an apply draw and a random sign (torchvision's
    ``AutoAugment.forward``); draws from ``gen`` on the images' device."""
    b, dev = images.shape[0], images.device
    return autoaugment_from_uniforms(images, torch.rand((5, b), generator=gen, device=dev))


def autoaugment_from_uniforms(images: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """AutoAugment given [5, B] uniforms in [0, 1): the sub-policy, the two
    stages' apply draws and their signs."""
    sp = torch.clamp((u[0] * len(IMAGENET_POLICY)).long(), max=len(IMAGENET_POLICY) - 1)
    signs = torch.where(u[3:5].T < 0.5, 1.0, -1.0)
    return autoaugment_apply(images, sp, u[1:3].T, signs)


# --- RandomRotation / RandomErasing -------------------------------------------


def random_rotation(gen: torch.Generator, images: torch.Tensor,
                    degrees: float = 15.0) -> torch.Tensor:
    """Rotate each image by U(-degrees, degrees) about its center
    (torchvision's RandomRotation: nearest, zero fill)."""
    u = torch.rand((images.shape[0],), generator=gen, device=images.device)
    return rotation_from_uniforms(images, u, degrees)


def rotation_from_uniforms(images: torch.Tensor, u: torch.Tensor,
                           degrees: float = 15.0) -> torch.Tensor:
    """RandomRotation given one uniform in [0, 1) per image."""
    angles = -degrees + u * (2.0 * degrees)
    return rotate(images.float(), angles).to(images.dtype)


def erase_boxes(images: torch.Tensor, apply: torch.Tensor, area_frac: torch.Tensor,
                log_ratio: torch.Tensor, uy: torch.Tensor, ux: torch.Tensor,
                value: float = 0.0) -> torch.Tensor:
    """RandomErasing given its draws, one per image: whether to erase, the
    box's area as a fraction of the image, its log aspect ratio, and the
    uniforms that place it (sides rounded and clamped to the image)."""
    b, _, h, w = images.shape
    area = area_frac * (h * w)
    aspect = torch.exp(log_ratio)
    eh = torch.clamp(torch.round(torch.sqrt(area * aspect)), 1, h).to(torch.int64)
    ew = torch.clamp(torch.round(torch.sqrt(area / aspect)), 1, w).to(torch.int64)
    y0 = (uy * (h - eh + 1)).to(torch.int64)
    x0 = (ux * (w - ew + 1)).to(torch.int64)
    ys = torch.arange(h, device=images.device)[None, :, None]
    xs = torch.arange(w, device=images.device)[None, None, :]
    box = ((ys >= y0[:, None, None]) & (ys < (y0 + eh)[:, None, None])
           & (xs >= x0[:, None, None]) & (xs < (x0 + ew)[:, None, None]))
    box = box & apply.bool()[:, None, None]
    return torch.where(box[:, None], value, images)


def random_erasing(gen: torch.Generator, images: torch.Tensor, p: float = 0.4,
                   scale: Tuple[float, float] = (0.02, 0.33),
                   ratio: Tuple[float, float] = (0.3, 3.3),
                   value: float = 0.0) -> torch.Tensor:
    """torchvision's RandomErasing with probability ``p``: a box of U(scale)
    of the area at aspect exp(U(log ratio)).  Static shapes: the box is
    drawn once and clamped where torchvision would retry (only extreme
    ratios differ)."""
    u = torch.rand((5, images.shape[0]), generator=gen, device=images.device)
    return erasing_from_uniforms(images, u, p, scale, ratio, value)


def erasing_from_uniforms(images: torch.Tensor, u: torch.Tensor, p: float = 0.4,
                          scale: Tuple[float, float] = (0.02, 0.33),
                          ratio: Tuple[float, float] = (0.3, 3.3),
                          value: float = 0.0) -> torch.Tensor:
    """RandomErasing given [5, B] uniforms in [0, 1): apply, area, log
    ratio, and the box's place."""
    apply = u[0] < p
    area = scale[0] + u[1] * (scale[1] - scale[0])
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    log_r = lo + u[2] * (hi - lo)
    return erase_boxes(images, apply, area, log_r, u[3], u[4], value)
