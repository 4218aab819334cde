"""Vision augmentations: mixup, cutmix and the random chooser.

Counterpart of ``vats_tpu/data/augmentations.py``.  Each op splits into its
draws and a deterministic core that the tests call with given draws:

  * :func:`mixup_blend`  — ``lam * x + (1 - lam) * x[index]`` given
    (lam, index);
  * :func:`cutmix_box`   — the box given (lam0, cx, cy), JAX's arithmetic;
  * :func:`cutmix_paste` — the partner's box pasted given (index, box), with
    lam = 1 - box area / image area.

The draws (a Beta(alpha, alpha) lam, a permutation, the box center, the
chooser's pick) come from an explicit CPU ``torch.Generator`` as host
scalars, so a step never waits on the card for them; the cores run where
the images are.  The bits are not JAX's: the packages agree given the same
draws, and in distribution.  The original repository's chooser passes its
``device`` positionally into mixup (a TypeError whenever mixup is picked);
this one, like the JAX package's, is correct.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

Mixed = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _numpy_rng(gen: torch.Generator) -> np.random.Generator:
    """A numpy generator seeded from ``gen`` (for the Beta draw, which
    torch cannot take from an explicit generator)."""
    return np.random.default_rng(int(torch.randint(0, 2**62, (1,), generator=gen)))


def _lam(value: float, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def mixup_blend(images: torch.Tensor, targets: torch.Tensor, lam: float,
                index: torch.Tensor) -> Mixed:
    """(lam * x + (1 - lam) * x[index] in x's dtype, targets,
    targets[index], lam) with the blend computed in fp32."""
    index = index.to(images.device)
    lam_t = _lam(lam, images.device)
    mixed = lam_t * images.float() + (1.0 - lam_t) * images[index].float()
    return mixed.to(images.dtype), targets, targets[index.to(targets.device)], lam_t


def mixup_data(gen: torch.Generator, images: torch.Tensor, targets: torch.Tensor,
               alpha: float) -> Mixed:
    """Blend each image with a random partner; returns (mixed, targets_a,
    targets_b, lam) with lam an fp32 scalar tensor."""
    if alpha == 0:
        return images, targets, targets, _lam(1.0, images.device)
    lam = float(_numpy_rng(gen).beta(alpha, alpha))
    index = torch.randperm(images.shape[0], generator=gen)
    return mixup_blend(images, targets, lam, index)


def cutmix_box(h: int, w: int, lam0: float, cx: int, cy: int) -> Tuple[int, int, int, int]:
    """(y1, y2, x1, x2) of the pasted box: sides sqrt(1 - lam0) of the
    image's, truncated to ints, centred at (cx, cy) and clipped."""
    cut_ratio = np.sqrt(np.float32(1.0) - np.float32(lam0))
    w_cut, h_cut = int(cut_ratio * np.float32(w)), int(cut_ratio * np.float32(h))
    x1, y1 = max(cx - w_cut // 2, 0), max(cy - h_cut // 2, 0)
    x2, y2 = min(cx + w_cut // 2, w), min(cy + h_cut // 2, h)
    return y1, y2, x1, x2


def cutmix_paste(images: torch.Tensor, targets: torch.Tensor, index: torch.Tensor,
                 box: Tuple[int, int, int, int]) -> Mixed:
    """Each image with its partner's ``box`` (y1, y2, x1, x2) pasted in;
    lam = 1 - box area / image area."""
    _, _, h, w = images.shape
    y1, y2, x1, x2 = box
    index = index.to(images.device)
    mixed = images.clone()
    mixed[:, :, y1:y2, x1:x2] = images[index][:, :, y1:y2, x1:x2]
    area = max(x2 - x1, 0) * max(y2 - y1, 0)
    lam = _lam(1.0 - np.float32(area) / np.float32(w * h), images.device)
    return mixed, targets, targets[index.to(targets.device)], lam


def cutmix_data(gen: torch.Generator, images: torch.Tensor, targets: torch.Tensor,
                alpha: float) -> Mixed:
    """Paste a random box from a partner image ([B, C, H, W])."""
    if alpha == 0:
        return images, targets, targets, _lam(1.0, images.device)
    b, _, h, w = images.shape
    lam0 = float(_numpy_rng(gen).beta(alpha, alpha))
    index = torch.randperm(b, generator=gen)
    cx = int(torch.randint(0, w, (1,), generator=gen))
    cy = int(torch.randint(0, h, (1,), generator=gen))
    return cutmix_paste(images, targets, index, cutmix_box(h, w, lam0, cx, cy))


def random_augmentation(gen: torch.Generator, images: torch.Tensor, targets: torch.Tensor,
                        alpha: float, cutmix_alpha: Optional[float] = None) -> Mixed:
    """Uniformly mixup, cutmix or nothing (the original chooser's
    semantics)."""
    if cutmix_alpha is None:
        cutmix_alpha = alpha
    choice = int(torch.randint(0, 3, (1,), generator=gen))
    if choice == 0:
        return mixup_data(gen, images, targets, alpha)
    if choice == 1:
        return cutmix_data(gen, images, targets, cutmix_alpha)
    return images, targets, targets, _lam(1.0, images.device)
