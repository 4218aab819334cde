"""Vision augmentations: mixup, cutmix and the random chooser.

Counterpart of ``vats_tpu/data/augmentations.py``.  Each op splits into its
draws and a deterministic core that the tests call with given draws:

  * :func:`mixup_blend`  — ``lam * x + (1 - lam) * x[index]`` given
    (lam, index);
  * :func:`cutmix_given` — the partner's box pasted given (lam0, index, cx,
    cy): the box an [H, W] mask in JAX's arithmetic (:func:`cutmix_mask`),
    lam = 1 - box area / image area;
  * :func:`augment_given` — JAX's chooser: all three choices computed, one
    picked with ``where``, so one program serves every draw (the train
    step replays it from a CUDA graph, its draws copied into static
    buffers).

The draws (a Beta(alpha, alpha) lam, a permutation, the box center, the
chooser's pick) come from an explicit CPU ``torch.Generator``
(:func:`draw_augmentation`), so a step never waits on the card for them;
the cores run where the images are, on draws that are tensors there.  The
bits are not JAX's: the packages agree given the same draws, and in
distribution.  The original repository's chooser passes its ``device``
positionally into mixup (a TypeError whenever mixup is picked); this one,
like the JAX package's, is correct.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

Mixed = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _numpy_rng(gen: torch.Generator) -> np.random.Generator:
    """A numpy generator seeded from ``gen`` (for the Beta draw, which
    torch cannot take from an explicit generator)."""
    return np.random.default_rng(int(torch.randint(0, 2**62, (1,), generator=gen)))


def _lam(value: float, device) -> torch.Tensor:
    return torch.full((), float(value), dtype=torch.float32, device=device)


def mixup_blend(images: torch.Tensor, targets: torch.Tensor, lam,
                index: torch.Tensor) -> Mixed:
    """(lam * x + (1 - lam) * x[index] in x's dtype, targets,
    targets[index], lam) with the blend computed in fp32; ``lam`` a float
    or an fp32 scalar tensor on the images' device."""
    index = index.to(images.device)
    lam_t = lam if isinstance(lam, torch.Tensor) else _lam(lam, images.device)
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


def cutmix_mask(h: int, w: int, lam0: torch.Tensor, cx: torch.Tensor,
                cy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(box [H, W] bool, lam fp32) from scalar tensors, in JAX's arithmetic
    (``vats_tpu/data/augmentations.py:58-77``): sides sqrt(1 - lam0) of the
    image's, truncated, centred at (cx, cy) and clipped."""
    dev = lam0.device
    cut_ratio = torch.sqrt(1.0 - lam0)
    w_cut, h_cut = (cut_ratio * w).to(torch.int64), (cut_ratio * h).to(torch.int64)
    x1, y1 = torch.clamp(cx - w_cut // 2, min=0), torch.clamp(cy - h_cut // 2, min=0)
    x2, y2 = torch.clamp(cx + w_cut // 2, max=w), torch.clamp(cy + h_cut // 2, max=h)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    box = (ys >= y1) & (ys < y2) & (xs >= x1) & (xs < x2)
    lam = 1.0 - ((x2 - x1) * (y2 - y1)).to(torch.float32) / float(w * h)
    return box, lam


def cutmix_given(images: torch.Tensor, targets: torch.Tensor, lam0: torch.Tensor,
                 index: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor) -> Mixed:
    """Each image with its partner's box pasted in ([B, C, H, W]); the draws
    are tensors on the images' device."""
    box, lam = cutmix_mask(images.shape[2], images.shape[3], lam0, cx, cy)
    index = index.to(images.device)
    mixed = torch.where(box, images[index], images)
    return mixed, targets, targets[index.to(targets.device)], lam


def cutmix_data(gen: torch.Generator, images: torch.Tensor, targets: torch.Tensor,
                alpha: float) -> Mixed:
    """Paste a random box from a partner image ([B, C, H, W])."""
    if alpha == 0:
        return images, targets, targets, _lam(1.0, images.device)
    b, _, h, w = images.shape
    dev = images.device
    lam0 = float(_numpy_rng(gen).beta(alpha, alpha))
    index = torch.randperm(b, generator=gen)
    cx = torch.randint(0, w, (), generator=gen)
    cy = torch.randint(0, h, (), generator=gen)
    return cutmix_given(images, targets, torch.tensor(lam0, dtype=torch.float32, device=dev),
                        index, cx.to(dev), cy.to(dev))


def draw_augmentation(gen: torch.Generator, b: int, h: int, w: int, alpha: float,
                      cutmix_alpha: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """Every draw of :func:`augment_given` from ``gen`` (CPU tensors): the
    chooser's pick, mixup's lam and partners, cutmix's lam0, partners and
    box center.  An alpha of 0 gives lam 1 and each image its own partner
    (the op is then the identity, as JAX's early return is)."""
    if cutmix_alpha is None:
        cutmix_alpha = alpha
    beta = lambda a: float(_numpy_rng(gen).beta(a, a)) if a else 1.0  # noqa: E731
    perm = lambda a: torch.randperm(b, generator=gen) if a else torch.arange(b)  # noqa: E731
    out = {"choice": torch.randint(0, 3, (), generator=gen)}
    out["mix_lam"] = torch.tensor(beta(alpha), dtype=torch.float32)
    out["mix_index"] = perm(alpha)
    out["cut_lam0"] = torch.tensor(beta(cutmix_alpha), dtype=torch.float32)
    out["cut_index"] = perm(cutmix_alpha)
    out["cx"] = torch.randint(0, w, (), generator=gen)
    out["cy"] = torch.randint(0, h, (), generator=gen)
    return out


def augment_given(images: torch.Tensor, targets: torch.Tensor,
                  draws: Dict[str, torch.Tensor]) -> Mixed:
    """JAX's ``random_augmentation`` given its draws (tensors on the images'
    device): mixup, cutmix and none all computed, one picked by
    ``draws['choice']`` (0, 1, 2)."""
    mixed, _, tb_m, lam_m = mixup_blend(images, targets, draws["mix_lam"], draws["mix_index"])
    cut, _, tb_c, lam_c = cutmix_given(images, targets, draws["cut_lam0"], draws["cut_index"],
                                       draws["cx"], draws["cy"])
    choice = draws["choice"]

    def pick(a, b, c):
        return torch.where(choice == 0, a, torch.where(choice == 1, b, c))

    return (pick(mixed, cut, images), targets, pick(tb_m, tb_c, targets),
            pick(lam_m, lam_c, torch.ones_like(lam_m)))


def random_augmentation(gen: torch.Generator, images: torch.Tensor, targets: torch.Tensor,
                        alpha: float, cutmix_alpha: Optional[float] = None) -> Mixed:
    """Uniformly mixup, cutmix or nothing (the original chooser's
    semantics), drawn from the CPU generator ``gen``."""
    b, _, h, w = images.shape
    draws = {k: v.to(images.device) for k, v in
             draw_augmentation(gen, b, h, w, alpha, cutmix_alpha).items()}
    return augment_given(images, targets, draws)
