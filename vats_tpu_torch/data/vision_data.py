"""Vision data loaders.

The port's own copy of ``vats_tpu/data/vision_data.py`` (that module imports
no JAX): hosts decode and collate raw pixel arrays, and resize, normalize,
patchify and augmentation run on the card (the models' patch embeddings,
``data/augmentations.py``, ``data/pixel_augs.py``).  Batches are numpy
arrays; ``data/feed.py`` or the train step moves them to the card.
torchvision is optional: with it, ``setup_data_loaders`` wraps ImageFolder
(the original repository's ImageNet loaders); without it, the loaders built
from arrays or directories of clips keep everything runnable.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

logger = logging.getLogger("vats_tpu_torch.data")

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def normalize_images(images: np.ndarray) -> np.ndarray:
    """[B, C, H, W] uint8/float in [0,255] or [0,1] -> ImageNet-normalized."""
    x = images.astype(np.float32)
    if x.max() > 1.5:
        x = x / 255.0
    return (x - IMAGENET_MEAN[None, :, None, None]) / IMAGENET_STD[
        None, :, None, None
    ]


def array_batches(
    images: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    normalize: bool = True,
    epochs: Optional[int] = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """In-memory image loader yielding {'images', 'labels'} numpy batches."""
    rng = np.random.RandomState(seed)
    epoch = 0
    n = len(images)
    while epochs is None or epoch < epochs:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for start in range(0, n, batch_size):
            idx = order[start : start + batch_size]
            if drop_last and len(idx) < batch_size:
                break
            batch_images = images[idx]
            if normalize:
                batch_images = normalize_images(batch_images)
            yield {"images": batch_images, "labels": labels[idx]}
        epoch += 1


def setup_data_loaders(
    train_dir: str = "/data/imagenet1k/train",
    val_dir: str = "/data/imagenet1k/val",
    batch_size: int = 256,
    *,
    image_size: int = 256,
    num_workers: int = 8,
    color_jitter: float = 0.4,
    random_rotation_degrees: float = 15.0,
    auto_augment: bool = True,
    random_erasing_prob: float = 0.4,
    raw_images: bool = False,
) -> Tuple[Iterator, Iterator]:
    """ImageFolder-backed loaders (the original repository's ImageNet
    loaders).

    Heavy geometric/photometric train augmentation stays on the host via
    torchvision when available; mixup/cutmix run on device.  Raises a clear
    error when torchvision or the data directories are missing.

    The photometric knobs mirror ``VisionTrainingArgs``; pass them through so
    config changes take effect.  ``raw_images=True`` emits crop+flip-only
    [0, 1] train batches for the on-device battery
    (``VisionTrainingArgs.pixel_augs_on_device`` — which REQUIRES this mode;
    pairing a host-augmented loader with on-device augs would double-augment
    and double-normalize).  Val batches stay normalized in both modes (the
    eval step applies the model directly).
    """
    try:
        import torch
        from torch.utils.data import DataLoader
        from torchvision import datasets, transforms
    except Exception as exc:  # pragma: no cover - optional dependency
        raise RuntimeError(
            "torchvision is required for ImageFolder loading"
        ) from exc
    for d in (train_dir, val_dir):
        if not os.path.isdir(d):
            raise FileNotFoundError(f"dataset directory not found: {d}")

    if raw_images:
        # geometric crop/flip only; photometrics + normalize + erase run on
        # the card inside the train step (train/vision.py)
        train_tf = transforms.Compose(
            [
                transforms.RandomResizedCrop(image_size, scale=(0.2, 1.0)),
                transforms.RandomHorizontalFlip(p=0.5),
                transforms.ToTensor(),
            ]
        )
    else:
        # the original repository's full battery; normalize + erase
        # happen here, so wrap() must not re-normalize train batches
        ops = [
            transforms.RandomResizedCrop(image_size, scale=(0.2, 1.0)),
            transforms.RandomHorizontalFlip(p=0.5),
        ]
        if color_jitter > 0:
            ops.append(transforms.ColorJitter(
                color_jitter, color_jitter, color_jitter, hue=0.1
            ))
        if random_rotation_degrees > 0:
            ops.append(transforms.RandomRotation(
                degrees=random_rotation_degrees
            ))
        if auto_augment:
            ops.append(transforms.AutoAugment(
                transforms.AutoAugmentPolicy.IMAGENET
            ))
        ops += [
            transforms.ToTensor(),
            transforms.Normalize(mean=tuple(IMAGENET_MEAN),
                                 std=tuple(IMAGENET_STD)),
        ]
        if random_erasing_prob > 0:
            ops.append(transforms.RandomErasing(
                p=random_erasing_prob, scale=(0.02, 0.33), ratio=(0.3, 3.3)
            ))
        train_tf = transforms.Compose(ops)
    val_tf = transforms.Compose(
        [transforms.Resize(int(image_size * 1.14)),
         transforms.CenterCrop(image_size),
         transforms.ToTensor(),
         transforms.Normalize(mean=tuple(IMAGENET_MEAN),
                              std=tuple(IMAGENET_STD))]
    )

    def wrap(loader):
        for images, labels in loader:
            yield {
                "images": images.numpy(),
                "labels": labels.numpy().astype(np.int32),
            }

    train_loader = DataLoader(
        datasets.ImageFolder(train_dir, train_tf),
        batch_size=batch_size,
        shuffle=True,
        num_workers=num_workers,
        drop_last=True,
    )
    val_loader = DataLoader(
        datasets.ImageFolder(val_dir, val_tf),
        batch_size=batch_size,
        shuffle=False,
        num_workers=num_workers,
    )
    return wrap(train_loader), wrap(val_loader)


def setup_video_loaders(
    clips_dir: str,
    batch_size: int,
    *,
    num_frames: Optional[int] = None,
    image_size: Optional[int] = None,
    stride: int = 1,
    shuffle: bool = True,
    seed: int = 0,
    epochs: Optional[int] = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Video clip loader with a real decode path (the original repository's
    is a stub).

    Two dataset layouts:

      * class directories — ``<root>/<class>/<video>`` where each video is
        an ``.avi`` (MJPEG), ``.y4m``, ``.npy`` clip or a directory of
        per-frame images (see :mod:`vats_tpu_torch.data.video_decode`); labels are
        the sorted class-directory indices.  Requires ``num_frames`` and
        ``image_size`` (clips are temporally sampled + centred/cropped to a
        common shape).
      * flat legacy — ``<name>_<label>.npy`` clips shaped [C, T, H, W];
        clips in a batch must share shapes (bucket upstream).
    """
    entries = sorted(os.listdir(clips_dir))
    class_dirs = [
        e for e in entries if os.path.isdir(os.path.join(clips_dir, e))
    ]
    rng = np.random.RandomState(seed)

    if class_dirs:
        from vats_tpu_torch.data.video_decode import load_clip

        if num_frames is None or image_size is None:
            raise ValueError(
                "class-directory video datasets need num_frames + image_size"
            )
        sources: list = []  # (path, label)
        for label, cls in enumerate(class_dirs):
            cdir = os.path.join(clips_dir, cls)
            for name in sorted(os.listdir(cdir)):
                sources.append((os.path.join(cdir, name), label))
        if not sources:
            raise FileNotFoundError(f"no videos under {clips_dir}")

        def make_batch(idx):
            clips = [
                load_clip(
                    sources[int(i)][0],
                    num_frames=num_frames,
                    image_size=image_size,
                    stride=stride,
                    random_sample=shuffle,
                    rng=rng,
                )
                for i in idx
            ]
            labels = [sources[int(i)][1] for i in idx]
            return clips, labels

        n = len(sources)
    else:
        files = [f for f in entries if f.endswith(".npy")]
        if not files:
            raise FileNotFoundError(f"no .npy clips in {clips_dir}")

        def make_batch(idx):
            clips, labels = [], []
            for i in idx:
                name = files[int(i)]
                clips.append(np.load(os.path.join(clips_dir, name)))
                stem = os.path.splitext(name)[0]
                labels.append(int(stem.rsplit("_", 1)[-1]))
            return clips, labels

        n = len(files)

    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for start in range(0, len(order), batch_size):
            idx = order[start : start + batch_size]
            if len(idx) < batch_size:
                break
            clips, labels = make_batch(idx)
            yield {
                "videos": np.stack(clips).astype(np.float32),
                "labels": np.asarray(labels, dtype=np.int32),
            }
        epoch += 1
