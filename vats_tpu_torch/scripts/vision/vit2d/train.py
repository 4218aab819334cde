"""ViT-2D classification training entry point.

The port's counterpart of ``scripts/vision/vit2d/train.py``, with the same
flags and loop: a size tier with a ``--num-classes`` head, an ImageFolder
root (``--data-dir``, with ``train/`` and ``val/``) or synthetic images,
and per epoch ``train_epoch``, ``validate_epoch`` and
``CheckpointManager.maybe_save`` (a regular save every
``save_checkpoint_freq`` epochs).

    python -m vats_tpu_torch.scripts.vision.vit2d.train --device cpu \\
        --epochs 1 --steps-per-epoch 2 --batch-size 2 --ckpt-dir /tmp/vit2d

Runs on the card unless ``--device cpu`` is given.  Checkpoints, the log
(``logs/training.log``) and ``vit2d_training_metrics.png`` all go into
``--ckpt-dir``.  :func:`main` takes the arguments as a list and returns the
final state, the model and the history.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

import numpy as np


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train ViT-2D")
    p.add_argument("--size", default="xsmall", choices=["xsmall", "small", "medium"])
    p.add_argument("--data-dir", default=None, help="ImageFolder root; synthetic if unset")
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--steps-per-epoch", type=int, default=20)
    p.add_argument("--ckpt-dir", default="checkpoints/vit2d")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    from vats_tpu_torch.configs.vit2d import vit2d_medium, vit2d_small, vit2d_xsmall
    from vats_tpu_torch.data.vision_data import array_batches, setup_data_loaders
    from vats_tpu_torch.device import resolve_device
    from vats_tpu_torch.models import ImageEncoder
    from vats_tpu_torch.scripts.vision.common import run_epochs
    from vats_tpu_torch.train.vision import VisionTrainingArgs

    device = resolve_device(args.device)
    tiers = {"xsmall": vit2d_xsmall, "small": vit2d_small, "medium": vit2d_medium}
    cfg = tiers[args.size](num_classes=args.num_classes)
    targs = VisionTrainingArgs(epochs=args.epochs, batch_size=args.batch_size,
                               warmup_epochs=max(1, args.epochs // 10))
    model = ImageEncoder(cfg, device=device, seed=args.seed)

    def data(split_seed):
        if args.data_dir:
            return setup_data_loaders(
                f"{args.data_dir}/train", f"{args.data_dir}/val", args.batch_size,
                image_size=cfg.target_size, color_jitter=targs.color_jitter,
                random_rotation_degrees=targs.random_rotation_degrees,
                auto_augment=targs.auto_augment,
                random_erasing_prob=targs.random_erasing_prob,
                raw_images=targs.pixel_augs_on_device,
            )
        rng = np.random.RandomState(split_seed)
        n = args.batch_size * args.steps_per_epoch
        images = rng.rand(n, cfg.C_in, cfg.target_size, cfg.target_size)
        labels = rng.randint(0, args.num_classes, n)
        return (
            array_batches(images, labels, args.batch_size, seed=split_seed),
            array_batches(images[: 4 * args.batch_size], labels[: 4 * args.batch_size],
                          args.batch_size, shuffle=False, seed=split_seed),
        )

    return run_epochs(
        model=model, cfg=cfg, targs=targs, args=args, num_classes=args.num_classes,
        data=data, history_keys=["train_loss", "val_loss", "train_acc", "val_acc"],
        force_regular=lambda epoch: (epoch + 1) % targs.save_checkpoint_freq == 0,
        plot_name="vit2d_training_metrics.png", title="ViT-2D",
    )


if __name__ == "__main__":
    main()
