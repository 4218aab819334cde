"""ViT-3D video classification training entry point.

The port's counterpart of ``scripts/vision/vit3d/train.py``, with the same
flags and loop: a size tier with its classifier head, a directory of clips
(``--clips-dir``, read by ``setup_video_loaders``) or synthetic clips of
``--frames`` frames, no augmentation, and per epoch ``train_epoch``,
``validate_epoch`` and ``CheckpointManager.maybe_save`` with a regular
save every epoch.

    python -m vats_tpu_torch.scripts.vision.vit3d.train --device cpu \\
        --epochs 1 --steps-per-epoch 2 --batch-size 2 --ckpt-dir /tmp/vit3d

Runs on the card unless ``--device cpu`` is given.  Checkpoints, the log
(``logs/training.log``) and ``vit3d_training_metrics.png`` all go into
``--ckpt-dir``.  :func:`main` takes the arguments as a list and returns the
final state, the model and the history.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

import numpy as np


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train ViT-3D")
    p.add_argument("--size", default="tiny", choices=["tiny", "xsmall", "large"])
    p.add_argument("--clips-dir", default=None)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--steps-per-epoch", type=int, default=10)
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--ckpt-dir", default="checkpoints/vit3d")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    from vats_tpu_torch.configs.vit3d import vit3d_large, vit3d_tiny_test, vit3d_xsmall
    from vats_tpu_torch.data.vision_data import setup_video_loaders
    from vats_tpu_torch.device import resolve_device
    from vats_tpu_torch.models import VideoTransformer
    from vats_tpu_torch.scripts.vision.common import run_epochs
    from vats_tpu_torch.train.vision import VisionTrainingArgs

    device = resolve_device(args.device)
    tiers = {"tiny": vit3d_tiny_test, "xsmall": vit3d_xsmall, "large": vit3d_large}
    cfg = tiers[args.size](use_classifier_head=True)
    frames = args.frames or cfg.max_frames
    targs = VisionTrainingArgs(epochs=args.epochs, batch_size=args.batch_size,
                               warmup_epochs=max(1, args.epochs // 10),
                               use_augmentation=False)
    model = VideoTransformer(cfg, device=device, seed=args.seed)

    def synthetic_batches(seed):
        rng = np.random.RandomState(seed)
        th, tw = cfg.target_size
        for _ in range(args.steps_per_epoch):
            yield {
                "images": rng.rand(args.batch_size, cfg.C_in, frames, th, tw
                                   ).astype(np.float32),
                "labels": rng.randint(0, cfg.num_classes, args.batch_size),
            }

    def data(seed):
        if args.clips_dir:
            def remap(it):
                for b in it:
                    yield {"images": b["videos"], "labels": b["labels"]}
            return (
                remap(setup_video_loaders(args.clips_dir, args.batch_size, seed=seed)),
                remap(setup_video_loaders(args.clips_dir, args.batch_size,
                                          shuffle=False, seed=seed)),
            )
        return synthetic_batches(seed), synthetic_batches(seed)

    return run_epochs(
        model=model, cfg=cfg, targs=targs, args=args, num_classes=cfg.num_classes,
        data=data, history_keys=["train_loss", "val_loss", "val_acc"],
        force_regular=lambda epoch: True,
        plot_name="vit3d_training_metrics.png", title="ViT-3D",
    )


if __name__ == "__main__":
    main()
