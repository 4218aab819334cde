"""Text->video generation training entry point.

The port's counterpart of ``scripts/video_gen/train.py``, with the same
flags, data and loop at ``video_gen_tiny_test``: ``--phase vqvae`` trains the
3-D VQ-VAE on random clips (``VQVAE3DTrainer``), ``--phase transformer``
the AR transformer's next-token CE on random codebook indices with random
text embeddings (8 a row; ``VideoTokenTrainer``), ``--phase both`` one after
the other; the data are drawn once from ``numpy.random.RandomState(seed)``
in that order, and every step trains on the same batch, as in JAX.  As
there, ``--seed`` seeds the data only: both trainers start from the weights
of ``VideoGenTrainingArgs()``'s own seed.

    python -m vats_tpu_torch.scripts.video_gen.train --device cpu --steps 3

Runs on the card unless ``--device cpu`` is given.  It logs every tenth
step to stderr, and to ``<--log-dir>/training.log`` only when ``--log-dir``
is given; it writes nothing else.  :func:`main` takes the arguments as a list and returns the
trainers, each phase's losses and each step's wall seconds.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train the text->video generation stack")
    p.add_argument("--phase", default="both", choices=["vqvae", "transformer", "both"])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log-dir", default=None,
                   help="also write training.log here (default: stderr only)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    from vats_tpu_torch.configs.video_gen import video_gen_tiny_test
    from vats_tpu_torch.device import resolve_device
    from vats_tpu_torch.scripts.nlp.train import _close_handlers, _logger
    from vats_tpu_torch.train.video_gen import (
        VideoGenTrainingArgs,
        VideoTokenTrainer,
        VQVAE3DTrainer,
    )

    device = resolve_device(args.device)
    if args.log_dir:
        logger = _logger(args.log_dir)
    else:
        logger = logging.getLogger("video_gen_training")
        _close_handlers(logger)
        logger.setLevel(logging.INFO)
        logger.addHandler(logging.StreamHandler())
    try:
        cfg = video_gen_tiny_test()
        targs = VideoGenTrainingArgs()
        rng = np.random.RandomState(args.seed)
        pt, ph, pw = cfg.patch_size
        videos = torch.from_numpy(rng.rand(
            args.batch_size, cfg.C_in_out, cfg.max_frames, cfg.latent_height * ph,
            cfg.latent_width * pw).astype(np.float32)).to(device)
        out: Dict[str, Any] = {"cfg": cfg}

        def run(name, trainer, batch, label):
            losses, walls = [], []
            for step in range(args.steps):
                t0 = time.perf_counter()
                losses.append(trainer.train_step(batch))
                walls.append(time.perf_counter() - t0)
                if step % 10 == 0:
                    logger.info("%s step %d %s=%.4f", name, step, label, losses[-1])
            out[name] = {"trainer": trainer, "losses": losses, "step_s": walls}

        if args.phase in ("vqvae", "both"):
            run("vqvae", VQVAE3DTrainer(cfg, targs, num_training_steps=args.steps,
                                        device=device), videos, "loss")
        if args.phase in ("transformer", "both"):
            lat_t = cfg.max_frames // pt
            batch = {
                "indices": torch.from_numpy(rng.randint(
                    0, cfg.num_embeddings,
                    (args.batch_size, lat_t, cfg.latent_height, cfg.latent_width))).to(device),
                "text_embeddings": torch.from_numpy(
                    rng.randn(args.batch_size, 8, cfg.d_model).astype(np.float32)).to(device),
            }
            run("transformer", VideoTokenTrainer(cfg, targs, num_training_steps=args.steps,
                                                 device=device), batch, "ce")
        logger.info("done")
        return out
    finally:
        _close_handlers(logger)


if __name__ == "__main__":
    main()
