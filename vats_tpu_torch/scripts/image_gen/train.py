"""Text->image generation training entry point.

The port's counterpart of ``scripts/image_gen/train.py``, with the same
flags and loop: a size tier (``tiny`` or ``xsmall``), a text encoder drawn
from ``--seed``, and ``--steps`` steps of ``ImageGenTrainer`` (VQ +
reconstruction + token CE) on synthetic batches: random images at the
config's target size and random text ids (8 a row) encoded by the text
encoder, batch ``i`` drawn from ``numpy.random.RandomState(seed + i)``.

    python -m vats_tpu_torch.scripts.image_gen.train --device cpu --steps 3 \\
        --log-every 1

Runs on the card unless ``--device cpu`` is given.  It logs to stderr, and
to ``<--log-dir>/training.log`` only when ``--log-dir`` is given; it writes
nothing else.  :func:`main` takes the arguments as a list and returns the
trainer, every step's metrics and every step's wall seconds.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train the text->image VQ-VAE stack")
    p.add_argument("--size", default="tiny", choices=["tiny", "xsmall"])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log-dir", default=None,
                   help="also write training.log here (default: stderr only)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    from vats_tpu_torch.configs.image_gen import image_gen_tiny_test, image_gen_xsmall
    from vats_tpu_torch.device import resolve_device
    from vats_tpu_torch.models import TransformerTextEncoder
    from vats_tpu_torch.scripts.nlp.train import _close_handlers, _logger
    from vats_tpu_torch.train.image_gen import ImageGenTrainer, ImageGenTrainingArgs

    device = resolve_device(args.device)
    if args.log_dir:
        logger = _logger(args.log_dir)
    else:
        logger = logging.getLogger("image_gen_training")
        _close_handlers(logger)
        logger.setLevel(logging.INFO)
        logger.addHandler(logging.StreamHandler())
    try:
        cfg = (image_gen_tiny_test if args.size == "tiny" else image_gen_xsmall)()
        text_encoder = TransformerTextEncoder(cfg, device=device, seed=args.seed).eval()

        @torch.no_grad()
        def make_batch(step):
            r = np.random.RandomState(args.seed + step)
            images = torch.from_numpy(
                r.rand(args.batch_size, cfg.C_in_out, cfg.target_size, cfg.target_size)
                .astype(np.float32)).to(device)
            ids = torch.from_numpy(r.randint(1, cfg.vocab_size, (args.batch_size, 8))).to(device)
            return {"images": images, "text_embeddings": text_encoder(ids)}

        trainer = ImageGenTrainer(cfg, ImageGenTrainingArgs(seed=args.seed),
                                  num_training_steps=args.steps, device=device)
        history, walls = [], []
        for step in range(args.steps):
            t0 = time.perf_counter()
            metrics = trainer.train_step(make_batch(step))
            walls.append(time.perf_counter() - t0)
            history.append(metrics)
            if step % args.log_every == 0:
                logger.info("step %d: %s", step,
                            {k: round(v, 4) for k, v in metrics.items()})
        logger.info("done")
        return {"trainer": trainer, "cfg": cfg, "history": history, "step_s": walls}
    finally:
        _close_handlers(logger)


if __name__ == "__main__":
    main()
