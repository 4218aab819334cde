"""The epoch loop the two vision scripts share.

``scripts/vision/vit2d/train.py`` and ``vit3d/train.py`` of the JAX package
run the same loop: per epoch a fresh train and validation iterator,
``train_epoch``, ``validate_epoch``, one log line, the history and
``CheckpointManager.maybe_save``; a plot of the history at the end.  The
JAX scripts write the plot into the working directory; here it goes into
``--ckpt-dir``, beside the checkpoints and ``logs/training.log``.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterable, List, Tuple

import torch

from vats_tpu_torch.scripts.nlp.train import _close_handlers, _logger


def run_epochs(
    *,
    model,
    cfg,
    targs,
    args,
    num_classes: int,
    data: Callable[[int], Tuple[Iterable, Iterable]],
    history_keys: List[str],
    force_regular: Callable[[int], bool],
    plot_name: str,
    title: str,
) -> Dict[str, Any]:
    """Train ``model`` for ``args.epochs`` epochs on ``data(seed)`` (a
    train and a validation iterator a call, at seed ``args.seed + epoch``)
    and return the state, the model and the history."""
    from vats_tpu_torch.checkpoint import CheckpointManager
    from vats_tpu_torch.train import create_train_state
    from vats_tpu_torch.train.vision import (
        create_vision_optimizer,
        make_vision_eval_step,
        make_vision_train_step,
        train_epoch,
        validate_epoch,
    )
    from vats_tpu_torch.utils import plot_metrics

    os.makedirs(args.ckpt_dir, exist_ok=True)
    logger = _logger(os.path.join(args.ckpt_dir, "logs"))
    try:
        state = create_train_state(model, create_vision_optimizer(targs, args.steps_per_epoch))
        step_fn = make_vision_train_step(model, targs, num_classes)
        eval_fn = make_vision_eval_step(model, num_classes)
        ckpt = CheckpointManager(args.ckpt_dir, model_args=cfg, training_args=targs)
        history: Dict[str, List[float]] = {k: [] for k in history_keys}
        # one seed an epoch, as the JAX script splits its key
        epoch_seeds = torch.Generator().manual_seed(args.seed + 1)
        saves = []
        for epoch in range(args.epochs):
            erng = int(torch.randint(0, 1 << 62, (1,), generator=epoch_seeds))
            train_it, val_it = data(args.seed + epoch)
            state, tm = train_epoch(model, state, train_it, targs, rng=erng,
                                    num_classes=num_classes, train_step_fn=step_fn)
            vm = validate_epoch(model, state, val_it, num_classes=num_classes,
                                eval_step_fn=eval_fn)
            logger.info("epoch %d/%d loss=%.4f acc=%.2f%% val_loss=%.4f val_acc=%.2f%%",
                        epoch + 1, args.epochs, tm["epoch_loss"], tm["epoch_acc"],
                        vm["val_loss"], vm["val_acc"])
            values = {"train_loss": tm["epoch_loss"], "train_acc": tm["epoch_acc"],
                      "val_loss": vm["val_loss"], "val_acc": vm["val_acc"]}
            for k in history_keys:
                history[k].append(values[k])
            saves.append(ckpt.maybe_save(state, vm["val_loss"],
                                         force_regular=force_regular(epoch)))
        plot = plot_metrics(history, os.path.join(args.ckpt_dir, plot_name), title=title)
        logger.info("done: %d epochs", args.epochs)
        return {"state": state, "model": model, "cfg": cfg, "training_args": targs,
                "history": history, "saves": saves, "plot": plot}
    finally:
        _close_handlers(logger)
