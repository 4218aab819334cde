"""MoE text-LM training entry point.

The port's counterpart of ``scripts/nlp/train.py``, with the same CLI and
loop: a size tier, synthetic or HuggingFace text data (90/10 split), a
token-budget loop that validates every ``--eval-every-steps`` steps (at most
20 batches), saves a best checkpoint on improvement and a regular one every
time, stops early after ``--early-stop-patience`` stale evaluations, and
logs a sample generation when there is a tokenizer.  ``--resume`` restores
the model args from the checkpoint's metadata first, then the train state.

    python -m vats_tpu_torch.scripts.nlp.train --size xsmall --device cpu \\
        --batch-size 2 --seq-len 32 --eval-every-steps 4 \\
        --max-train-tokens 512 --ckpt-dir /tmp/ckpt

Runs on the card unless ``--device cpu`` is given; there is no environment
switch to the CPU.  Checkpoints, their ``.meta.json``, the log
(``logs/training.log``) and the metrics plot all go into ``--ckpt-dir``.

Sharded training: ``--mesh data=2,fsdp=2`` (axes of ``parallel.create_mesh``,
``fsdp=-1`` by default) trains through ``parallel.sharded.make_sharded_train``
over the ranks of a ``torch.distributed`` world, which ``--multihost``
joins first (``--coordinator`` / ``--num-processes`` / ``--process-id`` or
COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID, and ``--backend``, the
caller's choice: 'nccl' with a GPU a rank, 'gloo' for CPU processes or
ranks sharing a GPU); without it this process must already belong to one.
``--batch-size`` is the global batch: every rank reads the same seeded
batch stream and the step keeps the rank's block.  Rank 0 logs, plots and
writes the (whole) checkpoints; ``--resume`` loads each rank's blocks.

:func:`main` takes the arguments as a list and returns the final state,
the model, the loss history and, per evaluation round, the walls of the
steps, the validation and each save.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Any, Dict, List, Optional

import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train the MoE text LM")
    p.add_argument("--size", default="xsmall",
                   choices=["xsmall", "small", "medium", "large", "xlarge"])
    p.add_argument("--dataset", default="synthetic",
                   help="'synthetic' or a HF dataset name (needs network)")
    p.add_argument("--tokenizer", default="mistralai/Mistral-7B-v0.1")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=None)
    p.add_argument("--max-train-tokens", type=int, default=5_000_000)
    p.add_argument("--eval-every-steps", type=int, default=200)
    p.add_argument("--ckpt-dir", default="checkpoints/nlp")
    p.add_argument("--resume", default=None,
                   help="checkpoint path to resume from (model args are "
                        "restored from its metadata)")
    p.add_argument("--early-stop-patience", type=int, default=5)
    p.add_argument("--sample-prompt", default="Once upon a time, ")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--fused-ce-chunk", type=int, default=None,
                   help="fused readout+cross-entropy chunk size (avoids the "
                        "[B, T, V] logits buffer; try 128)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a card) or 'cpu'")
    p.add_argument("--mesh", default=None,
                   help="comma-separated mesh axes 'data=2,fsdp=4,tensor=1': sharded "
                        "training over the world's ranks; -1 absorbs the rest "
                        "(e.g. 'fsdp=-1')")
    p.add_argument("--multihost", action="store_true",
                   help="join this process to a torch.distributed world first "
                        "(--coordinator/--num-processes/--process-id or "
                        "COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID); --batch-size "
                        "is the GLOBAL batch")
    p.add_argument("--coordinator", default=None,
                   help="coordinator address host:port or an init URL (--multihost)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="the process group's backend (--multihost): 'nccl' with a GPU "
                        "a rank, 'gloo' for CPU processes or ranks sharing a GPU")
    return p.parse_args(argv)


def parse_mesh_arg(spec: str) -> Dict[str, int]:
    """'data=2,fsdp=-1' -> {'data': 2, 'fsdp': -1}."""
    axes = {}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        axes[k.strip()] = int(v)
    return axes


def _logger(log_dir: str) -> logging.Logger:
    """The 'training' logger writing to ``log_dir/training.log`` (and
    stderr), with the handlers of an earlier run in this process closed."""
    from vats_tpu_torch.utils import setup_logger

    _close_handlers(logging.getLogger("training"))
    return setup_logger("training", log_dir=log_dir)


def _close_handlers(logger: logging.Logger) -> None:
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    mesh = None
    if args.mesh or args.multihost:
        from vats_tpu_torch.parallel import create_mesh
        from vats_tpu_torch.parallel.multihost import initialize_multihost

        if args.multihost:
            initialize_multihost(args.coordinator, args.num_processes, args.process_id,
                                 backend=args.backend)
        mesh = create_mesh(**(parse_mesh_arg(args.mesh) if args.mesh else {"fsdp": -1}))
    from vats_tpu_torch.parallel.multihost import is_coordinator
    from vats_tpu_torch.checkpoint import CheckpointManager, load_checkpoint
    from vats_tpu_torch.configs import GenerationArgs, ModelArgs, TrainingArgs
    from vats_tpu_torch.configs.nlp import NLP_TIERS
    from vats_tpu_torch.data import device_batches, synthetic_lm_batches
    from vats_tpu_torch.device import resolve_device
    from vats_tpu_torch.models import TextLM
    from vats_tpu_torch.train import (
        create_optimizer,
        create_train_state,
        make_eval_step,
        make_train_step,
        train,
        validate,
    )
    from vats_tpu_torch.utils import plot_metrics

    device = resolve_device(args.device)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    writer = is_coordinator()
    logger = (_logger(os.path.join(args.ckpt_dir, "logs")) if writer
              else logging.getLogger("training.rank"))
    try:
        model_args = NLP_TIERS[args.size]()
        if args.resume:
            # args first (the args-only load), the state below
            _, resume_meta = load_checkpoint(args.resume)
            if resume_meta.get("model_args"):
                model_args = ModelArgs.from_dict(resume_meta["model_args"])
                logger.info("resumed model args from %s", args.resume)
        training_args = TrainingArgs(
            batch_size=args.batch_size, max_train_tokens=args.max_train_tokens,
            fused_ce_chunk=args.fused_ce_chunk,
        )
        seq_len = args.seq_len or min(model_args.max_seq_len, 512)

        logger.info("model: %s | %s", args.size, model_args)
        model = TextLM(model_args, device=device, seed=args.seed)

        tokenizer = None
        if args.dataset == "synthetic":
            def make_iter(seed):
                return synthetic_lm_batches(
                    torch.Generator(device=device).manual_seed(seed),
                    vocab_size=model_args.vocab_size,
                    batch_size=args.batch_size,
                    seq_len=seq_len,
                    pad_fraction=0.1,
                )
            train_iter = make_iter(args.seed)

            def val_iter():
                return make_iter(args.seed + 1)
        else:
            from transformers import AutoTokenizer

            from vats_tpu_torch.data.text_cleaning import (
                DeduplicationFilter,
                TextQualityFilter,
            )
            from vats_tpu_torch.data.text_dataset import TextDataset, train_val_split

            tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
            if tokenizer.pad_token_id is None:
                tokenizer.pad_token = tokenizer.eos_token
            quality = TextQualityFilter()
            dedup = DeduplicationFilter()
            dataset = TextDataset.from_hf_streaming(
                args.dataset, tokenizer, seq_len,
                filters=[quality.filter_text,
                         lambda t: None if dedup.is_duplicate(t) else t],
            )
            train_ds, val_ds = train_val_split(dataset)
            train_iter = device_batches(
                train_ds.batches(args.batch_size, epochs=None, seed=args.seed), device)

            def val_iter():
                return device_batches(
                    val_ds.batches(args.batch_size, epochs=1, shuffle=False), device)

        est_steps = max(1, args.max_train_tokens // (args.batch_size * seq_len))
        if mesh is not None:
            import itertools

            from vats_tpu_torch.parallel.sharded import make_sharded_train

            logger.info("mesh: %s", mesh.shape)
            sample = next(train_iter)
            train_iter = itertools.chain([sample], train_iter)
            init_fn, step_fn, _ = make_sharded_train(
                model, training_args, mesh, sample, num_training_steps=est_steps)
            state = init_fn()
        else:
            state = create_train_state(model, create_optimizer(training_args, est_steps))
            step_fn = make_train_step(model, training_args)
        if args.resume:
            state, _ = load_checkpoint(args.resume, target=state)
            logger.info("resumed state: tokens_seen=%d", int(state.tokens_seen))
        ckpt = CheckpointManager(args.ckpt_dir, model_args=model_args,
                                 training_args=training_args)
        # one eval step for the run: its graphs (one a batch shape) replay
        # in every round's validation
        eval_fn = make_eval_step(model, training_args)

        # one dropout seed per round, as the JAX script splits its key
        round_seeds = torch.Generator().manual_seed(args.seed + 2)
        bad_evals = 0
        history = {"train_loss": [], "val_loss": [], "val_ppl": []}
        rounds = []
        while int(state.tokens_seen) < args.max_train_tokens:
            loop_rng = int(torch.randint(0, 1 << 62, (1,), generator=round_seeds))
            state, summary = train(
                model, state, train_iter, training_args, rng=loop_rng,
                max_steps=args.eval_every_steps, train_step_fn=step_fn,
                log_every=max(1, args.eval_every_steps // 4),
            )
            t0 = time.perf_counter()
            metrics = validate(model, state, val_iter(), training_args,
                               eval_step_fn=eval_fn, max_batches=20)
            validate_s = time.perf_counter() - t0
            logger.info(
                "tokens=%d train_loss=%.4f val_loss=%.4f val_ppl=%.2f",
                summary["tokens_seen"], summary["avg_loss"],
                metrics["val_loss"], metrics["val_perplexity"],
            )
            history["train_loss"].append(summary["avg_loss"])
            history["val_loss"].append(metrics["val_loss"])
            history["val_ppl"].append(metrics["val_perplexity"])
            t0 = time.perf_counter()
            saved = ckpt.maybe_save(state, metrics["val_loss"], force_regular=True)
            rounds.append(dict(steps=summary["steps"], tokens_seen=summary["tokens_seen"],
                               train_s=summary["wall_time_s"], validate_s=validate_s,
                               val_batches=metrics["batches"],
                               save_s=time.perf_counter() - t0, saved=saved))
            bad_evals = 0 if saved["best"] else bad_evals + 1
            if bad_evals >= args.early_stop_patience:
                logger.info("early stopping after %d stale evals", bad_evals)
                break
            if summary["steps"] == 0:
                break

            if tokenizer is not None:
                from vats_tpu_torch.inference import TokenGenerator
                from vats_tpu_torch.parallel.layout import whole_state_dict

                params = whole_state_dict(model)  # every rank gathers
                if not writer:
                    continue
                gen = TokenGenerator(model_args, params=params, device=device)
                sample = gen.generate_tokens(
                    args.sample_prompt, GenerationArgs(max_new_tokens=48), tokenizer)
                logger.info("sample: %s", sample)

        if writer:
            plot_metrics(history, os.path.join(args.ckpt_dir, "nlp_training_metrics.png"),
                         title="MoE Text LM")
        logger.info("done: tokens_seen=%d", int(state.tokens_seen))
        return {"state": state, "model": model, "model_args": model_args,
                "training_args": training_args, "history": history, "rounds": rounds}
    finally:
        _close_handlers(logger)


if __name__ == "__main__":
    main()
