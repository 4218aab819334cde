"""Vision training: the epoch-level warmup-cosine schedule and the
mixed-label cross-entropy steps.

Counterpart of ``vats_tpu/train/vision.py``.  One train step does the
augmentation where the images are (mixup / cutmix, and with
``pixel_augs_on_device`` the rotation, AutoAugment, normalization and
erasing battery on raw [0, 1] images), the forward with dropout, the
mixed-label smoothed cross-entropy, the backward and the (accumulated)
optimizer update.  Both steps replay a CUDA graph per key on the card, as
the JAX package jits them (the train step one per batch shape and position
in the accumulation window, :func:`make_vision_train_step`; the eval step
one per batch shape, :func:`make_vision_eval_step`), and run the same body
eagerly on the CPU.  The step's ``rng`` is an int seed, copied into the
graph's static seed: the dropout masks and the pixel battery's uniforms are
functions of it on the device (``nn/dropout.py``), and the mixup / cutmix
draws come from a host generator seeded from it and enter as static inputs
(not JAX's bits; the packages agree given the same draws, and with dropout
0).

The optimizer is optax's chain, written out: ``clip_by_global_norm`` (the
plain clip: no skip on a non-finite norm) -> ``adamw`` on the epoch
schedule -> ``MultiSteps`` when ``grad_accum_steps > 1``.  The schedule is
read at the count of AdamW's applied updates, as optax counts it, so
``steps_per_epoch`` is in applied updates.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

from vats_tpu_torch.data.augmentations import augment_given, draw_augmentation
from vats_tpu_torch.data.vision_data import IMAGENET_MEAN, IMAGENET_STD
from vats_tpu_torch.nn.dropout import Seed, host_seed, uniform
from vats_tpu_torch.train.optimizer import (
    AdamW,
    ClipByGlobalNorm,
    MultiSteps,
    find_grad_norm,
    global_norm,
)
from vats_tpu_torch.train.state import TrainState
from vats_tpu_torch.train.step_graphs import (
    TrainGraphs,
    accumulation_position,
    advance_accumulation,
    capturable,
    clone_outputs,
    scalar_outputs,
    set_accumulation_position,
    state_tensors,
    static_like,
    write_outputs,
    zero_grads,
)

Batch = Dict[str, torch.Tensor]
#: (layer, site) streams of a step's seed beside the dropout masks' (which
#: use layers >= -1): the mixup / cutmix draws (a host generator) and the
#: pixel battery's uniforms (on the device)
_STREAM_LAYER, _STREAM_MIX, _STREAM_PIXELS = -2, 1, 2


@dataclass
class VisionTrainingArgs:
    """The original repository's ViT-2D training arguments, with the JAX
    package's battery knobs (``pixel_augs_on_device`` needs raw [0, 1]
    batches; ``color_jitter`` is host-only)."""

    learning_rate: float = 2e-4
    epochs: int = 300
    batch_size: int = 256
    epsilon: float = 1e-6
    max_norm: float = 1.0
    weight_decay: float = 5e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    warmup_epochs: int = 50
    eta_min: float = 6e-7
    save_checkpoint_freq: int = 1
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 0.8
    label_smoothing: float = 0.1
    grad_accum_steps: int = 4
    use_augmentation: bool = True
    auto_augment: bool = True
    random_rotation_degrees: float = 15.0
    random_erasing_prob: float = 0.4
    color_jitter: float = 0.4
    pixel_augs_on_device: bool = False
    seed: int = 42


def warmup_cosine_epoch_schedule(
    base_lr: float,
    warmup_epochs: int,
    total_epochs: int,
    eta_min: float,
    steps_per_epoch: int,
) -> Callable:
    """The original WarmupCosineScheduler's lr_lambda, stepped per epoch:
    (epoch + 1) / warmup during warmup, then eta_min + (1 - eta_min) times
    the cosine decay; ``step`` may be an int or a device tensor."""

    def schedule(step) -> torch.Tensor:
        epoch = torch.floor(torch.as_tensor(step).to(torch.float32) / max(1, steps_per_epoch))
        warm = (epoch + 1.0) / max(1, warmup_epochs)
        progress = (epoch - warmup_epochs) / max(1, total_epochs - warmup_epochs)
        decay = eta_min + (1 - eta_min) * 0.5 * (
            1 + torch.cos(math.pi * torch.clamp(progress, 0.0, 1.0)))
        return base_lr * torch.where(epoch < warmup_epochs, warm, decay)

    return schedule


def create_vision_optimizer(args: VisionTrainingArgs, steps_per_epoch: int):
    schedule = warmup_cosine_epoch_schedule(
        args.learning_rate, args.warmup_epochs, args.epochs, args.eta_min,
        steps_per_epoch)
    tx = ClipByGlobalNorm(args.max_norm, AdamW(
        schedule, b1=args.betas[0], b2=args.betas[1], eps=args.epsilon,
        weight_decay=args.weight_decay))
    if args.grad_accum_steps > 1:
        tx = MultiSteps(tx, every_k_schedule=args.grad_accum_steps)
    return tx


def smoothed_ce(logits: torch.Tensor, targets: torch.Tensor, label_smoothing: float,
                num_classes: int) -> torch.Tensor:
    """Mean cross-entropy against one-hot targets smoothed by
    ``label_smoothing`` (fp32)."""
    onehot = F.one_hot(targets.long(), num_classes).float()
    soft = onehot * (1 - label_smoothing) + label_smoothing / num_classes
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(soft * logp).sum(dim=-1).mean()


def pixel_battery(seed: Seed, images: torch.Tensor, args: VisionTrainingArgs) -> torch.Tensor:
    """Rotation -> AutoAugment -> ImageNet normalization -> erasing on raw
    [0, 1] images, from 11 uniforms an image made from ``seed`` on the
    images' device."""
    from vats_tpu_torch.data.pixel_augs import (
        autoaugment_from_uniforms,
        device_constant,
        erasing_from_uniforms,
        rotation_from_uniforms,
    )

    u = uniform(seed, (11, images.shape[0]), layer=_STREAM_LAYER, site=_STREAM_PIXELS,
                device=images.device)
    images = rotation_from_uniforms(images, u[0], args.random_rotation_degrees)
    if args.auto_augment:
        images = autoaugment_from_uniforms(images, u[1:6])
    mean = device_constant("imagenet_mean", IMAGENET_MEAN, images.device)[None, :, None, None]
    std = device_constant("imagenet_std", IMAGENET_STD, images.device)[None, :, None, None]
    images = (images - mean) / std
    return erasing_from_uniforms(images, u[6:11], p=args.random_erasing_prob)


def _train_body(model, args: VisionTrainingArgs, num_classes: int, state: TrainState,
                images: torch.Tensor, targets: torch.Tensor, seed: Seed, draws):
    """One step on batches on the model's device: (state, metrics)."""
    if args.pixel_augs_on_device:
        images = pixel_battery(seed, images.float(), args)
    if args.use_augmentation:
        images, t_a, t_b, lam = augment_given(images, targets, draws)
    else:
        t_a = t_b = targets
        lam = torch.ones((), dtype=torch.float32, device=images.device)
    zero_grads(state.params.values())
    logits = model(images, deterministic=False, dropout_seed=seed)
    loss = (lam * smoothed_ce(logits, t_a, args.label_smoothing, num_classes)
            + (1 - lam) * smoothed_ce(logits, t_b, args.label_smoothing, num_classes))
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in state.params.items()}
    state.apply_gradients(grads)
    with torch.no_grad():
        gn = find_grad_norm(state.opt_state)
        acc = (logits.argmax(dim=-1) == t_a).float().mean()
    return state, {"loss": loss.detach(), "acc": acc, "lam": lam,
                   "grad_norm": gn if gn is not None else global_norm(grads, state.params)}


def make_vision_train_step(model, args: VisionTrainingArgs, num_classes: int) -> Callable:
    """``step(state, batch, rng) -> (state, metrics)``: augmentation, the
    training forward, mixed-label smoothed CE and the update; ``state`` is
    updated in place and returned, metrics are device tensors (loss, acc
    against targets_a, lam, grad_norm).

    On the card the step replays a CUDA graph per (batch shapes and dtypes,
    position in the accumulation window): the batch (numpy or tensors), the
    seed and the mixup / cutmix draws are copied into the key's static
    buffers, the metrics are copies of its static outputs, and each
    ``.grad`` holds the gradient of the call (one buffer a parameter,
    ``train/step_graphs.py``).  Under a mesh it runs eagerly; on the CPU
    the same body runs eagerly over the same buffers.  ``step.graphs``: its
    :class:`TrainGraphs`."""
    graphs = TrainGraphs(model.device, model)
    current = {}

    def step(state: TrainState, batch: Batch, rng: int):
        dev = model.device
        images, targets = torch.as_tensor(batch["images"]), torch.as_tensor(batch["labels"])
        draws = {}
        if args.use_augmentation:
            b, _, h, w = images.shape
            mix = torch.Generator().manual_seed(host_seed(int(rng), _STREAM_LAYER, _STREAM_MIX))
            draws = draw_augmentation(mix, b, h, w, args.mixup_alpha, args.cutmix_alpha)
        if not capturable(state.params):
            return _train_body(model, args, num_classes, state, images.to(dev),
                               targets.to(dev), int(rng),
                               {k: v.to(dev) for k, v in draws.items()})
        current["state"] = state
        pos = accumulation_position(state)
        inputs = {"images": images, "labels": targets, "seed": rng, **draws}

        def build():
            bufs = {k: static_like(torch.as_tensor(v), dev) for k, v in inputs.items()}
            outputs = scalar_outputs(("loss", "acc", "lam", "grad_norm"), dev)

            def body():
                st = current["state"]
                set_accumulation_position(st, pos)
                _, metrics = _train_body(model, args, num_classes, st, bufs["images"],
                                         bufs["labels"], bufs["seed"],
                                         {k: bufs[k] for k in draws})
                write_outputs(outputs, metrics)

            return bufs, body, outputs

        key = (tuple(images.shape), images.dtype, tuple(targets.shape), targets.dtype, pos)
        out = graphs(key, build, inputs, params=state.params.values(),
                     state=state_tensors(state, list(model.buffers())))
        advance_accumulation(state, pos)
        return state, clone_outputs(out)

    step.graphs = graphs
    return step


def eval_metrics(model, params, images: torch.Tensor, labels: torch.Tensor,
                 num_classes: int) -> torch.Tensor:
    """[loss, acc] (fp32) of a deterministic forward of ``model`` with
    ``params`` (a name -> tensor mapping) on a batch on its device: the eval
    step's body, run eagerly."""
    with torch.no_grad():
        logits = functional_call(model, dict(params), (images,), dict(deterministic=True))
        loss = smoothed_ce(logits, labels, 0.0, num_classes)
        acc = (logits.argmax(dim=-1) == labels).float().mean()
        return torch.stack([loss, acc])


def make_vision_eval_step(model, num_classes: int) -> Callable:
    """``step(params, batch) -> {'loss', 'acc'}``: :func:`eval_metrics` on
    the batch (numpy or tensors).

    On the card the step replays a CUDA graph per batch shape (the images'
    shape and dtype and the labels'; an epoch's smaller last batch gets one
    of its own), the counterpart of the JAX step's ``jax.jit``: the batch is
    copied into the shape's static buffers and the metrics read from its
    static output.  A graph reads the parameters it was captured with, in
    place: an update in place (``TrainState.apply_gradients``) shows at the
    next replay, and a call whose params are other tensors drops the graphs
    and captures again.  On the CPU the same body runs eagerly.  The
    step's ``graphs`` is its :class:`TrainGraphs`."""
    graphs = TrainGraphs(model.device, model)
    current = {}

    def step(params, batch: Batch):
        dev = model.device
        images, labels = torch.as_tensor(batch["images"]), torch.as_tensor(batch["labels"])
        current["params"] = params

        def build():
            bufs = {name: static_like(x, dev) for name, x in (("images", images),
                                                              ("labels", labels))}
            out = torch.empty((2,), dtype=torch.float32, device=dev)

            def body():
                out.copy_(eval_metrics(model, current["params"], bufs["images"],
                                       bufs["labels"], num_classes))

            return bufs, body, out

        key = (tuple(images.shape), images.dtype, tuple(labels.shape), labels.dtype)
        out = graphs(key, build, dict(images=images, labels=labels),
                     state=list(params.values()),
                     use_graph=capturable(params)).clone()
        return {"loss": out[0], "acc": out[1]}

    step.graphs = graphs
    return step


def train_epoch(
    model,
    state: TrainState,
    data_iter: Iterable[Batch],
    args: VisionTrainingArgs,
    *,
    rng: int,
    num_classes: int,
    train_step_fn=None,
) -> Tuple[TrainState, Dict[str, float]]:
    """One pass over ``data_iter``; each step's seed drawn from ``rng``."""
    train_step_fn = train_step_fn or make_vision_train_step(model, args, num_classes)
    seeds = torch.Generator().manual_seed(int(rng))
    total_loss, total_acc, n = 0.0, 0.0, 0
    for batch in data_iter:
        step_rng = int(torch.randint(0, 2**62, (1,), generator=seeds))
        state, m = train_step_fn(state, batch, step_rng)
        total_loss += float(m["loss"])
        total_acc += float(m["acc"])
        n += 1
    denom = max(n, 1)
    return state, {"epoch_loss": total_loss / denom,
                   "epoch_acc": 100.0 * total_acc / denom, "batches": n}


def validate_epoch(
    model,
    state: TrainState,
    data_iter: Iterable[Batch],
    *,
    num_classes: int,
    eval_step_fn=None,
) -> Dict[str, float]:
    eval_step_fn = eval_step_fn or make_vision_eval_step(model, num_classes)
    total_loss, total_acc, n = 0.0, 0.0, 0
    for batch in data_iter:
        m = eval_step_fn(state.params, batch)
        total_loss += float(m["loss"])
        total_acc += float(m["acc"])
        n += 1
    denom = max(n, 1)
    return {"val_loss": total_loss / denom, "val_acc": 100.0 * total_acc / denom,
            "batches": n}
