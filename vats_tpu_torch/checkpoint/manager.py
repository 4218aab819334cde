"""Checkpoints of the train state with the JAX package's schema and policy.

Counterpart of ``vats_tpu/checkpoint/manager.py`` (orbax), over
``torch.save`` / ``torch.load``:

  * a checkpoint is one file named ``best_model`` or
    ``checkpoint_tokens_seen_{N}``, with a sibling ``<path>.meta.json``
    holding exactly the JAX keys (``model_args``, ``training_args``,
    ``tokens_seen``, ``loss``, ``is_best``);
  * the file holds the whole :class:`TrainState` by name: ``params`` (the
    model's ``state_dict`` names), ``opt_state`` (the optimizer's
    dataclasses -- ``MultiStepsState``, ``ClipSkipState``, ``AdamWState``
    -- as dicts of their fields, each tagged with its class name), and
    ``step``, ``tokens_seen``, ``skipped_steps``;
  * every file is written to a temporary name and ``os.replace``-d, so a
    run cut mid-write leaves the previous checkpoint whole and no half one;
    a round that saves both kinds writes the state once and gives the
    second name a hard link to it;
  * :class:`CheckpointManager` keeps the best-on-validation and the forced
    regular saves; with ``async_save=True`` it copies the state into host
    memory in stream order (so later in-place updates cannot reach the
    copy) and writes it on a background thread; ``wait()`` joins the
    writes, as orbax's ``AsyncCheckpointer.wait_until_finished``.

Loading with a target copies params, optimizer state and counters into the
target's own tensors, on the target's device; without one it returns the
raw dict (tensors on the CPU), the args-only mode of the training script.
``unbox_restored`` has no counterpart: the port has no flax boxes.

A sharded state (``parallel/sharded.py``: each rank holds its blocks) is
saved whole, in the single-process format: every rank takes part in the
gathers, the coordinator (rank 0) alone writes, and every rank waits for
the file before it goes on.  Loaded into a sharded target, each rank keeps
its blocks of the whole arrays in the file.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from vats_tpu_torch.parallel.layout import is_sharded, shard_of, whole
from vats_tpu_torch.parallel.multihost import is_coordinator
from vats_tpu_torch.train.state import TrainState

_CLASS_KEY = "__dataclass__"
_STATE_COUNTERS = ("step", "tokens_seen", "skipped_steps")


def _args_to_dict(args) -> Optional[Dict]:
    if args is None:
        return None
    if dataclasses.is_dataclass(args):
        return dataclasses.asdict(args)
    return dict(args)


def _tree(obj, leaf):
    """``obj`` (dataclasses, dicts, tensors, Python scalars) as plain dicts,
    each tensor replaced by ``leaf(tensor)``."""
    if isinstance(obj, torch.Tensor):
        info = getattr(obj, "shard_info", None)
        return leaf(obj.detach() if info is None else whole(obj.detach(), info))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {_CLASS_KEY: type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = _tree(getattr(obj, f.name), leaf)
        return out
    if isinstance(obj, dict):
        return {k: _tree(v, leaf) for k, v in obj.items()}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def state_tree(state: TrainState, leaf=lambda t: t) -> Dict[str, Any]:
    """The saved form of ``state``: {params, opt_state, step, tokens_seen,
    skipped_steps}, each tensor passed through ``leaf`` (a sharded one
    whole: a collective on every rank)."""
    out = {"params": _tree(dict(state.params), leaf),
           "opt_state": _tree(state.opt_state, leaf)}
    for name in _STATE_COUNTERS:
        out[name] = _tree(getattr(state, name), leaf)
    return out


def _host_snapshot(state: TrainState) -> Tuple[Dict[str, Any], Optional[torch.cuda.Event]]:
    """A copy of ``state`` in host memory, queued in stream order: card
    tensors go to pinned buffers with non-blocking copies on the current
    stream (the returned event marks their end), CPU tensors are cloned."""
    card = []  # the device of the card tensors, if any

    def leaf(t):
        if t.is_cuda:
            card[:] = [t.device]
            dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return dst.copy_(t, non_blocking=True)
        return t.clone()

    tree = state_tree(state, leaf)
    if not card:
        return tree, None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(card[0]))
    return tree, event


def _checkpoint_path(directory: str, is_best: bool, step_key: int) -> str:
    name = "best_model" if is_best else f"checkpoint_tokens_seen_{step_key}"
    return os.path.abspath(os.path.join(directory, name))


def _write(path: str, tree: Optional[Dict[str, Any]], meta: Dict[str, Any],
           ready: Optional[torch.cuda.Event] = None, link_to: Optional[str] = None) -> str:
    """The checkpoint file, then its meta, each written whole or not at
    all.  With ``link_to`` (a checkpoint of the same state, already on
    disk) the file is a hard link to it instead of a second copy."""
    if ready is not None:
        ready.synchronize()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    if link_to is None:
        torch.save(tree, tmp)
    else:
        if os.path.lexists(tmp):
            os.remove(tmp)
        os.link(link_to, tmp)
    os.replace(tmp, path)
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=2, default=str)
    os.replace(tmp, path + ".meta.json")
    return path


def _meta(model_args, training_args, tokens_seen: int, loss, is_best: bool) -> Dict:
    return {
        "model_args": _args_to_dict(model_args),
        "training_args": _args_to_dict(training_args),
        "tokens_seen": tokens_seen,
        "loss": loss,
        "is_best": is_best,
    }


def save_checkpoint(
    directory: str,
    state: TrainState,
    *,
    model_args=None,
    training_args=None,
    loss: Optional[float] = None,
    is_best: bool = False,
    step_key: Optional[int] = None,
) -> str:
    """Save train state + args now.  Returns the checkpoint path: ``best_model``
    or ``checkpoint_tokens_seen_{step_key}`` (by default the state's
    ``tokens_seen``) in ``directory``."""
    tokens_seen = int(state.tokens_seen)
    if step_key is None:
        step_key = tokens_seen
    path = _checkpoint_path(directory, is_best, step_key)
    tree = state_tree(state)
    sharded = is_sharded(state.params)
    if not sharded or is_coordinator():
        _write(path, tree, _meta(model_args, training_args, tokens_seen, loss, is_best))
    if sharded:
        dist.barrier()  # the file is whole before any rank reads it
    return path


def _restore_into(target, saved, where: str):
    """Copy ``saved`` (a tree from :func:`state_tree`) into ``target``'s
    tensors in place; returns the target (or the saved Python scalar)."""
    if isinstance(target, torch.Tensor):
        info = getattr(target, "shard_info", None)
        if info is not None and isinstance(saved, torch.Tensor) \
                and tuple(saved.shape) == info.shape:
            saved = shard_of(saved, info)  # this rank's block of the whole array
        if not isinstance(saved, torch.Tensor) or saved.shape != target.shape \
                or saved.dtype != target.dtype:
            got = (tuple(saved.shape), saved.dtype) if isinstance(saved, torch.Tensor) \
                else type(saved).__name__
            raise ValueError(f"checkpoint entry {where}: {got} does not fit the target's "
                             f"{(tuple(target.shape), target.dtype)}")
        with torch.no_grad():
            target.copy_(saved)
        return target
    if dataclasses.is_dataclass(target):
        name = type(target).__name__
        if not isinstance(saved, dict) or saved.get(_CLASS_KEY) != name:
            got = saved.get(_CLASS_KEY) if isinstance(saved, dict) else type(saved).__name__
            raise ValueError(f"checkpoint entry {where}: holds a {got}, the target a {name} "
                             "(another optimizer layout: grad_accum_steps or mu dtype)")
        for f in dataclasses.fields(target):
            setattr(target, f.name, _restore_into(getattr(target, f.name), saved[f.name],
                                                  f"{where}.{f.name}"))
        return target
    if isinstance(target, dict):
        if not isinstance(saved, dict) or set(saved) != set(target):
            missing = sorted(set(target) - set(saved or {}))[:5]
            extra = sorted(set(saved or {}) - set(target))[:5]
            raise ValueError(f"checkpoint entry {where}: keys differ from the target's "
                             f"(missing {missing}, unexpected {extra})")
        for k in target:
            target[k] = _restore_into(target[k], saved[k], f"{where}.{k}")
        return target
    return saved


def load_checkpoint(path: str, target: Optional[TrainState] = None) -> Tuple[Any, Dict]:
    """Restore (state, meta).  With a ``target`` TrainState its params,
    optimizer state and counters are overwritten in place from the file
    (on the target's devices; a sharded target takes its blocks) and the
    target is returned; without one the raw saved dict is returned (CPU
    tensors)."""
    path = os.path.abspath(path)
    restored = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    meta: Dict = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    if target is None:
        return restored, meta
    _restore_into(target.params, restored["params"], "params")
    target.opt_state = _restore_into(target.opt_state, restored["opt_state"], "opt_state")
    for name in _STATE_COUNTERS:
        _restore_into(getattr(target, name), restored[name], name)
    return target, meta


class CheckpointManager:
    """Best/regular checkpoint policy: a best checkpoint whenever the
    validation loss improves, a regular one when forced."""

    def __init__(
        self,
        directory: str,
        *,
        model_args=None,
        training_args=None,
        async_save: bool = False,
    ):
        self.directory = directory
        self.model_args = model_args
        self.training_args = training_args
        self.best_loss = float("inf")
        # one writer thread: saves land in order, at most one is on disk
        # at a time
        self._writer = (concurrent.futures.ThreadPoolExecutor(max_workers=1)
                        if async_save else None)
        self._pending: List[concurrent.futures.Future] = []
        os.makedirs(directory, exist_ok=True)

    def wait(self) -> None:
        """Block until every queued save is on disk; raises the first
        write error."""
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self) -> None:
        """Wait for the queued saves and stop the writer thread."""
        try:
            self.wait()
        finally:
            if self._writer is not None:
                self._writer.shutdown(wait=True)
                self._writer = None

    def maybe_save(
        self, state: TrainState, val_loss: float, *, force_regular: bool = False
    ) -> Dict[str, Optional[str]]:
        saved = {"best": None, "regular": None}
        kinds = []
        if val_loss < self.best_loss:
            self.best_loss = val_loss
            kinds.append(("best", True))
        if force_regular:
            kinds.append(("regular", False))
        if not kinds:
            return saved
        tokens_seen = int(state.tokens_seen)
        if self._writer is None:
            tree, ready = state_tree(state), None
        else:
            tree, ready = _host_snapshot(state)
        sharded = is_sharded(state.params)
        if sharded and not is_coordinator():
            # the gathers above were this rank's part; the coordinator writes
            dist.barrier()
            for key, is_best in kinds:
                saved[key] = _checkpoint_path(self.directory, is_best, tokens_seen)
            return saved
        # a round that saves both writes the state once: the second name
        # is a hard link to the first file (a later best save replaces its
        # own name, never the shared file)
        first = None
        for key, is_best in kinds:
            path = _checkpoint_path(self.directory, is_best, tokens_seen)
            meta = _meta(self.model_args, self.training_args, tokens_seen, val_loss,
                         is_best)
            if self._writer is None:
                _write(path, tree, meta, link_to=first)
            else:
                self._pending.append(self._writer.submit(_write, path, tree, meta, ready,
                                                         first))
            saved[key] = path
            first = first or path
        if sharded:
            self.wait()
            dist.barrier()
        return saved
