"""Host-to-device feeding of numpy batches.

The text and shard pipelines yield numpy batches; the train step takes
tensors on the model's device.  The JAX package converts at the ``jit``
boundary; here :func:`device_batches` does it: each array is wrapped
without a copy, copied once into pinned host memory and sent to the card
with ``non_blocking`` on the current stream, so the copy overlaps the work
already queued.  Token ids and labels become ``int32``, masks ``bool``,
anything else keeps its dtype.  On the CPU it is a plain conversion.

The span ``data.feed`` (``utils/profiling.annotate``) covers that work for
each batch, from when ``it`` has yielded it: the caller's own generator is
not in it.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Mapping

import numpy as np
import torch

from vats_tpu_torch.device import resolve_device
from vats_tpu_torch.utils.profiling import annotate

_INT_KEYS = ("input_ids", "labels", "segment_ids")
_MASK_KEYS = ("padding_mask",)


def device_batches(it: Iterable[Mapping[str, np.ndarray]],
                   device) -> Iterator[Dict[str, torch.Tensor]]:
    """Each numpy batch of ``it`` as tensors on ``device`` (see the module
    docstring)."""
    dev = resolve_device(device)
    for batch in it:
        out = {}
        with annotate("data.feed"):
            for key, arr in batch.items():
                arr = np.asarray(arr)
                if key in _INT_KEYS:
                    arr = arr.astype(np.int32, copy=False)
                elif key in _MASK_KEYS:
                    arr = arr.astype(bool, copy=False)
                t = torch.from_numpy(np.ascontiguousarray(arr))
                if dev.type == "cuda":
                    # pinned staging: the copy is asynchronous and keeps no
                    # reference to the numpy buffer once it is queued
                    t = t.pin_memory().to(dev, non_blocking=True)
                out[key] = t
        yield out
