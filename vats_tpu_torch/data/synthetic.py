"""Synthetic LM data for tests and benchmarking.

Counterpart of ``vats_tpu/data/synthetic.py``: random token ids, labels
shifted left by one, -100 where a position has no next token.  Drawn from an
explicit ``torch.Generator``, so its bits are not the JAX package's; the
tests hand both packages the same numpy batch.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import torch

from vats_tpu_torch.train.metrics import IGNORE_INDEX


def synthetic_lm_batches(
    generator: torch.Generator,
    *,
    vocab_size: int,
    batch_size: int,
    seq_len: int,
    num_batches: Optional[int] = None,
    pad_fraction: float = 0.0,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield {'input_ids', 'labels', 'padding_mask'} batches forever or
    ``num_batches`` times, on the generator's device."""
    dev = generator.device
    pos = torch.arange(seq_len, device=dev)[None, :]
    i = 0
    while num_batches is None or i < num_batches:
        ids = torch.randint(1, vocab_size, (batch_size, seq_len),
                            generator=generator, device=dev, dtype=torch.int32)
        if pad_fraction > 0:
            min_len = max(2, int(seq_len * (1 - pad_fraction)))
            lens = torch.randint(min_len, seq_len + 1, (batch_size,),
                                 generator=generator, device=dev, dtype=torch.int32)
        else:
            lens = torch.full((batch_size,), seq_len, dtype=torch.int32, device=dev)
        mask = pos < lens[:, None]
        ids = torch.where(mask, ids, 0)
        labels = torch.cat(
            [ids[:, 1:], torch.full((batch_size, 1), IGNORE_INDEX, dtype=torch.int32,
                                    device=dev)], dim=1)
        # a position's label is the NEXT token, so only pos < len-1 have one
        labels = torch.where(pos < (lens - 1)[:, None], labels, IGNORE_INDEX)
        yield {"input_ids": ids, "labels": labels, "padding_mask": mask}
        i += 1
