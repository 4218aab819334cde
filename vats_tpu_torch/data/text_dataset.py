"""Text dataset pipeline for LM training.

The port's copy of ``vats_tpu/data/text_dataset.py``: stream a HuggingFace
dataset (or take texts), tokenize, pad to ``max_seq_len``; labels are the
input shifted left by one with -100 at padded and final positions.
Batches come out as numpy arrays drawn with ``np.random.RandomState``, as in
the JAX package; ``data/feed.py::device_batches`` moves them to the card.
``from_hf_streaming`` needs the ``datasets`` package and the network, and
imports ``datasets`` only when called.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from vats_tpu_torch.train.metrics import IGNORE_INDEX

logger = logging.getLogger("vats_tpu_torch.data")


class TextDataset:
    """Tokenized, padded LM samples with shifted labels."""

    def __init__(
        self,
        tokenizer,
        max_seq_len: int,
        texts: Optional[List[str]] = None,
        pad_token_id: Optional[int] = None,
    ):
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len
        pad = pad_token_id
        if pad is None:
            pad = getattr(tokenizer, "pad_token_id", None)
        if pad is None:
            pad = getattr(tokenizer, "eos_token_id", 0) or 0
        self.pad_token_id = int(pad)
        self.examples: List[np.ndarray] = []
        if texts:
            for t in texts:
                self.add_text(t)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_texts(cls, texts: List[str], tokenizer, max_seq_len: int) -> "TextDataset":
        return cls(tokenizer, max_seq_len, texts=texts)

    @classmethod
    def from_hf_streaming(
        cls,
        dataset_name: str,
        tokenizer,
        max_seq_len: int,
        *,
        split: str = "train",
        text_column: str = "text",
        max_examples: int = 3_500_000,
        max_retries: int = 3,
        retry_sleep_s: float = 5.0,
        filters: Optional[List[Callable[[str], Optional[str]]]] = None,
        **load_kwargs,
    ) -> "TextDataset":
        """Stream from the HF hub with retries.  Requires network access."""
        from datasets import load_dataset  # deferred: offline-safe import

        ds = None
        for attempt in range(max_retries):
            try:
                ds = load_dataset(
                    dataset_name, split=split, streaming=True, **load_kwargs
                )
                break
            except Exception as exc:  # noqa: BLE001 — retry any hub failure
                logger.warning(
                    "dataset load attempt %d/%d failed: %s",
                    attempt + 1,
                    max_retries,
                    exc,
                )
                time.sleep(retry_sleep_s)
        if ds is None:
            raise RuntimeError(f"could not load dataset {dataset_name}")

        self = cls(tokenizer, max_seq_len)
        for i, row in enumerate(ds):
            if i >= max_examples:
                break
            text = row.get(text_column)
            if not text:
                continue
            if filters:
                for f in filters:
                    text = f(text)
                    if text is None:
                        break
                if text is None:
                    continue
            self.add_text(text)
        logger.info("materialized %d examples", len(self.examples))
        return self

    def add_text(self, text: str) -> None:
        ids = self.tokenizer.encode(text)[: self.max_seq_len]
        if len(ids) < 2:
            return
        arr = np.full((self.max_seq_len,), self.pad_token_id, dtype=np.int32)
        arr[: len(ids)] = ids
        self.examples.append(arr)

    # -- access ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.examples)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        ids = self.examples[idx]
        valid = ids != self.pad_token_id
        # position i's label is token i+1; last valid position and pads get -100
        labels = np.full_like(ids, IGNORE_INDEX)
        labels[:-1] = ids[1:]
        next_valid = np.zeros_like(valid)
        next_valid[:-1] = valid[1:]
        labels = np.where(valid & next_valid, labels, IGNORE_INDEX)
        return {"input_ids": ids, "labels": labels, "padding_mask": valid}

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        epochs: Optional[int] = 1,
    ) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = np.arange(len(self.examples))
            if shuffle:
                rng.shuffle(order)
            for start in range(0, len(order), batch_size):
                chunk = order[start : start + batch_size]
                if drop_last and len(chunk) < batch_size:
                    break
                rows = [self[int(i)] for i in chunk]
                yield {
                    k: np.stack([r[k] for r in rows]) for k in rows[0]
                }
            epoch += 1


def train_val_split(
    dataset: TextDataset, val_fraction: float = 0.1, seed: int = 42
):
    """Random train/validation split (90/10 by default)."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(dataset.examples))
    n_val = int(len(order) * val_fraction)
    val = TextDataset(dataset.tokenizer, dataset.max_seq_len,
                      pad_token_id=dataset.pad_token_id)
    train = TextDataset(dataset.tokenizer, dataset.max_seq_len,
                        pad_token_id=dataset.pad_token_id)
    val.examples = [dataset.examples[i] for i in order[:n_val]]
    train.examples = [dataset.examples[i] for i in order[n_val:]]
    return train, val
