"""Token-shard dataset with native (C) batch assembly.

The port's copy of ``vats_tpu/data/shard_dataset.py``.  Tokenized documents
are one contiguous int32 arena plus int64 offsets (a "shard", saved and
loaded with numpy).  Row assembly (gather, pad, shift the labels, mask) and
greedy multi-document packing with segment ids run in C:
``data/native/shard_loader.c``, compiled at first use with the system's C
compiler (``cc -O3 -shared -fPIC``) into ``vats_tpu_torch/_build/`` (named
by a hash of the source, so an edited source rebuilds) and bound with
``ctypes``.  Unlike the JAX module, a failed build or load raises with the
compiler's output; nothing falls back quietly.  The numpy packer
``_pack_batch_numpy`` stays as the C code's plain version for the tests.
Segment ids feed the attention kernels' segment masks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from vats_tpu_torch.train.metrics import IGNORE_INDEX

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / "native" / "shard_loader.c"
BUILD_DIR = PKG_DIR / "_build"
CFLAGS = ["-O3", "-shared", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def lib_path() -> Path:
    """Where the library built from ``SOURCE`` with ``CFLAGS`` lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CFLAGS).encode())
    return BUILD_DIR / f"libshard_loader-{h.hexdigest()[:12]}.so"


def _compiler() -> str:
    for cc in ("cc", "gcc", "clang"):
        found = shutil.which(cc)
        if found:
            return found
    raise RuntimeError("no C compiler (cc, gcc or clang) found: the shard loader "
                       f"needs one to build {SOURCE}")


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_compiler(), *CFLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds each land whole


def load_native() -> ctypes.CDLL:
    """The loaded shard-loader library, built first if needed; raises if
    it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.pack_batch.argtypes = [
            i32p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, i32p, i32p, u8p,
        ]
        lib.pack_batch.restype = None
        lib.pack_sequences.argtypes = [
            i32p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            i32p, i32p, i32p, u8p,
        ]
        lib.pack_sequences.restype = ctypes.c_int64
        _lib = lib
        return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class TokenShard:
    """Contiguous token arena + offsets; saved and loaded with numpy."""

    def __init__(self, tokens: np.ndarray, offsets: np.ndarray):
        self.tokens = np.ascontiguousarray(tokens, dtype=np.int32)
        self.offsets = np.ascontiguousarray(offsets, dtype=np.int64)

    @classmethod
    def from_documents(cls, docs: List[List[int]]) -> "TokenShard":
        offsets = np.zeros(len(docs) + 1, dtype=np.int64)
        for i, d in enumerate(docs):
            offsets[i + 1] = offsets[i] + len(d)
        tokens = np.empty(int(offsets[-1]), dtype=np.int32)
        for i, d in enumerate(docs):
            tokens[offsets[i] : offsets[i + 1]] = d
        return cls(tokens, offsets)

    @property
    def num_docs(self) -> int:
        return len(self.offsets) - 1

    def save(self, path: str) -> None:
        np.savez(path, tokens=self.tokens, offsets=self.offsets)

    @classmethod
    def load(cls, path: str, mmap: bool = True) -> "TokenShard":
        data = np.load(path, mmap_mode="r" if mmap else None)
        return cls(np.asarray(data["tokens"]), np.asarray(data["offsets"]))


class ShardDataset:
    """Batched LM samples from a TokenShard, assembled in C."""

    def __init__(self, shard: TokenShard, seq_len: int, pad_id: int = 0):
        self.shard = shard
        self.seq_len = seq_len
        self.pad_id = pad_id

    def pack_batch(self, doc_indices: np.ndarray) -> Dict[str, np.ndarray]:
        """One padded row per document index."""
        b, s = len(doc_indices), self.seq_len
        idx = np.ascontiguousarray(doc_indices, dtype=np.int64)
        if b and (idx.min() < 0 or idx.max() >= self.shard.num_docs):
            raise IndexError(f"document index out of range [0, {self.shard.num_docs})")
        ids = np.empty((b, s), dtype=np.int32)
        labels = np.empty((b, s), dtype=np.int32)
        mask = np.empty((b, s), dtype=np.uint8)
        load_native().pack_batch(
            _ptr(self.shard.tokens, ctypes.c_int32),
            _ptr(self.shard.offsets, ctypes.c_int64),
            _ptr(idx, ctypes.c_int64),
            b, s, self.pad_id, IGNORE_INDEX,
            _ptr(ids, ctypes.c_int32),
            _ptr(labels, ctypes.c_int32),
            _ptr(mask, ctypes.c_uint8),
        )
        return {
            "input_ids": ids,
            "labels": labels,
            "padding_mask": mask.astype(bool),
        }

    def _pack_batch_numpy(self, idx, ids, labels, mask):
        off, toks, s = self.shard.offsets, self.shard.tokens, self.seq_len
        for r, d in enumerate(idx):
            ln = min(int(off[d + 1] - off[d]), s)
            ids[r, :ln] = toks[off[d] : off[d] + ln]
            ids[r, ln:] = self.pad_id
            mask[r, :ln] = 1
            mask[r, ln:] = 0
            labels[r, : max(ln - 1, 0)] = ids[r, 1:ln]
            labels[r, max(ln - 1, 0) :] = IGNORE_INDEX

    def pack_sequences(
        self, start_doc: int, batch_size: int
    ) -> Tuple[Dict[str, np.ndarray], int]:
        """Greedy multi-document packing with segment ids.

        Returns (batch, docs_consumed)."""
        if not 0 <= start_doc <= self.shard.num_docs:
            raise IndexError(f"start_doc {start_doc} out of range "
                             f"[0, {self.shard.num_docs}]")
        b, s = batch_size, self.seq_len
        ids = np.empty((b, s), dtype=np.int32)
        labels = np.empty((b, s), dtype=np.int32)
        segs = np.empty((b, s), dtype=np.int32)
        mask = np.empty((b, s), dtype=np.uint8)
        consumed = load_native().pack_sequences(
            _ptr(self.shard.tokens, ctypes.c_int32),
            _ptr(self.shard.offsets, ctypes.c_int64),
            self.shard.num_docs, start_doc, b, s, self.pad_id, IGNORE_INDEX,
            _ptr(ids, ctypes.c_int32),
            _ptr(labels, ctypes.c_int32),
            _ptr(segs, ctypes.c_int32),
            _ptr(mask, ctypes.c_uint8),
        )
        return (
            {
                "input_ids": ids,
                "labels": labels,
                "segment_ids": segs,
                "padding_mask": mask.astype(bool),
            },
            int(consumed),
        )

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        epochs: Optional[int] = 1,
        packed: bool = False,
    ) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            if packed:
                doc = 0
                while doc < self.shard.num_docs:
                    batch, consumed = self.pack_sequences(doc, batch_size)
                    if consumed == 0:
                        break
                    doc += consumed
                    yield batch
            else:
                order = (
                    rng.permutation(self.shard.num_docs)
                    if shuffle
                    else np.arange(self.shard.num_docs)
                )
                for i in range(0, len(order) - batch_size + 1, batch_size):
                    yield self.pack_batch(order[i : i + batch_size])
            epoch += 1
