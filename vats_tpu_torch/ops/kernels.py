"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds, not minutes).  Builds happen at first use, from the
sources in the checkout, into ``vats_tpu_torch/_build/`` (listed in
``.gitignore``); a library is named by a hash of its sources and flags, so
an edited source rebuilds.  :func:`build_all` starts one ``nvcc`` per source
at once and waits for all of them.

Each wrapper counts its launches in ``<wrapper>.launches`` through
:func:`count_launch`.  A launch made while the current stream captures a
CUDA graph is recorded, not run: it goes to the capture's tally
(:func:`launch_tally`), and each replay of the graph adds the tally
(``inference/graphs.py``).

Nothing here runs at import: the CPU tests import every module, and
``import vats_tpu_torch`` has to work where there is no CUDA toolkit.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("decode_attention", "flash_attention", "flash_backward", "cache_append",
           "paged_prefill_attention", "moe_grouped_gemm", "adamw", "mla_decode")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: the tallies of the captures under way, innermost last: {counted: launches}
_TALLIES: List[Dict[object, int]] = []


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def lib_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` with these sources and
    flags lives."""
    h = hashlib.sha256()
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str):
    """Start ``nvcc`` for ``name`` unless its library exists; returns a
    pending build ``(proc, log_file, tmp_path, lib_path)`` or None."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    log = open(BUILD_DIR / f"{name}.log", "w")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, log, tmp, out


def _finish_build(name: str, pending) -> None:
    proc, log, tmp, out = pending
    try:
        rc = proc.wait()
    finally:
        log.close()
    if rc != 0:
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu (exit {rc}):\n{build_log(name)}"
        )
    os.replace(tmp, out)


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``name`` (ptxas -v lines:
    registers, shared memory, spills)."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def build_all(names: List[str] = list(SOURCES)) -> float:
    """Build every kernel library that is missing, one ``nvcc`` per source,
    all started together.  Returns the wall seconds taken."""
    t0 = time.perf_counter()
    with _LOCK:
        procs = {n: _start_build(n) for n in names}
        for n, p in procs.items():
            if p is not None:
                _finish_build(n, p)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            proc = _start_build(name)
            if proc is not None:
                _finish_build(name, proc)
            lib = ctypes.CDLL(str(lib_path(name)))
            lib.vats_error_string.argtypes = [ctypes.c_int]
            lib.vats_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return _LIBS[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.vats_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_cuda_tensor(t: torch.Tensor, name: str, dtype=None, shape=None,
                      strided: bool = False) -> None:
    """Device, dtype, shape and contiguity checks before a pointer is passed.
    ``strided``: the kernel reads through the tensor's strides, so only the
    last dimension must be contiguous."""
    require(t.is_cuda, f"{name} must be a CUDA tensor")
    if dtype is not None:
        require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None:
        require(tuple(t.shape) == tuple(shape),
                f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if strided:
        require(t.stride(-1) == 1, f"{name} must have a unit last stride")
    else:
        require(t.is_contiguous(), f"{name} must be contiguous")


class LaunchCount:
    """A launch count of its own for one mode of a wrapper's kernel (the
    wrapper keeps counting every launch as well)."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0

    def __repr__(self) -> str:
        return f"LaunchCount({self.__name__!r}, {self.launches})"


def count_launch(counted) -> None:
    """One launch of ``counted``'s kernel (``counted`` is the wrapper, or any
    object with a ``launches`` count).  Outside a capture ``counted.launches``
    grows by one; while the current stream captures a CUDA graph the launch is
    only recorded, and the innermost :func:`launch_tally` counts it instead.
    A capture with no tally open raises: its replays would go uncounted."""
    if torch.cuda.is_current_stream_capturing():
        if not _TALLIES:
            raise RuntimeError(
                "a kernel was captured into a CUDA graph outside launch_tally(): "
                "its replays would not be counted")
        tally = _TALLIES[-1]
        tally[counted] = tally.get(counted, 0) + 1
    else:
        counted.launches += 1


@contextlib.contextmanager
def launch_tally() -> Iterator[Dict[object, int]]:
    """Collect the launches recorded by a capture: yields {counted: launches
    recorded}, which a replay adds to each ``counted.launches``."""
    tally: Dict[object, int] = {}
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.remove(tally)
