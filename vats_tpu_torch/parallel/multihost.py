"""Multi-process runtime: process group, host-sharded data.

Counterpart of ``vats_tpu/parallel/multihost.py``.  Where JAX connects the
processes of one SPMD program through its coordination service, here each
process is one rank of a ``torch.distributed`` world:

  * :func:`initialize_multihost` calls ``init_process_group``; its
    arguments default from COORDINATOR_ADDRESS, NUM_PROCESSES and
    PROCESS_ID, as in the JAX package.  The backend is the caller's
    choice, never switched for it: ``"nccl"`` where each rank has a GPU of
    its own, ``"gloo"`` on CPU processes and for several ranks on one GPU
    (``parallel/collectives.py`` stages CUDA tensors through host buffers
    on gloo).
  * :func:`host_shard_slice` is this process's row range of a global batch,
    :func:`make_global_batch` this rank's block of a batch by its mesh
    coordinates, and :func:`is_coordinator` the process that writes
    checkpoints and logs.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from vats_tpu_torch.parallel.mesh import Mesh, _world, named_sharding

BACKENDS = ("nccl", "gloo")


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = 600.0,
) -> None:
    """Join this process to the world as rank ``process_id`` of
    ``num_processes``.

    ``coordinator_address`` is ``host:port`` (rank 0 listens there) or a
    ``torch.distributed`` init URL (``tcp://...``, ``file://...``).  All three
    default from the environment (COORDINATOR_ADDRESS, NUM_PROCESSES,
    PROCESS_ID).  ``backend`` must be given: 'nccl' (one GPU per rank) or
    'gloo' (CPU processes, or ranks sharing a GPU).  No-op when this process
    already belongs to a world."""
    if dist.is_initialized():
        return
    if backend not in BACKENDS:
        raise ValueError(f"initialize_multihost: backend must be one of {BACKENDS} "
                         f"(the caller's choice), got {backend!r}")
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize_multihost needs the coordinator address, the "
                         "process count and this process's id (arguments or "
                         "COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID)")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                            rank=int(process_id), timeout=timedelta(seconds=timeout_s))


def host_shard_slice(total: int, *, drop_remainder: bool = True) -> slice:
    """This process's contiguous row range of a ``total``-row global batch."""
    n, i = _world()
    if total % n != 0 and drop_remainder:
        total = (total // n) * n
    per = total // n
    return slice(i * per, (i + 1) * per)


def make_global_batch(
    batch: Dict[str, object],
    mesh: Mesh,
    *,
    batch_logical_axes: Tuple[Optional[str], ...] = ("batch",),
) -> Dict[str, torch.Tensor]:
    """This rank's block of each array of a whole batch, cut by its mesh
    coordinates along ``batch_logical_axes`` (rows over data x fsdp by
    default; add ``"activation_seq"`` to cut the sequence over seq)."""

    def block(x):
        x = torch.as_tensor(x)
        axes = tuple(batch_logical_axes[: x.dim()])
        return named_sharding(mesh, *axes).shard(x)

    return {k: block(v) for k, v in batch.items()}


def is_coordinator() -> bool:
    """True on the process that should write checkpoints/logs (rank 0)."""
    return _world()[1] == 0
