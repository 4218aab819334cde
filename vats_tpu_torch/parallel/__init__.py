"""Ranks, meshes, per-leaf shardings and the collectives of sharded training.

Counterpart of ``vats_tpu/parallel`` (mesh, multihost, sharded training
over the data, fsdp, expert, tensor and seq axes, and GPipe pipeline
parallelism over any of them)."""

from vats_tpu_torch.parallel.mesh import (
    MESH_AXES,
    Mesh,
    ambient_mesh,
    create_device_mesh,
    create_mesh,
    logical_axis_rules,
    logical_to_mesh_spec,
    with_logical_constraint,
)

__all__ = [
    "MESH_AXES",
    "Mesh",
    "ambient_mesh",
    "create_mesh",
    "create_device_mesh",
    "logical_axis_rules",
    "logical_to_mesh_spec",
    "with_logical_constraint",
]
