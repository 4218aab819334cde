"""Ranks, meshes and the collectives of data and context parallelism.

Counterpart of ``vats_tpu/parallel`` (mesh, multihost and the data and
sequence axes of sharded training; FSDP, tensor, expert and pipeline
parallelism are not ported yet)."""

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
