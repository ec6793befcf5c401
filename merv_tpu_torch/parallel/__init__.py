"""Meshes, the process-group runtime and the activation-mesh scope (counterpart of ``merv_tpu/parallel``)."""

from merv_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FSDP_AXIS,
    MESH_AXES,
    PIPE_AXIS,
    SEQ_AXIS,
    TENSOR_AXIS,
    MeshConfig,
    VirtualMesh,
    axis_size,
    batch_spec,
    build_mesh,
    initialize_runtime,
    mesh_shape,
    resolve_backend,
    single_device_mesh,
    world,
)
from merv_tpu_torch.parallel.sharding import (
    activation_mesh,
    constrain_batch_dim,
    get_activation_mesh,
    set_activation_mesh,
)

__all__ = [
    "DATA_AXIS",
    "FSDP_AXIS",
    "MESH_AXES",
    "PIPE_AXIS",
    "SEQ_AXIS",
    "TENSOR_AXIS",
    "MeshConfig",
    "VirtualMesh",
    "activation_mesh",
    "axis_size",
    "batch_spec",
    "build_mesh",
    "constrain_batch_dim",
    "get_activation_mesh",
    "initialize_runtime",
    "mesh_shape",
    "resolve_backend",
    "set_activation_mesh",
    "single_device_mesh",
    "world",
]
