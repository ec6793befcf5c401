"""Device meshes and the process-group runtime (counterpart of ``merv_tpu/parallel/mesh.py``).

``merv_tpu`` builds one ``jax.sharding.Mesh`` over every device and lets XLA
place collectives. The port runs one process per rank, as ``torchrun``
starts them, and a mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh`
over that world with ``merv_tpu``'s five axes as its dim names, so that each
axis has a process group (``mesh.get_group("sp")``).

Axes: ``data`` (batch), ``fsdp`` (parameter sharding), ``tensor`` (tensor
parallelism), ``sp`` (sequence parallelism: the decoder's ring and the
sequence-sharded KV cache, :mod:`merv_tpu_torch.ops.ring_attention`) and
``pp`` (pipeline stages).

The backend is explicit (:func:`resolve_backend`): NCCL when each rank has a
card of its own, gloo for CPU tensors or when the caller names it. Two ranks
on one card cannot run NCCL (it refuses two ranks on one device), so that
layout must name gloo, which moves CUDA tensors through the host.

:class:`VirtualMesh` is the in-process stand-in of ``merv_tpu``'s virtual CPU
devices: ``sp`` ranks simulated in one process (tests and the card's kernel
checks). It is only ever used where a caller passes one.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple, Union

import numpy as np
import torch

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
SEQ_AXIS = "sp"
PIPE_AXIS = "pp"
MESH_AXES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS, SEQ_AXIS, PIPE_AXIS)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. ``-1`` means "absorb all remaining devices"."""

    data: int = 1
    fsdp: int = -1
    tensor: int = 1
    seq: int = 1
    pipe: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int, int, int, int]:
        dims = [self.data, self.fsdp, self.tensor, self.seq, self.pipe]
        if dims.count(-1) > 1:
            raise ValueError("At most one mesh axis may be -1")
        known = int(np.prod([d for d in dims if d != -1]))
        if -1 in dims:
            if n_devices % known != 0:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes {dims}")
            dims[dims.index(-1)] = n_devices // known
        if int(np.prod(dims)) != n_devices:
            raise ValueError(f"Mesh {dims} does not cover {n_devices} devices")
        return tuple(dims)  # type: ignore[return-value]


@dataclasses.dataclass(frozen=True)
class VirtualMesh:
    """``sp`` ranks simulated in one process: the sequence-parallel paths run
    every rank's body in turn and exchange blocks in memory
    (:class:`~merv_tpu_torch.ops.ring_attention.VirtualRanks`). ``pipe``
    runs GPipe's stages in turn (:class:`~merv_tpu_torch.parallel.pipeline.VirtualStages`).
    ``tensor`` describes the axis only: a decoder is cut to a rank's shards
    on a device mesh (one process a rank), so on a virtual one its weights
    stay whole, the replicated layout, which computes the same function."""

    sp: int
    tensor: int = 1
    pipe: int = 1

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: 1, FSDP_AXIS: 1, TENSOR_AXIS: self.tensor, SEQ_AXIS: self.sp, PIPE_AXIS: self.pipe}


Mesh = Union["torch.distributed.device_mesh.DeviceMesh", VirtualMesh]


def axis_size(mesh: Optional[Mesh], axis: str) -> int:
    """The size of ``axis`` on ``mesh`` (1 without a mesh or without the axis)."""
    if mesh is None:
        return 1
    if isinstance(mesh, VirtualMesh):
        return mesh.shape[axis]
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def mesh_shape(mesh: Optional[Mesh]) -> dict:
    """{axis: size} over :data:`MESH_AXES`, as ``merv_tpu``'s ``mesh.shape``."""
    return {a: axis_size(mesh, a) for a in MESH_AXES}


def world() -> Tuple[int, int]:
    """(rank, world size) of the default process group, else of the
    ``torchrun`` environment (``RANK`` / ``WORLD_SIZE``), else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))


def resolve_backend(device_type: str, backend: Optional[str] = None, world_size: Optional[int] = None) -> str:
    """The process-group backend for ranks on ``device_type``: ``backend``
    where named, NCCL on CUDA, gloo on the CPU. NCCL with more ranks than
    cards raises: NCCL refuses two ranks on one device."""
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported process-group backend {backend!r} (nccl or gloo)")
    if backend == "nccl":
        if device_type != "cuda":
            raise ValueError("the nccl backend needs CUDA devices; CPU ranks take gloo")
        ws = world()[1] if world_size is None else world_size
        cards = torch.cuda.device_count()
        if ws > cards:
            raise ValueError(
                f"{ws} ranks on {cards} card(s) under nccl: NCCL refuses two ranks on one device. Give each rank "
                "a card of its own, or name the gloo backend (it moves CUDA tensors through the host)"
            )
    return backend


def initialize_runtime(device_type: str = "cuda", backend: Optional[str] = None) -> None:
    """Start the default process group from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) with the
    backend of :func:`resolve_backend`; on CUDA each rank takes card
    ``LOCAL_RANK % cards``. A single process (no ``WORLD_SIZE`` above 1) is
    a no-op, as is a second call."""
    dist = torch.distributed
    if dist.is_initialized():
        return
    ws = int(os.environ.get("WORLD_SIZE", 1))
    if ws <= 1:
        return
    backend = resolve_backend(device_type, backend, ws)
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    dist.init_process_group(backend=backend, init_method="env://", rank=int(os.environ["RANK"]), world_size=ws)


def build_mesh(config: Optional[MeshConfig] = None, *, device_type: str = "cuda",
               backend: Optional[str] = None) -> "torch.distributed.device_mesh.DeviceMesh":
    """The global mesh over the world's ranks, dims named :data:`MESH_AXES`
    (the process group is started first, :func:`initialize_runtime`)."""
    from torch.distributed.device_mesh import init_device_mesh

    initialize_runtime(device_type, backend)
    config = config or MeshConfig()
    shape = config.resolve(world()[1])
    return init_device_mesh(device_type, shape, mesh_dim_names=MESH_AXES)


def single_device_mesh(device_type: str = "cuda", backend: Optional[str] = None):
    """A world-size-1 mesh (one rank: a process group of one is started where none exists)."""
    dist = torch.distributed
    if not dist.is_initialized():
        os.environ.setdefault("MASTER_ADDR", "localhost")
        os.environ.setdefault("MASTER_PORT", str(_free_port()))
        dist.init_process_group(backend=resolve_backend(device_type, backend, 1), init_method="env://", rank=0,
                                world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError(f"single_device_mesh in a world of {dist.get_world_size()} ranks")
    return build_mesh(MeshConfig(fsdp=1), device_type=device_type, backend=backend)


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def axis_group(mesh: Optional[Mesh], axis: str):
    """The process group over ``axis`` of a device mesh that holds this rank
    (on a mesh with several axes above 1, the ranks that differ from it on
    ``axis`` only: a ``tensor x sp`` mesh gives each rank the tensor group of
    its sp coordinate and the sp group of its tensor coordinate); None off
    mesh, on a virtual mesh, or where the axis is 1."""
    if mesh is None or isinstance(mesh, VirtualMesh) or axis_size(mesh, axis) <= 1:
        return None
    return mesh.get_group(axis)


def axis_rank(mesh: Optional[Mesh], axis: str) -> int:
    """This process's coordinate on ``axis`` (0 without a mesh, on a virtual mesh or without the axis)."""
    if mesh is None or isinstance(mesh, VirtualMesh) or axis not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(axis)


def batch_size(mesh: Optional[Mesh]) -> int:
    """The ranks the batch splits over: data x fsdp (``merv_tpu``'s batch axes)."""
    return axis_size(mesh, DATA_AXIS) * axis_size(mesh, FSDP_AXIS)


def batch_rank(mesh: Optional[Mesh]) -> int:
    """This process's batch coordinate on data x fsdp: ranks that differ only
    on ``tensor``, ``sp`` or ``pp`` share it, and so read the same examples."""
    return axis_rank(mesh, DATA_AXIS) * axis_size(mesh, FSDP_AXIS) + axis_rank(mesh, FSDP_AXIS)


_BATCH_GROUPS: dict = {}


def batch_group(mesh: Optional[Mesh]):
    """The process group over the batch axes (data x fsdp) of a device mesh;
    None off mesh, on a virtual mesh, or where the batch has one rank."""
    if mesh is None or isinstance(mesh, VirtualMesh) or batch_size(mesh) <= 1:
        return None
    if axis_size(mesh, DATA_AXIS) == 1:
        return mesh.get_group(FSDP_AXIS)
    if axis_size(mesh, FSDP_AXIS) == 1:
        return mesh.get_group(DATA_AXIS)
    key = id(mesh)
    if key not in _BATCH_GROUPS:
        _BATCH_GROUPS[key] = mesh[DATA_AXIS, FSDP_AXIS]._flatten().get_group()
    return _BATCH_GROUPS[key]


def batch_spec(mesh: Optional[Mesh]) -> Tuple[str, ...]:
    """The mesh dims a batch-leading activation shards over: ``data`` and
    ``fsdp`` where above 1 (``merv_tpu``'s ``PartitionSpec`` of them)."""
    return tuple(a for a in (DATA_AXIS, FSDP_AXIS) if axis_size(mesh, a) > 1)
