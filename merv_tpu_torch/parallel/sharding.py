"""The activation-mesh scope (counterpart of the activation half of
``merv_tpu/parallel/sharding.py``).

Model code asks :func:`get_activation_mesh` for the mesh a serving or
training call runs on: the decoder takes its sequence-parallel paths from it
(``DecoderConfig.sequence_parallel`` and an ``sp`` axis above 1). The scope
is set for one call by :func:`activation_mesh` and cleared when it exits, so
a mesh never leaks into a later call.

:func:`constrain_batch_dim` stays where ``merv_tpu`` pins a batch-leading
activation to its data/fsdp axes: with one process a rank, each rank holds
its own batch already, so it returns its input. The partition rules and the
FSDP specs wait for the training half of the mesh work (ROADMAP A12).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

_ACTIVATION_MESH = None


def set_activation_mesh(mesh) -> None:
    """Register (or clear, with None) the activation mesh; prefer :func:`activation_mesh`."""
    global _ACTIVATION_MESH
    _ACTIVATION_MESH = mesh


def get_activation_mesh():
    """The mesh of the enclosing :func:`activation_mesh` scope, or None."""
    return _ACTIVATION_MESH


@contextlib.contextmanager
def activation_mesh(mesh):
    """Scope the activation mesh to a block; the previous one comes back after it."""
    global _ACTIVATION_MESH
    prev = _ACTIVATION_MESH
    _ACTIVATION_MESH = mesh
    try:
        yield
    finally:
        _ACTIVATION_MESH = prev


def constrain_batch_dim(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``merv_tpu``'s batch-axis sharding constraint: a no-op here, where a
    rank's tensors are its own shard already."""
    return x
