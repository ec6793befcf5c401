"""merv_tpu_torch: the PyTorch/CUDA port of ``merv_tpu`` for one NVIDIA H100.

The package mirrors ``merv_tpu``'s module layout and names so a reader finds
each counterpart: ``conf/``, ``nn/``, ``ops/`` (attention, with hand-written
Hopper kernels under ``csrc/``), ``preprocessing/``, ``models/`` (towers, the
Llama decoder, generation, MERV) and ``bridge.py`` (JAX parameter trees ->
``state_dict``s). It imports ``torch`` and never ``jax`` or ``merv_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request they raise (:func:`resolve_device`).
"""

from merv_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
