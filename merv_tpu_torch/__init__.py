"""merv_tpu_torch: the PyTorch/CUDA port of ``merv_tpu`` for one NVIDIA H100.

The package mirrors ``merv_tpu``'s module layout and names so a reader finds
each counterpart: ``conf/``, ``nn/``, ``ops/`` (attention, with hand-written
Hopper kernels under ``csrc/``), ``preprocessing/``, ``models/`` (towers, the
Llama decoder, generation, MERV) and ``bridge.py`` (JAX parameter trees ->
``state_dict``s). It imports ``torch`` and never ``jax`` or ``merv_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request they raise (:func:`resolve_device`).

:func:`load_vid` loads a trained MERV from a local run directory;
``python -m merv_tpu_torch.quick_start`` answers a question about a video with it.
"""

from merv_tpu_torch.device import resolve_device
from merv_tpu_torch.models.load_vid import available_model_names, available_models, get_model_description, load_vid

__all__ = ["available_model_names", "available_models", "get_model_description", "load_vid", "resolve_device"]
