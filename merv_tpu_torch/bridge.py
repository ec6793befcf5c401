"""Weight bridge: ``merv_tpu`` parameter trees -> this port's ``state_dict``s.

Takes the JAX package's parameter tree as nested dicts of **numpy** arrays
(convert leaves with ``np.asarray`` first; this module imports no JAX) and
returns the ``state_dict`` of the matching port module. The port's parameter
names follow the JAX tree, so the mapping is by rule:

- a ``Linear`` ``kernel`` is stored ``(in, out)`` -> ``weight`` transposed to
  torch's ``(out, in)`` (this covers the fusion's q/k/v kernels, which the JAX
  tree already stores ``(in, out)``);
- a norm ``scale`` and an ``Embed`` ``embedding`` -> ``weight``;
- a weight-only int8 Linear (``merv_tpu/nn/quantization.py``: ``kernel_q``
  int8 ``(in, out)`` beside ``scale`` fp32 ``(1, out)``) -> ``weight_q``
  transposed to ``(out, in)`` and ``scale`` ``(out,)``, the layout of a
  quantized ``Linear`` (the rename of ``scale`` keys on its ``kernel_q``
  sibling: a norm's ``scale`` still becomes ``weight``);
- a scanned layer stack ``layers`` (every leaf ``[L, ...]``) -> ``layers.<i>.``;
- every other leaf (``pos_embed``, ``cls_token``, ``gamma``, ``Q``, ...) keeps its name.

Given a whole MERV tree (keys ``video_backbones`` / ``projectors`` /
``feature_fusion`` / ``llm_backbone``) it yields the ``MERV`` module's keys
(towers under ``video_backbones.<i>.vit.``, the decoder under
``llm_backbone.decoder.``); given one tower's, projector's, fusion's or
decoder's tree it yields that module's keys.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
_MERV_KEYS = ("video_backbones", "projectors", "feature_fusion", "llm_backbone")


def _convert(tree: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            if key == "layers":
                leaves = _leaves(val)
                n_layers = leaves[0].shape[0]
                if any(leaf.shape[0] != n_layers for leaf in leaves):
                    raise ValueError(f"{prefix}layers: leaves disagree on the stacked layer count")
                for i in range(n_layers):
                    _convert(_index(val, i), f"{prefix}layers.{i}.", out)
            else:
                _convert(val, f"{prefix}{key}.", out)
            continue
        arr = np.asarray(val)
        if "kernel_q" in tree and key in ("kernel_q", "scale"):
            if key == "kernel_q":
                if arr.ndim != 2:
                    raise ValueError(f"{prefix}kernel_q: expected a 2-D (in, out) kernel, got {arr.shape}")
                out[prefix + "weight_q"] = to_torch(arr.T)
            else:
                out[prefix + "scale"] = to_torch(arr.reshape(-1))
            continue
        if key == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{prefix}kernel: expected a 2-D (in, out) kernel, got {arr.shape}")
            arr = arr.T
        out[prefix + _LEAF_NAMES.get(key, key)] = to_torch(arr)


def as_tensor(t: Any) -> torch.Tensor:
    """A torch tensor (moved to the CPU) or a numpy array (through :func:`to_torch`)."""
    return t.detach().cpu() if isinstance(t, torch.Tensor) else to_torch(t)


def to_torch(arr: Any) -> torch.Tensor:
    """A numpy array -> a CPU tensor that owns a copy of it; ``bfloat16``
    (ml_dtypes', as JAX and tensorstore give it) through a ``uint16`` view."""
    arr = np.array(arr, order="C")  # a contiguous copy, of any rank
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _leaves(tree: Mapping[str, Any]):
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, Mapping) else [np.asarray(v)])
    return out


def _index(tree: Mapping[str, Any], i: int) -> Dict[str, Any]:
    return {k: (_index(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]) for k, v in tree.items()}


def module_state_dicts(tree: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """A (partial) MERV tree, keyed by ``video_backbones`` / ``projectors`` /
    ``feature_fusion`` / ``llm_backbone`` -> the ``state_dict`` of each of the
    ``MERV`` module's children of those names."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, sub in tree.items():
        if key not in _MERV_KEYS:
            raise ValueError(f"not a MERV module key: {key!r}")
        sd: Dict[str, torch.Tensor] = {}
        if key == "video_backbones":
            for i, tower in sub.items():
                _convert(tower, f"{i}.vit.", sd)
        else:
            _convert(sub, "decoder." if key == "llm_backbone" else "", sd)
        out[key] = sd
    return out


def state_dict_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``merv_tpu`` parameter tree (numpy leaves) -> the port module's ``state_dict``."""
    if set(tree) <= set(_MERV_KEYS) and "llm_backbone" in tree:
        return {f"{key}.{name}": t for key, sd in module_state_dicts(tree).items() for name, t in sd.items()}
    out: Dict[str, torch.Tensor] = {}
    _convert(tree, "", out)
    return out
