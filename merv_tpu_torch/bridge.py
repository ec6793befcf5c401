"""Weight bridge: ``merv_tpu`` parameter trees -> this port's ``state_dict``s.

Takes the JAX package's parameter tree as nested dicts of **numpy** arrays
(convert leaves with ``np.asarray`` first; this module imports no JAX) and
returns the ``state_dict`` of the matching port module. The port's parameter
names follow the JAX tree, so the mapping is by rule:

- a ``Linear`` ``kernel`` is stored ``(in, out)`` -> ``weight`` transposed to
  torch's ``(out, in)`` (this covers the fusion's q/k/v kernels, which the JAX
  tree already stores ``(in, out)``);
- a norm ``scale`` and an ``Embed`` ``embedding`` -> ``weight``;
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
        if key == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{prefix}kernel: expected a 2-D (in, out) kernel, got {arr.shape}")
            arr = arr.T
        out[prefix + _LEAF_NAMES.get(key, key)] = torch.from_numpy(np.array(arr))  # a writable copy


def _leaves(tree: Mapping[str, Any]):
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, Mapping) else [np.asarray(v)])
    return out


def _index(tree: Mapping[str, Any], i: int) -> Dict[str, Any]:
    return {k: (_index(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]) for k, v in tree.items()}


def state_dict_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``merv_tpu`` parameter tree (numpy leaves) -> the port module's ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    if set(tree) <= set(_MERV_KEYS) and "llm_backbone" in tree:
        for i, sub in tree.get("video_backbones", {}).items():
            _convert(sub, f"video_backbones.{i}.vit.", out)
        for i, sub in tree.get("projectors", {}).items():
            _convert(sub, f"projectors.{i}.", out)
        _convert(tree.get("feature_fusion", {}), "feature_fusion.", out)
        _convert(tree["llm_backbone"], "llm_backbone.decoder.", out)
    else:
        _convert(tree, "", out)
    return out
