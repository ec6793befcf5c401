"""Import a reference-format MERV checkpoint (counterpart of ``merv_tpu/models/ckpt_import.py``).

The released MERV checkpoints (``checkpoints/latest-checkpoint.pt``) hold
``{"model": {"projectors": ..., "feature_fusion": ..., ["llm_backbone": ...]}}``
with torch module state dicts, or the legacy keys ``projector`` (one
encoder) and ``adapter`` (the fusion). This module turns them into the
``state_dict``s of the port's modules: the ``3davg+linear`` projectors keep
their names; the fusion's ``nn.MultiheadAttention`` weights
(``q_proj_weight`` ... and one packed ``in_proj_bias``, zeros when absent)
become three ``Linear``s; an ``llm_backbone`` goes through
:func:`~merv_tpu_torch.models.backbones.llm.hf_import.import_llama_state_dict`.
Other projectors and fusions raise ``NotImplementedError`` (ROADMAP A10).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from merv_tpu_torch.bridge import as_tensor
from merv_tpu_torch.models.backbones.llm.hf_import import import_llama_state_dict
from merv_tpu_torch.nn.fusion import CrossAttentionAdapterLearnableQuery
from merv_tpu_torch.nn.projectors import AveragePooling3DProjector, LinearProjector

StateDict = Dict[str, torch.Tensor]


def _sub(state: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    p = prefix + "."
    return {k[len(p):]: v for k, v in state.items() if k.startswith(p)}


def convert_projector(module: torch.nn.Module, state: Mapping[str, Any]) -> StateDict:
    """One encoder's projector state dict -> ``module``'s ``state_dict``."""
    if not (isinstance(module, AveragePooling3DProjector) and isinstance(module.projector, LinearProjector)):
        raise NotImplementedError(f"importing a {type(module).__name__} projector is not ported yet (ROADMAP A10)")
    names = ["projector.projector.weight", "projector.projector.bias"]
    if module.projector.pre_proj_layernorm:
        names += ["projector.layernorm.weight", "projector.layernorm.bias"]
    return {n: as_tensor(state[n]) for n in names}


def convert_fusion(module: torch.nn.Module, state: Mapping[str, Any]) -> StateDict:
    """The fusion's state dict (torch ``nn.MultiheadAttention`` layout) -> ``module``'s."""
    if not isinstance(module, CrossAttentionAdapterLearnableQuery):
        raise NotImplementedError(f"importing a {type(module).__name__} fusion is not ported yet (ROADMAP A10)")
    d = module.embed_dim
    if "attention.in_proj_bias" in state:
        in_proj_bias = as_tensor(state["attention.in_proj_bias"])
    else:
        in_proj_bias = torch.zeros(3 * d, dtype=torch.float32)
    out = {"Q": as_tensor(state["Q"])}
    for j, p in enumerate(("q_proj", "k_proj", "v_proj")):
        out[f"attention.{p}.weight"] = as_tensor(state[f"attention.{p}_weight"])
        out[f"attention.{p}.bias"] = in_proj_bias[j * d : (j + 1) * d]
    out["attention.out_proj.weight"] = as_tensor(state["attention.out_proj.weight"])
    out["attention.out_proj.bias"] = as_tensor(state["attention.out_proj.bias"])
    return out


def migrate_legacy_keys(model_state: Dict[str, Any]) -> Dict[str, Any]:
    """``projector`` -> ``projectors`` under ``0.``, ``adapter`` -> ``feature_fusion``."""
    out = dict(model_state)
    if "projector" in out and "projectors" not in out:
        out["projectors"] = {"0." + k: v for k, v in out.pop("projector").items()}
    if "adapter" in out and "feature_fusion" not in out:
        out["feature_fusion"] = out.pop("adapter")
    return out


def import_merv_checkpoint(
    model: Any,
    checkpoint: Any,
    param_dtype: torch.dtype = torch.float32,
    llm_param_dtype: torch.dtype = torch.bfloat16,
) -> Dict[str, StateDict]:
    """A reference checkpoint (a ``.pt`` path, or the loaded dict) -> ``{module key:
    state_dict}`` for ``projectors`` and ``feature_fusion`` (in ``param_dtype``)
    and, where the checkpoint has one, ``llm_backbone`` (in ``llm_param_dtype``)."""
    if not isinstance(checkpoint, dict):
        checkpoint = torch.load(checkpoint, map_location="cpu", weights_only=True)
    model_state = migrate_legacy_keys(checkpoint["model"] if "model" in checkpoint else checkpoint)

    out: Dict[str, StateDict] = {"projectors": {}, "feature_fusion": {}}
    for i, p in enumerate(model.projectors):
        for name, t in convert_projector(p, _sub(model_state["projectors"], str(i))).items():
            out["projectors"][f"{i}.{name}"] = t.to(param_dtype)
    if model.feature_fusion is not None and "feature_fusion" in model_state:
        out["feature_fusion"] = {n: t.to(param_dtype)
                                 for n, t in convert_fusion(model.feature_fusion, model_state["feature_fusion"]).items()}
    if "llm_backbone" in model_state:
        llm_state = {k.removeprefix("llm."): v for k, v in model_state["llm_backbone"].items()}
        decoder = import_llama_state_dict(model.llm_backbone.decoder_config, llm_state, param_dtype=llm_param_dtype)
        out["llm_backbone"] = {f"decoder.{k}": v for k, v in decoder.items()}
    return out
