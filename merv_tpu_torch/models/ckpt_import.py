"""Import a reference-format MERV checkpoint (counterpart of ``merv_tpu/models/ckpt_import.py``).

The released MERV checkpoints (``checkpoints/latest-checkpoint.pt``) hold
``{"model": {"projectors": ..., "feature_fusion": ..., ["llm_backbone": ...]}}``
with torch module state dicts, or the legacy keys ``projector`` (one
encoder) and ``adapter`` (the fusion). This module turns them into the
``state_dict``s of the port's modules, for every projector and fusion
``merv_tpu`` imports:

- the MLP family: a torch ``Sequential`` with its Linears at even indices
  (GELUs between) -> ``projector.<i>``; ``linear`` and its ``layernorm``
  keep their names;
- the resamplers: the inner MLP under ``projector.``; ``3dconv``'s
  ``convolution_pooling.0`` (the Conv3d) -> ``conv``; ``conv``'s two timm
  ``RegStage`` s (``convolution_pooling.0`` / ``.2``, blocks ``b1..bN``) ->
  ``stage1_<i>`` / ``stage2_<i>``; ``attntv``'s ``query_tokens`` and
  ``cross_attn.*`` keep their names;
- the fusions: ``cross_attention*``'s ``nn.MultiheadAttention`` weights
  (``q_proj_weight`` ... and one packed ``in_proj_bias``, zeros when absent)
  become three ``Linear`` s, ``pe`` kept; ``scalar``; the channel-concat
  Linear (``concat_channel_ln`` as ``Sequential(LayerNorm, LinearProjector)``);
  ``query_mlp``'s MLP;

and an ``llm_backbone`` goes through
:func:`~merv_tpu_torch.models.backbones.llm.hf_import.import_llama_state_dict`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from merv_tpu_torch.bridge import as_tensor
from merv_tpu_torch.models.backbones.llm.hf_import import import_llama_state_dict
from merv_tpu_torch.nn.fusion import CrossAttentionAdapterLearnableQuery, ScalarAdapter
from merv_tpu_torch.nn.projectors import (
    AttentivePooler,
    AveragePooling3DProjector,
    AveragePoolingProjector,
    Convolutional3DProjector,
    ConvolutionalProjector,
    Identity,
    LinearProjector,
    MLPProjector,
)

StateDict = Dict[str, torch.Tensor]


def _sub(state: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    p = prefix + "."
    return {k[len(p):]: v for k, v in state.items() if k.startswith(p)}


def _prefixed(prefix: str, sd: StateDict) -> StateDict:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def _copy(state: Mapping[str, Any], src: str, dst: str, out: StateDict) -> None:
    """``src.weight`` (and ``src.bias`` where present) -> ``dst.*``."""
    out[f"{dst}.weight"] = as_tensor(state[f"{src}.weight"])
    if f"{src}.bias" in state:
        out[f"{dst}.bias"] = as_tensor(state[f"{src}.bias"])


def _mlp_projector(state: Mapping[str, Any], module: torch.nn.Module) -> StateDict:
    """A LinearProjector / MLP-family / Identity torch state dict -> ``module``'s."""
    out: StateDict = {}
    if isinstance(module, Identity):
        return out
    if isinstance(module, LinearProjector):
        _copy(state, "projector", "projector", out)
    elif isinstance(module, MLPProjector):  # and its deep and fused subclasses
        lin_idxs = sorted({int(k.split(".")[1]) for k in state if k.startswith("projector.") and k.endswith(".weight")})
        for i, t in enumerate(lin_idxs):
            _copy(state, f"projector.{t}", f"projector.{i}", out)
    else:
        raise TypeError(f"not an MLP-family projector: {type(module).__name__}")
    if module.pre_proj_layernorm:
        _copy(state, "layernorm", "layernorm", out)
    return out


def _reg_block(state: Mapping[str, Any], pre: str, dst: str, out: StateDict) -> None:
    """One timm RegNet bottleneck (``conv1/2/3.{conv,bn}``, ``se.fc1/fc2``, ``downsample``)."""
    names = ["conv1", "conv2", "conv3"] + (["downsample"] if f"{pre}.downsample.conv.weight" in state else [])
    for n in names:
        out[f"{dst}.{n}.conv.weight"] = as_tensor(state[f"{pre}.{n}.conv.weight"])
        _copy(state, f"{pre}.{n}.bn", f"{dst}.{n}.bn", out)
    for n in ("se.fc1", "se.fc2"):
        _copy(state, f"{pre}.{n}", f"{dst}.{n}", out)


def convert_projector(module: torch.nn.Module, state: Mapping[str, Any]) -> StateDict:
    """One encoder's projector state dict -> ``module``'s ``state_dict``."""
    if isinstance(module, (LinearProjector, MLPProjector, Identity)):
        return _mlp_projector(state, module)
    out = _prefixed("projector", _mlp_projector(_sub(state, "projector"), module.projector))
    if isinstance(module, (AveragePooling3DProjector, AveragePoolingProjector)):
        return out
    if isinstance(module, Convolutional3DProjector):  # Sequential(Conv3d, AdaptiveAvgPool3d)
        _copy(state, "convolution_pooling.0", "conv", out)
        return out
    if isinstance(module, AttentivePooler):
        out["query_tokens"] = as_tensor(state["query_tokens"])
        for n in ("norm1", "norm2", "xattn.q", "xattn.kv", "xattn.proj", "mlp.fc1", "mlp.fc2"):
            _copy(state, f"cross_attn.{n}", f"cross_attn.{n}", out)
        return out
    if isinstance(module, ConvolutionalProjector):  # Sequential(RegStage, AdaptiveAvgPool2d, RegStage)
        for stage, seq_idx in (("stage1", 0), ("stage2", 2)):
            for i in range(module.block_depth):
                _reg_block(state, f"convolution_pooling.{seq_idx}.b{i + 1}", f"{stage}_{i}", out)
        return out
    raise TypeError(f"no checkpoint import for a {type(module).__name__} projector")


def convert_fusion(module: torch.nn.Module, state: Mapping[str, Any]) -> StateDict:
    """The fusion's torch state dict -> ``module``'s ``state_dict``."""
    if isinstance(module, ScalarAdapter):
        return {"scalar": as_tensor(state["scalar"])}
    if isinstance(module, LinearProjector):  # concat_channel[_ln]
        if "0.weight" in state:  # the reference's Sequential(LayerNorm, LinearProjector)
            out: StateDict = {}
            _copy(state, "0", "layernorm", out)
            _copy(state, "1.projector", "projector", out)
            return out
        return _mlp_projector(state, module)
    if isinstance(module, MLPProjector):  # query_mlp
        return _mlp_projector(state, module)
    if not isinstance(module, CrossAttentionAdapterLearnableQuery):
        raise TypeError(f"no checkpoint import for a {type(module).__name__} fusion")
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
    if "pe" in state:
        out["pe"] = as_tensor(state["pe"])
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
