"""The system under test, built from a configuration file through the port's public entry points.

The port's own factories build the model on the ``meta`` device from the
file's sizes (the towers' ``ViTConfig`` and the LLM's ``DecoderConfig``
replaced field by field), so building costs no memory; its storage is then
made on the device and filled by :func:`benchmark.weights.draw`. The
parameter names and shapes must equal the reference's (``reference.merv.spec``):
a difference is an error, not a skip.

- ``serving_model``: ``load_vid``'s serving layout: every float leaf in bf16,
  the LLM packed (``pack_serving_params``); with ``int8`` its Linears then
  quantized (``quantize_tree``), the int8 path the serving control runs.
- ``training_model``: what ``cli/pretrain.py`` builds for the align stage:
  towers, LLM, projectors and fusion stored in fp32 (the strategy's set-up
  casts the frozen towers to bf16), ``freeze_backbones("align")``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from benchmark import weights
from benchmark.reference import merv as ref

META = torch.device("meta")


def _towers(cfg: dict, param_dtype: torch.dtype, compute_dtype: torch.dtype):
    from merv_tpu_torch.models.materialize import VIDEO_BACKBONES

    m = cfg["merv"]
    out = []
    for t in m["towers"]:
        entry = VIDEO_BACKBONES[t["id"]]
        kwargs = dict(entry["kwargs"], default_image_size=t["image_size"])
        probe = entry["cls"](t["id"], m["image_resize_strategy"], num_frames=t["frames"], device=META, **kwargs)
        sizes = {k: t[k] for k in ("image_size", "patch_size", "hidden_size", "intermediate_size", "num_layers",
                                   "num_heads", "num_cls_tokens", "num_register_tokens", "pos_embed_includes_prefix",
                                   "act", "layer_norm_eps", "use_layerscale", "pre_norm", "patch_bias", "tubelet_t")}
        if t["temporal_attn"]:
            sizes["temporal_frames"] = t["temporal_frames"]
        if t["tubelet_t"]:
            sizes["tubelet_frames"] = t["frames"]
        vit = dataclasses.replace(probe.default_vit_config(), **sizes, compute_dtype=compute_dtype,
                                  param_dtype=param_dtype)
        if vit.temporal_attn != t["temporal_attn"]:
            raise ValueError(f"{t['id']}: the port's tower has temporal attention {vit.temporal_attn}")
        out.append(entry["cls"](t["id"], m["image_resize_strategy"], num_frames=t["frames"], vit_config=vit,
                                device=META, **kwargs))
    return out


def _llm(cfg: dict, inference_mode: bool, compute_dtype: torch.dtype):
    from merv_tpu_torch.models.backbones.llm.base_llm import LLM_SPECS, LLMBackbone

    spec = LLM_SPECS[cfg["llm_backbone_id"]]
    dcfg = dataclasses.replace(
        spec.decoder_config, vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"], num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"], num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["hidden_size"] // cfg["num_attention_heads"], rope_theta=cfg["rope_theta"],
        rms_norm_eps=cfg["rms_norm_eps"], tie_word_embeddings=cfg["tie_word_embeddings"],
        max_position_embeddings=cfg["max_position_embeddings"], compute_dtype=compute_dtype)
    spec = dataclasses.replace(spec, decoder_config=dcfg)
    return LLMBackbone(cfg["llm_backbone_id"], llm_max_length=cfg["merv"]["llm_max_length"], spec=spec,
                       inference_mode=inference_mode, device=META)


def _vidlm(cfg: dict, towers, llm, param_dtype: torch.dtype):
    from merv_tpu_torch.models.materialize import get_vidlm

    m = cfg["merv"]
    return get_vidlm(m["model_id"], m["arch_specifier"], m["feature_fusion"], towers, llm,
                     projector_token_length=m["projector_token_length"],
                     visual_feature_length=m["visual_feature_length"], param_dtype=param_dtype, device=META)


def check_names(model: torch.nn.Module, cfg: dict) -> None:
    """The program's parameters must be the reference's, name for name and shape for shape."""
    mine = {n: tuple(p.shape) for n, p in model.named_parameters()}
    theirs = dict(ref.spec(cfg))
    if mine != theirs:
        extra = sorted(set(mine) - set(theirs))[:5]
        missing = sorted(set(theirs) - set(mine))[:5]
        shapes = [(n, mine[n], theirs[n]) for n in mine if n in theirs and mine[n] != theirs[n]][:5]
        raise RuntimeError(f"the program's parameters differ from the reference's: only the program's {extra}, "
                           f"only the reference's {missing}, shapes {shapes}")


def _fill(model: torch.nn.Module, cfg: dict, device: torch.device, seed: int) -> None:
    left = [f"{name}.{k}" for name, m in model.named_modules() for k, v in vars(m).items()
            if isinstance(v, torch.Tensor) and v.is_meta]
    if left:
        raise RuntimeError(f"tensors outside the parameters and buffers stay on meta: {left[:5]}")
    model.to_empty(device=device)
    params = dict(model.named_parameters())
    weights.draw(ref.spec(cfg), seed, device, lambda name, shape: params[name].data)


def serving_model(cfg: dict, device: torch.device, seed: int, int8: bool = False,
                  compute_dtype: torch.dtype = torch.bfloat16) -> Any:
    from merv_tpu_torch.models.backbones.llm.transformer import pack_serving_params, round_to_compute_dtype
    from merv_tpu_torch.nn.quantization import quantize_tree

    towers = _towers(cfg, compute_dtype, compute_dtype)
    llm = _llm(cfg, True, compute_dtype)
    vidlm = _vidlm(cfg, towers, llm, compute_dtype)
    check_names(vidlm, cfg)
    vidlm.to(compute_dtype)  # on meta: dtypes only
    _fill(vidlm, cfg, device, seed)
    pack_serving_params(llm.decoder)
    if int8:
        quantize_tree(llm)
    round_to_compute_dtype(llm.decoder)
    return vidlm.eval()


def training_model(cfg: dict, device: torch.device, seed: int,
                   compute_dtype: torch.dtype = torch.bfloat16) -> Tuple[Any, list]:
    """The align stage's model and its towers' transforms."""
    towers = _towers(cfg, torch.float32, compute_dtype)
    llm = _llm(cfg, False, compute_dtype)
    vidlm = _vidlm(cfg, towers, llm, torch.float32)
    check_names(vidlm, cfg)
    _fill(vidlm, cfg, device, seed)
    vidlm.train()
    vidlm.freeze_backbones(cfg["align"]["stage"])
    return vidlm, [vb.get_video_transform() for vb in vidlm.video_backbones]
