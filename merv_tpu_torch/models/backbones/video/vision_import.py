"""Tower checkpoint import: timm / HF state dicts -> the port's ViT ``state_dict``
(counterpart of ``merv_tpu/models/backbones/video/vision_import.py``).

The three namings the main-path towers come in:
- ``timm`` (DINOv2, SigLIP): ``blocks.<i>.attn.qkv`` fused, split here;
- ``hf_clip`` (LanguageBind, SigLIP through HF): ``encoder.layers.<i>.self_attn``,
  with LanguageBind's ``temporal_attn`` / ``temporal_embedding`` keys and
  CLIP's ``pre_layrnorm`` spelling;
- ``hf_vit`` (ViViT, DINOv2 through HF): ``encoder.layer.<i>.attention.attention``.

Each writes straight into :class:`VisionTransformer`'s names. Linear weights
keep torch's ``(out, in)`` layout; a Conv2d / Conv3d patch weight is laid out
as the patchify matmul reads it, ``(out, p*p*C)`` / ``(out, t*p*p*C)``; a
position-embedding grid of another resolution is resampled (bicubic,
antialiased, as timm's ``resample_abs_pos_embed``). Every value is rounded to
``param_dtype`` (``VideoBackbone.import_state_dict`` passes bf16, as
``merv_tpu``'s ``load_state_dict`` does).

:func:`load_pretrained_tower` reads only ``$MERV_TPU_TOWER_DIR/{identifier}.safetensors``
(``scripts/export_towers.py`` writes such files). ``merv_tpu``'s timm and
HF-cache routes are not ported: without the file it raises, naming that script.
"""

from __future__ import annotations

import math
import os
from pathlib import Path
from typing import Any, Dict, Mapping

import torch
import torch.nn.functional as F

from merv_tpu_torch.bridge import as_tensor
from merv_tpu_torch.models.backbones.video.vit import ViTConfig


def _resample_pos_embed(pos: torch.Tensor, src_grid: int, dst_grid: int) -> torch.Tensor:
    """Bicubic-antialias resample of a [G*G, D] grid to [g*g, D] (timm-equivalent)."""
    if src_grid == dst_grid:
        return pos
    D = pos.shape[-1]
    t = pos.float().reshape(1, src_grid, src_grid, D).permute(0, 3, 1, 2)
    t = F.interpolate(t, size=(dst_grid, dst_grid), mode="bicubic", antialias=True)
    return t.permute(0, 2, 3, 1).reshape(dst_grid * dst_grid, D)


def _patch_weight(w: torch.Tensor) -> torch.Tensor:
    """[D, C, p, p] (Conv2d) or [D, C, t, p, p] (Conv3d) -> [D, (t*)p*p*C]."""
    return w.permute(0, *range(2, w.ndim), 1).reshape(w.shape[0], -1)


def _detect_naming(state: Mapping[str, Any]) -> str:
    keys = list(state.keys())
    if any(k.startswith("blocks.0.") or k.endswith("patch_embed.proj.weight") for k in keys):
        return "timm"
    if any(".self_attn.q_proj." in k for k in keys):
        return "hf_clip"
    if any(".attention.attention.query." in k for k in keys):
        return "hf_vit"
    raise ValueError(f"Unrecognized vision state dict naming; sample keys: {keys[:8]}")


def _strip_prefix(state: Mapping[str, Any]) -> Dict[str, Any]:
    """Remove a leading 'vision_model.' / 'vivit.' / 'dinov2.' / 'model.' wrapper."""
    out = {}
    for k, v in state.items():
        for pre in ("vision_model.", "vivit.", "dinov2.", "model."):
            if k.startswith(pre):
                k = k[len(pre):]
                break
        out[k] = v
    return out


def import_vision_state_dict(
    cfg: ViTConfig, raw_state: Mapping[str, Any], *, param_dtype: torch.dtype = torch.float32
) -> Dict[str, torch.Tensor]:
    """A timm / HF tower state dict -> the ``state_dict`` of ``VisionTransformer(cfg)``."""
    state = _strip_prefix(raw_state)
    naming = _detect_naming(state)
    D, L = cfg.hidden_size, cfg.num_layers
    out: Dict[str, torch.Tensor] = {}

    def get(key: str) -> torch.Tensor:
        return as_tensor(state[key])

    def copy(dst: str, src: str) -> None:
        """``src.weight`` (and ``src.bias`` where present) -> ``dst.*``."""
        out[f"{dst}.weight"] = get(f"{src}.weight")
        if f"{src}.bias" in state:
            out[f"{dst}.bias"] = get(f"{src}.bias")

    def attn(dst: str, names: Mapping[str, str]) -> None:
        for ours, theirs in names.items():
            copy(f"{dst}.{ours}", theirs)

    if naming == "timm":
        out["patch_embed.weight"] = _patch_weight(get("patch_embed.proj.weight"))
        if cfg.patch_bias:
            out["patch_embed.bias"] = get("patch_embed.proj.bias")
        pos = get("pos_embed")[0]  # [N(+1), D]
        if "cls_token" in state:
            out["cls_token"] = get("cls_token")[0]
        if "reg_token" in state:
            out["register_tokens"] = get("reg_token")[0]
        copy("final_norm", "norm")

        def layer(i: int) -> None:
            pre, dst = f"blocks.{i}", f"layers.{i}"
            copy(f"{dst}.norm1", f"{pre}.norm1")
            w = get(f"{pre}.attn.qkv.weight")  # [3D, D]
            b = get(f"{pre}.attn.qkv.bias") if f"{pre}.attn.qkv.bias" in state else None
            for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
                out[f"{dst}.attn.{name}.weight"] = w[j * D : (j + 1) * D]
                if b is not None:
                    out[f"{dst}.attn.{name}.bias"] = b[j * D : (j + 1) * D]
            copy(f"{dst}.attn.o_proj", f"{pre}.attn.proj")
            copy(f"{dst}.norm2", f"{pre}.norm2")
            copy(f"{dst}.mlp.fc1", f"{pre}.mlp.fc1")
            copy(f"{dst}.mlp.fc2", f"{pre}.mlp.fc2")
            if cfg.use_layerscale:
                out[f"{dst}.ls1.gamma"] = get(f"{pre}.ls1.gamma")
                out[f"{dst}.ls2.gamma"] = get(f"{pre}.ls2.gamma")

    elif naming == "hf_clip":  # CLIP / SigLIP / LanguageBind
        out["patch_embed.weight"] = _patch_weight(get("embeddings.patch_embedding.weight"))
        if cfg.patch_bias:
            out["patch_embed.bias"] = get("embeddings.patch_embedding.bias")
        pos = get("embeddings.position_embedding.weight")
        if "embeddings.class_embedding" in state:
            out["cls_token"] = get("embeddings.class_embedding").reshape(1, D)
        if "pre_layrnorm.weight" in state:  # LanguageBind keeps CLIP's typo
            copy("pre_norm", "pre_layrnorm")
        elif "pre_layernorm.weight" in state:
            copy("pre_norm", "pre_layernorm")
        copy("final_norm", "post_layernorm")
        projections = ("q_proj", "k_proj", "v_proj")

        def layer(i: int) -> None:
            pre, dst = f"encoder.layers.{i}", f"layers.{i}"
            copy(f"{dst}.norm1", f"{pre}.layer_norm1")
            attn(f"{dst}.attn", {**{p: f"{pre}.self_attn.{p}" for p in projections},
                                 "o_proj": f"{pre}.self_attn.out_proj"})
            copy(f"{dst}.norm2", f"{pre}.layer_norm2")
            copy(f"{dst}.mlp.fc1", f"{pre}.mlp.fc1")
            copy(f"{dst}.mlp.fc2", f"{pre}.mlp.fc2")
            if cfg.temporal_attn:
                out[f"{dst}.temporal_embedding"] = get(f"{pre}.temporal_embedding")[0]
                copy(f"{dst}.t_norm", f"{pre}.temporal_layer_norm1")
                attn(f"{dst}.t_attn", {**{p: f"{pre}.temporal_attn.{p}" for p in projections},
                                       "o_proj": f"{pre}.temporal_attn.out_proj"})

    else:  # hf_vit (DINOv2 / ViViT)
        out["patch_embed.weight"] = _patch_weight(get("embeddings.patch_embeddings.projection.weight"))
        if cfg.patch_bias:
            out["patch_embed.bias"] = get("embeddings.patch_embeddings.projection.bias")
        pos = get("embeddings.position_embeddings")[0]
        if "embeddings.cls_token" in state:
            out["cls_token"] = get("embeddings.cls_token")[0]
        if "embeddings.register_tokens" in state:
            out["register_tokens"] = get("embeddings.register_tokens")[0]
        copy("final_norm", "layernorm")

        def layer(i: int) -> None:
            pre, dst = f"encoder.layer.{i}", f"layers.{i}"
            if f"{pre}.norm1.weight" in state:  # DINOv2
                names = dict(norm1="norm1", norm2="norm2", fc1="mlp.fc1", fc2="mlp.fc2")
            else:  # ViT / ViViT
                names = dict(norm1="layernorm_before", norm2="layernorm_after", fc1="intermediate.dense",
                             fc2="output.dense")
            copy(f"{dst}.norm1", f"{pre}.{names['norm1']}")
            attn(f"{dst}.attn", {"q_proj": f"{pre}.attention.attention.query",
                                 "k_proj": f"{pre}.attention.attention.key",
                                 "v_proj": f"{pre}.attention.attention.value",
                                 "o_proj": f"{pre}.attention.output.dense"})
            copy(f"{dst}.norm2", f"{pre}.{names['norm2']}")
            copy(f"{dst}.mlp.fc1", f"{pre}.{names['fc1']}")
            copy(f"{dst}.mlp.fc2", f"{pre}.{names['fc2']}")
            if cfg.use_layerscale:
                out[f"{dst}.ls1.gamma"] = get(f"{pre}.layer_scale1.lambda1")
                out[f"{dst}.ls2.gamma"] = get(f"{pre}.layer_scale2.lambda1")

    # position embedding: split the prefix rows, resample the patch grid to the
    # config's resolution, and put back the prefix convention the config expects
    # (a zero prefix row == no position added to cls, timm's no_embed_class)
    n_prefix_rows = pos.shape[0] - int(round(math.sqrt(pos.shape[0]))) ** 2
    prefix_pos, grid_pos = pos[: max(n_prefix_rows, 0)], pos[max(n_prefix_rows, 0):]
    src_grid = int(round(math.sqrt(grid_pos.shape[0])))
    if cfg.tubelet_t:
        # ViViT: rows are (T/t)*g*g (+ cls); the temporal axis is not resampled
        g2 = cfg.grid_size ** 2
        if grid_pos.shape[0] % g2:
            raise ValueError(f"ViViT position rows {grid_pos.shape[0]} are not a multiple of the {g2}-patch grid")
    elif src_grid != cfg.grid_size:
        grid_pos = _resample_pos_embed(grid_pos, src_grid, cfg.grid_size)
    if cfg.pos_embed_includes_prefix and cfg.num_cls_tokens:
        if n_prefix_rows >= cfg.num_cls_tokens:
            pos = torch.cat([prefix_pos[: cfg.num_cls_tokens], grid_pos], dim=0)
        else:  # no cls row in the checkpoint (timm no_embed_class): a zero row adds nothing
            pos = torch.cat([torch.zeros((cfg.num_cls_tokens, D), dtype=grid_pos.dtype), grid_pos], dim=0)
    else:
        pos = grid_pos
    out["pos_embed"] = pos

    for i in range(L):
        layer(i)
    return {k: v.to(param_dtype) if v.is_floating_point() else v for k, v in out.items()}


def load_pretrained_tower(backbone: Any) -> None:
    """Import a tower's weights into ``backbone`` from
    ``$MERV_TPU_TOWER_DIR/{identifier}.safetensors``; raises ``FileNotFoundError``
    when there is no such file. Callers decide whether random init is acceptable."""
    from merv_tpu_torch.util.safetensors_io import load_file

    ident = backbone.identifier
    if "hiera" in ident:
        raise NotImplementedError(f"Hiera's checkpoint layout ({ident}) is not ported yet (ROADMAP A10)")
    tower_dir = os.environ.get("MERV_TPU_TOWER_DIR")
    if tower_dir:
        f = Path(tower_dir) / f"{ident}.safetensors"
        if f.exists():
            backbone.import_state_dict(load_file(f))
            return
    raise FileNotFoundError(
        f"No pretrained source for {ident}: run scripts/export_towers.py to produce "
        f"$MERV_TPU_TOWER_DIR/{ident}.safetensors (the port reads no timm or HF cache)"
    )
