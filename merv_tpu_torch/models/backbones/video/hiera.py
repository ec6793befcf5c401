"""Hiera video backbone: a hierarchical ViT with mask-unit attention
(counterpart of ``merv_tpu/models/backbones/video/hiera.py``).

``facebook/hiera_{base,base_plus,large}_16x224`` video models: frames grouped
into clips of 16, a Conv3d patch embed (kernel 3x7x7, stride 2x4x4) and a
separable position embedding, then four stages with channel doubling, query
max-pooling between stages (q_stride 1x2x2, q_pool = 3), mask-unit attention
in the early stages and global attention later. The feature tap is the final
stage's output before its norm, spatially re-rolled; ``embed_dim`` is
``embed_dim * 2 ** q_pool``.

Tokens are "unrolled" after the embedding (:func:`_unroll`), so that each
mask unit is contiguous and a query pooling is a max over the leading
stride blocks. The attention is plain torch (a materialized softmax over
``[B, heads, windows, tokens, tokens]``), as ``merv_tpu`` computes it with
plain einsums: no kernel of the port runs here. Parameter names follow
``merv_tpu``'s tree (``patch_embed.weight`` is its OIDHW kernel,
``blocks.<i>.attn.qkv``, ...), so the bridge maps by name.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from merv_tpu_torch.bridge import as_tensor
from merv_tpu_torch.device import resolve_device
from merv_tpu_torch.models.backbones.video.base_video import VideoBackbone
from merv_tpu_torch.nn.core import LayerNorm, Linear, gelu, trunc_normal_
from merv_tpu_torch.preprocessing.transforms import HIERA_MEAN, HIERA_STD, VideoTransform


@dataclass(frozen=True)
class HieraConfig:
    input_size: Tuple[int, int, int] = (16, 224, 224)  # (T, H, W)
    patch_kernel: Tuple[int, int, int] = (3, 7, 7)
    patch_stride: Tuple[int, int, int] = (2, 4, 4)
    patch_padding: Tuple[int, int, int] = (1, 3, 3)
    embed_dim: int = 96
    num_heads: int = 1
    stages: Tuple[int, ...] = (2, 3, 16, 3)
    q_pool: int = 3
    q_stride: Tuple[int, int, int] = (1, 2, 2)
    mask_unit_size: Tuple[int, int, int] = (1, 8, 8)
    mask_unit_attn: Tuple[bool, ...] = (True, True, False, False)
    dim_mul: float = 2.0
    head_mul: float = 2.0
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def tokens_shape(self) -> Tuple[int, int, int]:
        return tuple(i // s for i, s in zip(self.input_size, self.patch_stride))  # type: ignore[return-value]

    @property
    def num_tokens(self) -> int:
        return int(np.prod(self.tokens_shape))

    @property
    def final_dim(self) -> int:
        return int(self.embed_dim * self.dim_mul ** (len(self.stages) - 1))

    @property
    def flat_mu_size(self) -> int:
        return int(np.prod(self.mask_unit_size))

    @property
    def flat_q_stride(self) -> int:
        return int(np.prod(self.q_stride))

    def layer_plan(self) -> List[Dict[str, Any]]:
        """Per layer: dim_in, dim_out, heads, q_stride, window, use_mu (merv_tpu's plan)."""
        cumulative = np.cumsum(self.stages).tolist()
        pool_layers = set(cumulative[: self.q_pool])
        plan: List[Dict[str, Any]] = []
        dim_in = self.embed_dim
        for i in range(sum(self.stages)):
            stage_idx = next(s for s, c in enumerate(cumulative) if i < c)
            dim_out = int(self.embed_dim * self.dim_mul ** stage_idx)
            first_of_stage = i == ([0] + cumulative)[stage_idx]
            plan.append(dict(
                dim_in=dim_in, dim_out=dim_out, heads=int(self.num_heads * self.head_mul ** stage_idx),
                q_stride=self.flat_q_stride if i in pool_layers else 1,
                window=int(self.flat_mu_size * self.flat_q_stride ** -stage_idx),
                use_mu=self.mask_unit_attn[stage_idx] or (
                    first_of_stage and stage_idx > 0 and self.mask_unit_attn[stage_idx - 1]),
            ))
            dim_in = dim_out
        return plan


HIERA_CONFIGS: Dict[str, HieraConfig] = {
    "hiera_base_16x224": HieraConfig(embed_dim=96, num_heads=1, stages=(2, 3, 16, 3)),
    "hiera_base_plus_16x224": HieraConfig(embed_dim=112, num_heads=2, stages=(2, 3, 16, 3)),
    "hiera_large_16x224": HieraConfig(embed_dim=144, num_heads=2, stages=(2, 6, 36, 4)),
}

HIERA_VIDEO_BACKBONES = {
    "hiera-base-video": "facebook/hiera_base_16x224.mae_k400_ft_k400",
    "hiera-base-video-noft": "facebook/hiera_base_16x224.mae_k400",
    "hiera-base-plus-video": "facebook/hiera_base_plus_16x224.mae_k400_ft_k400",
    "hiera-base-plus-video-noft": "facebook/hiera_base_plus_16x224.mae_k400",
    "hiera-large-video": "facebook/hiera_large_16x224.mae_k400_ft_k400",
    "hiera-large-video-noft": "facebook/hiera_large_16x224.mae_k400",
}


def _unroll(x: torch.Tensor, size: Sequence[int], schedule: Sequence[Sequence[int]]) -> torch.Tensor:
    """Reorder tokens so that the stride blocks lead: [B, prod(size), C] in
    (t, h, w) order -> [B, prod(size), C] unrolled (mask units contiguous)."""
    B, _, C = x.shape
    cur = list(size)
    x = x.reshape(B, *cur, C)
    batch = B
    for strides in schedule:
        cur = [i // s for i, s in zip(cur, strides)]
        shape = [batch] + [v for pair in zip(cur, strides) for v in pair] + [C]
        x = x.reshape(shape)
        n = len(shape)
        x = x.permute([0] + list(range(2, n - 1, 2)) + list(range(1, n - 1, 2)) + [n - 1])
        batch *= int(np.prod(strides))
        x = x.reshape(batch, *cur, C)
    return x.reshape(B, int(np.prod(size)), C)


def _reroll(x: torch.Tensor, size: Sequence[int], schedule: Sequence[Sequence[int]]) -> torch.Tensor:
    """The inverse of :func:`_unroll` for a remaining ``schedule`` -> [B, *size, C] in spatial order."""
    B, seq, C = x.shape
    nd = len(size)
    mu_shape = [1] * nd
    for strides in schedule:
        sp = int(np.prod(list(strides)))
        x = x.reshape(B, *strides, seq // sp, *mu_shape, C)
        perm = [0, nd + 1]
        for i in range(nd):
            perm += [1 + i, nd + 2 + i]
        x = x.permute(perm + [2 * nd + 2])
        mu_shape = [m * s for m, s in zip(mu_shape, strides)]
        x = x.reshape(B, -1, *mu_shape, C)
        seq = x.shape[1]
    num_mu = [s // m for s, m in zip(size, mu_shape)]
    x = x.reshape(B, *num_mu, *mu_shape, C)
    perm = [0]
    for i in range(nd):
        perm += [1 + i, 1 + nd + i]
    return x.permute(perm + [1 + 2 * nd]).reshape(B, *size, C)


class _Attention(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, kw: dict) -> None:
        super().__init__()
        self.qkv = Linear(dim_in, 3 * dim_out, **kw)
        self.proj = Linear(dim_out, dim_out, **kw)


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, kw: dict) -> None:
        super().__init__()
        self.fc1 = Linear(dim, hidden, **kw)
        self.fc2 = Linear(hidden, dim, **kw)


class HieraBlock(nn.Module):
    """One Hiera layer: [q-pooled] residual + mask-unit / global attention, then the MLP."""

    def __init__(self, cfg: HieraConfig, lp: Dict[str, Any], device=None) -> None:
        super().__init__()
        self.cfg, self.lp = cfg, lp
        kw = dict(param_dtype=cfg.param_dtype, device=device, init_std=0.02, init_trunc=True)
        d_in, d_out = lp["dim_in"], lp["dim_out"]
        self.norm1 = LayerNorm(d_in, eps=cfg.layer_norm_eps, param_dtype=cfg.param_dtype, device=device)
        self.attn = _Attention(d_in, d_out, kw)
        self.norm2 = LayerNorm(d_out, eps=cfg.layer_norm_eps, param_dtype=cfg.param_dtype, device=device)
        self.mlp = _MLP(d_out, int(d_out * cfg.mlp_ratio), kw)
        if d_in != d_out:
            self.proj = Linear(d_in, d_out, **kw)

    def _attention(self, x: torch.Tensor) -> torch.Tensor:
        """Mask-unit or global attention with query pooling, on unrolled tokens."""
        lp = self.lp
        B, N, _ = x.shape
        d_out, heads, qs = lp["dim_out"], lp["heads"], lp["q_stride"]
        hd = d_out // heads
        windows = N // (qs * lp["window"]) if lp["use_mu"] else 1
        qkv = self.attn.qkv(x).reshape(B, N // windows, windows, 3, heads, hd).permute(3, 0, 4, 2, 1, 5)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [B, heads, windows, tokens, hd]
        if qs > 1:
            q = q.reshape(B, heads, windows, qs, -1, hd).amax(dim=3)
        logits = torch.einsum("bhwqd,bhwkd->bhwqk", q.float(), k.float()) * hd ** -0.5
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhwqk,bhwkd->bhwqd", probs, v)
        return self.attn.proj(out.permute(0, 3, 2, 1, 4).reshape(B, -1, d_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lp = self.lp
        normed = self.norm1(x)
        if lp["dim_in"] != lp["dim_out"]:
            x = self.proj(normed)
        if lp["q_stride"] > 1:
            x = x.reshape(x.shape[0], lp["q_stride"], -1, lp["dim_out"]).amax(dim=1)
        x = x + self._attention(normed)
        return x + self.mlp.fc2(gelu(self.mlp.fc1(self.norm2(x))))


class _PatchEmbed(nn.Module):
    """Conv3d patch embedding; ``weight`` [D, 3, kt, kh, kw] (OIDHW, merv_tpu's kernel as it lies)."""

    def __init__(self, cfg: HieraConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        shape = (cfg.embed_dim, 3, *cfg.patch_kernel)
        self.weight = nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(cfg.embed_dim, dtype=cfg.param_dtype, device=device), requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.weight, 0.02, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """[B, C, T, H, W] -> [B, t*h*w, D] in (t, h, w) order."""
        c = self.cfg
        dt = c.compute_dtype
        y = F.conv3d(pixels.to(dt), self.weight.to(dt), stride=c.patch_stride, padding=c.patch_padding)
        y = y + self.bias.to(dt)[None, :, None, None, None]
        return y.flatten(2).transpose(1, 2)


class HieraModel(nn.Module):
    def __init__(self, cfg: HieraConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        t, h, w = cfg.tokens_shape
        self.patch_embed = _PatchEmbed(cfg, device)
        self.pos_embed_spatial = nn.Parameter(
            torch.empty(h * w, cfg.embed_dim, dtype=cfg.param_dtype, device=device), requires_grad=False)
        self.pos_embed_temporal = nn.Parameter(
            torch.empty(t, cfg.embed_dim, dtype=cfg.param_dtype, device=device), requires_grad=False)
        self.blocks = nn.ModuleList([HieraBlock(cfg, lp, device) for lp in cfg.layer_plan()])

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.pos_embed_spatial, 0.02, generator)
        trunc_normal_(self.pos_embed_temporal, 0.02, generator)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels [B, C, T, H, W] -> the final stage's tokens [B, t' h' w', final_dim]
        (``Hiera.forward(return_intermediates=True)[1][-1]``, flattened)."""
        c = self.cfg
        x = self.patch_embed(pixels)
        t, h, w = c.tokens_shape
        pos = self.pos_embed_spatial.to(x.dtype).repeat(t, 1) + \
            self.pos_embed_temporal.to(x.dtype).repeat_interleave(h * w, dim=0)
        x = _unroll(x + pos[None], c.tokens_shape, [list(c.q_stride)] * (len(c.stages) - 1))
        for blk in self.blocks:
            x = blk(x)
        # every unroll stride is consumed by the last stage: the tokens are in spatial order
        qt = [t // c.q_stride[0] ** c.q_pool, h // c.q_stride[1] ** c.q_pool, w // c.q_stride[2] ** c.q_pool]
        if x.shape[1] != int(np.prod(qt)):
            raise ValueError(f"Hiera: {x.shape[1]} final tokens, expected {qt}")
        return x.reshape(x.shape[0], -1, c.final_dim)


def import_hiera_state_dict(
    cfg: HieraConfig, state: Mapping[str, Any], param_dtype: torch.dtype = torch.bfloat16
) -> Dict[str, torch.Tensor]:
    """An original-repo Hiera state dict (``blocks.<i>.*``) -> ``HieraModel(cfg)``'s ``state_dict``."""
    def get(k: str) -> torch.Tensor:
        return as_tensor(state[k]).float()

    out = {
        "patch_embed.weight": get("patch_embed.proj.weight"),
        "patch_embed.bias": get("patch_embed.proj.bias"),
        "pos_embed_spatial": get("pos_embed_spatial")[0],
        "pos_embed_temporal": get("pos_embed_temporal")[0],
    }
    names = ["norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1", "mlp.fc2"]
    for i, lp in enumerate(cfg.layer_plan()):
        for n in names + (["proj"] if lp["dim_in"] != lp["dim_out"] else []):
            out[f"blocks.{i}.{n}.weight"] = get(f"blocks.{i}.{n}.weight")
            out[f"blocks.{i}.{n}.bias"] = get(f"blocks.{i}.{n}.bias")
    return {k: v.to(param_dtype) for k, v in out.items()}


class HieraVideoBackbone(VideoBackbone):
    """``video_values`` [B, F, C, H, W] (F a multiple of 16) -> [B, num_patches, embed_dim]:
    the frames in clips of 16, each clip's final-stage tokens, clip after clip.
    ``hiera_config`` may be overridden (tests build tiny towers that way)."""

    def __init__(
        self,
        video_backbone_id: str,
        image_resize_strategy: str,
        default_image_size: int = 224,
        num_frames: int = 16,
        hiera_config: Optional[HieraConfig] = None,
        param_dtype: Optional[torch.dtype] = None,
        device: Optional[torch.device] = None,
    ) -> None:
        super().__init__(video_backbone_id, image_resize_strategy, default_image_size, num_frames, None, param_dtype)
        if video_backbone_id not in HIERA_VIDEO_BACKBONES:
            raise ValueError(video_backbone_id)
        if num_frames % 16:
            raise ValueError("Hiera processes clips of 16 frames")
        arch = HIERA_VIDEO_BACKBONES[video_backbone_id].split("/")[-1].split(".")[0]
        cfg = hiera_config if hiera_config is not None else HIERA_CONFIGS[arch]
        self.hiera_config = dataclasses.replace(cfg, param_dtype=param_dtype) if param_dtype is not None else cfg
        self.video_transform = VideoTransform(
            target_size=default_image_size, resize_strategy=image_resize_strategy, shortest_edge=256,
            interpolation="bilinear", mean=HIERA_MEAN, std=HIERA_STD,
        )
        self.model = HieraModel(self.hiera_config, device=resolve_device(device))

    def default_vit_config(self):
        raise NotImplementedError("Hiera is a HieraModel, not the generic ViT")

    @property
    def vit_config(self):
        raise NotImplementedError("Hiera is a HieraModel, not the generic ViT")

    def import_state_dict(self, state: Mapping[str, Any], param_dtype: torch.dtype = torch.bfloat16) -> None:
        self.model.load_state_dict(import_hiera_state_dict(self.hiera_config, state, param_dtype))

    def forward(self, video_values: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        B, F_, C, H, W = video_values.shape
        clips = video_values.reshape(B * (F_ // 16), 16, C, H, W).transpose(1, 2)
        return self.model(clips).reshape(B, -1, self.embed_dim)

    @property
    def default_video_resolution(self) -> Tuple[int, int, int, int]:
        return (self.num_frames, 3, self.default_image_size, self.default_image_size)

    @property
    def embed_dim(self) -> int:
        return int(self.hiera_config.embed_dim * 2 ** self.hiera_config.q_pool)

    @property
    def num_patches(self) -> int:
        c = self.hiera_config
        t = self.num_frames // c.patch_stride[0]
        h, w = self.default_image_size // c.patch_stride[1], self.default_image_size // c.patch_stride[2]
        if h % 2 ** c.q_pool or w % 2 ** c.q_pool:
            raise ValueError(f"Hiera: a {h} x {w} token grid does not pool {c.q_pool} times")
        return t * h * w // 2 ** (2 * c.q_pool)

    @property
    def spatial_resolution(self) -> int:
        c = self.hiera_config
        h, w = self.default_image_size // c.patch_stride[1], self.default_image_size // c.patch_stride[2]
        return h * w // 2 ** (2 * c.q_pool)
