"""Generic Vision Transformer covering the four main-path tower families
(counterpart of ``merv_tpu/models/backbones/video/vit.py``).

- DINOv2-reg (ViT-L/14, cls + 4 register tokens, LayerScale)
- SigLIP (ViT-B/16, no cls token, tanh-GELU)
- CLIP / LanguageBind-Video (ViT-L/14, pre-LN, QuickGELU, per-layer temporal
  attention over frames)
- ViViT (3D tubelet embedding 2x16x16 over 32 frames)

Patch/tubelet embedding is a reshape plus one matmul (stride == kernel).
Frame attention at tower lengths (224..512 tokens) runs the
``small_attention_kt`` kernel (through its autograd Function,
:class:`~merv_tpu_torch.ops.attention.SmallAttentionKt`) with q/v written
``[B, H, S, Dh]`` and k written ``[B, H, Dh, S]`` straight out of their
projections; other lengths go through
:func:`merv_tpu_torch.ops.attention.attention`.

``ViTLayer`` reads ``merv_tpu``'s three switches, with its names, values,
defaults and gates, at the same places (where ``merv_tpu`` also asks
``can_use_pallas()``, the port takes the branch on any device; the kernel
wrappers take their plain versions for CPU tensors):

- ``MERV_TPU_TOWER_ATTN`` (``_mha``): ``small`` the kt route (K1), ``xla_kt``
  a plain softmax chain on the kt layout, ``xla`` the ``Linear`` projections
  and ``attention()``, whose ``"small"`` plan is B3 (``small_attention``);
- ``MERV_TPU_TEMPORAL_KERNEL=1`` (``_mha_time_packed``): the packed temporal
  kernel (B5) where ``R % 128 == 0`` and ``dh % 16 == 0``;
- ``MERV_TPU_FUSED_VIT_BLOCK=1`` (``forward``): the fused attention half-layer
  (B6) where ``hidden % 128 == 0`` and q has a bias. The penultimate-layer feature
tap is "run the first L-1 layers". Parameter names follow the JAX tree
(``layers.<i>.attn.q_proj``, ``ls1.gamma``, ...), so the bridge maps by name.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
from torch import nn

from merv_tpu_torch.nn.core import ACT2FN, LayerNorm, Linear, normal_, trunc_normal_
from merv_tpu_torch.ops.attention import (
    DEFAULT_MASK_VALUE,
    PackedTemporalAttention,
    SmallAttentionKt,
    attention,
    dispatch_plan,
)
from merv_tpu_torch.ops.fused_vit_block import FusedVitAttnBlock


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12

    num_cls_tokens: int = 0
    num_register_tokens: int = 0
    pos_embed_includes_prefix: bool = True

    act: str = "gelu"
    layer_norm_eps: float = 1e-6
    use_layerscale: bool = False
    pre_norm: bool = False
    patch_bias: bool = True

    tubelet_t: int = 0
    tubelet_frames: int = 0

    temporal_attn: bool = False
    temporal_frames: int = 8

    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        n = self.grid_size * self.grid_size
        if self.tubelet_t:
            n *= self.tubelet_frames // self.tubelet_t
        return n

    @property
    def num_prefix_tokens(self) -> int:
        return self.num_cls_tokens + self.num_register_tokens

    @property
    def pos_embed_len(self) -> int:
        return self.num_patches + (self.num_cls_tokens if self.pos_embed_includes_prefix else 0)


def _param(shape, cfg: ViTConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device), requires_grad=False)


def _layer_norm(cfg: ViTConfig, device) -> LayerNorm:
    return LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, param_dtype=cfg.param_dtype, device=device)


class Attention(nn.Module):
    """q/k/v/o projections of one attention block (JAX ``attn`` / ``t_attn``)."""

    def __init__(self, cfg: ViTConfig, device=None) -> None:
        super().__init__()
        D = cfg.hidden_size
        lin = lambda: Linear(D, D, param_dtype=cfg.param_dtype, device=device, init_std=0.02, init_trunc=True)  # noqa: E731
        self.q_proj, self.k_proj, self.v_proj, self.o_proj = lin(), lin(), lin(), lin()


class LayerScale(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None) -> None:
        super().__init__()
        self.gamma = _param((cfg.hidden_size,), cfg, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.gamma.fill_(1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class MLP(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None) -> None:
        super().__init__()
        kw = dict(param_dtype=cfg.param_dtype, device=device, init_std=0.02, init_trunc=True)
        self.fc1 = Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.fc2 = Linear(cfg.intermediate_size, cfg.hidden_size, **kw)
        self.act = ACT2FN[cfg.act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class ViTLayer(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.norm1 = _layer_norm(cfg, device)
        self.attn = Attention(cfg, device)
        self.norm2 = _layer_norm(cfg, device)
        self.mlp = MLP(cfg, device)
        if cfg.use_layerscale:
            self.ls1 = LayerScale(cfg, device)
            self.ls2 = LayerScale(cfg, device)
        if cfg.temporal_attn:
            self.temporal_embedding = _param((cfg.temporal_frames, cfg.hidden_size), cfg, device)
            self.t_norm = _layer_norm(cfg, device)
            self.t_attn = Attention(cfg, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.cfg.temporal_attn:
            normal_(self.temporal_embedding, self.cfg.hidden_size ** -0.5, generator)

    # -- attention ---------------------------------------------------------------------

    def _mha(self, ap: Attention, x: torch.Tensor, impl: str) -> torch.Tensor:
        c = self.cfg
        B, S, D = x.shape
        H, Dh = c.num_heads, c.head_dim
        plan = dispatch_plan(S, S, Dh, causal=False, has_bias=False, self_shaped=True)
        # merv_tpu's override, read where it reads it: "small" pins the kt
        # kernel (K1), "xla_kt" the plain softmax chain on the same kt layout,
        # "xla" the Linear projections and attention() (whose "small" plan is
        # B3, small_attention)
        plan = os.environ.get("MERV_TPU_TOWER_ATTN", plan)
        if plan in ("small", "xla_kt"):
            # q and v come out of their GEMMs as [B, S, H*Dh] and are split per
            # head; k is produced directly as W_k @ x^T = [B, H*Dh, S], i.e.
            # kt [B, H, Dh, S] with no transpose pass
            q = ap.q_proj(x).view(B, S, H, Dh).transpose(1, 2).contiguous()
            v = ap.v_proj(x).view(B, S, H, Dh).transpose(1, 2).contiguous()
            kt = torch.matmul(ap.k_proj.weight.to(x.dtype), x.transpose(1, 2))
            if ap.k_proj.bias is not None:
                kt = kt + ap.k_proj.bias.to(x.dtype)[:, None]
            kt = kt.view(B, H, Dh, S)
            if plan == "xla_kt":
                s = torch.matmul(q.float(), kt.float()) * Dh ** -0.5
                out = torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)
            else:
                out = SmallAttentionKt.apply(q, kt, v, Dh ** -0.5, impl)
        else:
            q = ap.q_proj(x).view(B, S, H, Dh).transpose(1, 2)
            k = ap.k_proj(x).view(B, S, H, Dh).transpose(1, 2)
            v = ap.v_proj(x).view(B, S, H, Dh).transpose(1, 2)
            out = attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=False, impl=impl)
        return ap.o_proj(out.transpose(1, 2).reshape(B, S, D))

    def _mha_time_packed(self, ap: Attention, x: torch.Tensor, impl: str) -> torch.Tensor:
        """Attention over the frame axis with all heads packed into one sequence
        of F*H rows (row r = f*H + h), each row seeing only its own head's rows.
        Default: ``merv_tpu``'s bias path (a same-head additive bias through
        :func:`attention`). ``MERV_TPU_TEMPORAL_KERNEL=1`` with
        ``R % 128 == 0`` and ``dh % 16 == 0``: the packed temporal kernel
        (B5), on q/v ``[Bn, R, dh]`` (pure reshapes of the projections) and
        kt ``[Bn, dh, R]``."""
        c = self.cfg
        Bn, F, Dm = x.shape
        H, dh = c.num_heads, c.head_dim
        R = F * H
        if os.environ.get("MERV_TPU_TEMPORAL_KERNEL", "0") == "1" and R % 128 == 0 and dh % 16 == 0:
            q = ap.q_proj(x).reshape(Bn, R, dh)
            v = ap.v_proj(x).reshape(Bn, R, dh)
            # kt[b, k, f*H + h] = k[b, f, h*dh + k]: the packed k rows transposed,
            # in one copy (no single GEMM writes this layout; merv_tpu's einsum
            # leaves the transpose to XLA)
            kt = ap.k_proj(x).reshape(Bn, R, dh).transpose(1, 2).contiguous()
            out = PackedTemporalAttention.apply(q, kt, v, dh ** -0.5, H, impl)
            return ap.o_proj(out.reshape(Bn, F, Dm))
        q = ap.q_proj(x).reshape(Bn, 1, R, dh)
        k = ap.k_proj(x).reshape(Bn, 1, R, dh)
        v = ap.v_proj(x).reshape(Bn, 1, R, dh)
        idx = torch.arange(R, device=x.device) % H
        bias = torch.where(idx[:, None] == idx[None, :], 0.0, DEFAULT_MASK_VALUE)[None, None]
        out = attention(q, k, v, causal=False, bias=bias, impl=impl)
        return ap.o_proj(out.reshape(Bn, F, Dm))

    def forward(self, x: torch.Tensor, frames: int, impl: str = "auto") -> torch.Tensor:
        c = self.cfg
        if c.temporal_attn and frames > 1:
            # x: [(B*T), N, D] -> temporal embedding + attention over each window's frames
            BT, N, D = x.shape
            B = BT // frames
            xt = x.view(B, frames, N, D) + self.temporal_embedding[None, :frames, None, :].to(x.dtype)
            xt = xt.transpose(1, 2).reshape(B * N, frames, D)
            xt_n = self.t_norm(xt)
            if frames * c.num_heads <= 512:
                yt = self._mha_time_packed(self.t_attn, xt_n, impl)
            else:
                yt = self._mha(self.t_attn, xt_n, impl)
            xt = xt + yt
            x = xt.view(B, N, frames, D).transpose(1, 2).reshape(BT, N, D)

        ap = self.attn
        if (os.environ.get("MERV_TPU_FUSED_VIT_BLOCK", "0") == "1" and c.hidden_size % 128 == 0
                and ap.q_proj.bias is not None):
            # the whole attention half-layer as one kernel call (B6), on this
            # layer's own parameters; weights cast to x's dtype as merv_tpu does
            gamma = (self.ls1.gamma if c.use_layerscale
                     else torch.ones(c.hidden_size, dtype=c.param_dtype, device=x.device))
            w = lambda lin: lin.weight.to(x.dtype)  # noqa: E731
            x = FusedVitAttnBlock.apply(
                x.contiguous(), self.norm1.weight, self.norm1.bias, w(ap.q_proj), ap.q_proj.bias, w(ap.k_proj),
                ap.k_proj.bias, w(ap.v_proj), ap.v_proj.bias, w(ap.o_proj), ap.o_proj.bias, gamma, c.num_heads,
                c.layer_norm_eps, impl,
            )
        else:
            h = self._mha(ap, self.norm1(x), impl)
            x = x + (self.ls1(h) if c.use_layerscale else h)
        h = self.mlp(self.norm2(x))
        return x + (self.ls2(h) if c.use_layerscale else h)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        c = cfg
        patch_in = (c.tubelet_t if c.tubelet_t else 1) * c.patch_size * c.patch_size * 3
        self.patch_embed = Linear(
            patch_in, c.hidden_size, use_bias=c.patch_bias, param_dtype=c.param_dtype, device=device,
            init_std=0.02, init_trunc=True,
        )
        self.pos_embed = _param((c.pos_embed_len, c.hidden_size), c, device)
        if c.num_cls_tokens:
            self.cls_token = _param((c.num_cls_tokens, c.hidden_size), c, device)
        if c.num_register_tokens:
            self.register_tokens = _param((c.num_register_tokens, c.hidden_size), c, device)
        if c.pre_norm:
            self.pre_norm = _layer_norm(c, device)
        self.layers = nn.ModuleList([ViTLayer(c, device) for _ in range(c.num_layers)])
        self.final_norm = _layer_norm(c, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("pos_embed", "cls_token", "register_tokens"):
            p = getattr(self, name, None)
            if p is not None:
                trunc_normal_(p, 0.02, generator)

    # -- embedding ---------------------------------------------------------------------

    def _patchify(self, pixels: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] or [B, C, T, H, W] -> [B, N, patch_in] (conv kernel layout)."""
        c = self.cfg
        p = c.patch_size
        if c.tubelet_t:
            B, C, T, H, W = pixels.shape
            t, g = c.tubelet_t, H // p
            x = pixels.reshape(B, C, T // t, t, g, p, g, p)
            return x.permute(0, 2, 4, 6, 3, 5, 7, 1).reshape(B, (T // t) * g * g, t * p * p * C)
        B, C, H, W = pixels.shape
        g = H // p
        x = pixels.reshape(B, C, g, p, g, p)
        return x.permute(0, 2, 4, 3, 5, 1).reshape(B, g * g, p * p * C)

    def embed(self, pixels: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = self.patch_embed(self._patchify(pixels))
        B = x.shape[0]
        pos = self.pos_embed.to(x.dtype)
        prefix = []
        if c.num_cls_tokens:
            cls = self.cls_token.to(x.dtype).expand(B, c.num_cls_tokens, c.hidden_size)
            if c.pos_embed_includes_prefix:
                cls = cls + pos[None, : c.num_cls_tokens]
                x = x + pos[None, c.num_cls_tokens :]
            else:
                x = x + pos[None]
            prefix.append(cls)
        else:
            x = x + pos[None]
        if c.num_register_tokens:
            prefix.append(self.register_tokens.to(x.dtype).expand(B, c.num_register_tokens, c.hidden_size))
        if prefix:
            x = torch.cat(prefix + [x], dim=1)
        return x

    def forward(
        self,
        pixels: torch.Tensor,
        *,
        skip_last_layers: int = 0,
        apply_final_norm: bool = False,
        frames: int = 1,
        impl: str = "auto",
    ) -> torch.Tensor:
        """skip_last_layers=1 + apply_final_norm=False is the penultimate-layer
        tap; 0 + True is the HF last_hidden_state contract."""
        c = self.cfg
        x = self.embed(pixels.to(c.compute_dtype))
        if c.pre_norm:
            x = self.pre_norm(x)
        for layer in self.layers[: c.num_layers - skip_last_layers]:
            x = layer(x, frames, impl)
        if apply_final_norm:
            x = self.final_norm(x)
        return x


# ---------------------------------------------------------------------------
# Tower configs
# ---------------------------------------------------------------------------

DINOV2_LARGE_REG4 = ViTConfig(
    image_size=224, patch_size=14, hidden_size=1024, intermediate_size=4096,
    num_layers=24, num_heads=16, num_cls_tokens=1, num_register_tokens=4,
    pos_embed_includes_prefix=True, act="gelu", layer_norm_eps=1e-6,
    use_layerscale=True,
)

SIGLIP_BASE_224 = ViTConfig(
    image_size=224, patch_size=16, hidden_size=768, intermediate_size=3072,
    num_layers=12, num_heads=12, num_cls_tokens=0,
    pos_embed_includes_prefix=False, act="gelu_tanh", layer_norm_eps=1e-6,
)

LANGUAGEBIND_VIDEO_LARGE = ViTConfig(
    image_size=224, patch_size=14, hidden_size=1024, intermediate_size=4096,
    num_layers=24, num_heads=16, num_cls_tokens=1,
    pos_embed_includes_prefix=True, act="quick_gelu", layer_norm_eps=1e-5,
    pre_norm=True, patch_bias=False, temporal_attn=True, temporal_frames=8,
)

VIVIT_BASE_16x2 = ViTConfig(
    image_size=224, patch_size=16, hidden_size=768, intermediate_size=3072,
    num_layers=12, num_heads=12, num_cls_tokens=1,
    pos_embed_includes_prefix=True, act="gelu_tanh", layer_norm_eps=1e-6,
    tubelet_t=2, tubelet_frames=32,
)


def tiny_vit_config(**overrides) -> ViTConfig:
    base = dict(
        image_size=32, patch_size=8, hidden_size=64, intermediate_size=128,
        num_layers=3, num_heads=4, compute_dtype=torch.float32,
    )
    base.update(overrides)
    return ViTConfig(**base)
