"""Projectors: per-encoder vision -> LLM token resamplers (counterpart of
``merv_tpu/nn/projectors.py``).

Every module maps ``[..., vision_dim] -> [..., llm_dim]``; the token
resamplers also take a ``[B, F, N, C]`` frame-token grid down to
``output_frame_length x output_token_length`` tokens:

- the MLP family: ``linear`` (:class:`LinearProjector`, optionally after a
  LayerNorm), ``gelu-mlp`` (:class:`MLPProjector`), :class:`MLPDeepProjector`,
  ``fused-gelu-mlp`` (:class:`FusedMLPProjector`) and ``none``
  (:class:`Identity`), chosen by :func:`get_mlp_projector`;
- ``avg`` (:class:`AveragePoolingProjector`) and ``3davg``
  (:class:`AveragePooling3DProjector`): adaptive average pooling, as a
  contraction with the constant ``[out, in]`` window-average matrices torch's
  ``AdaptiveAvgPool`` uses (:func:`adaptive_pool_matrix`), exactly as in
  ``merv_tpu``;
- ``attntv`` (:class:`AttentivePooler`): learned queries through a JEPA
  cross-attention block, whose attention goes through
  :func:`~merv_tpu_torch.ops.attention.attention` (64 queries over a frame's
  tokens: not self-shaped, so the plan keeps it plain, as ``merv_tpu`` plans
  ``"xla"``);
- ``conv`` (:class:`ConvolutionalProjector`, the Honeybee C-Abstractor: timm
  RegNet bottlenecks, pooling, bottlenecks) and ``3dconv``
  (:class:`Convolutional3DProjector`: Conv3d, 3D pooling).

Parameter names follow ``merv_tpu``'s trees (``projector.<i>``,
``cross_attn.xattn.kv``, ``stage1_0.conv1.conv``, ...); a convolution's
``weight`` is ``merv_tpu``'s kernel as it lies, torch's own OIHW / OIDHW
layout, so the bridge maps every leaf by name.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from merv_tpu_torch.nn.core import LayerNorm, Linear, gelu, trunc_normal_, uniform_
from merv_tpu_torch.ops.attention import attention


def adaptive_pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] averaging matrix of torch's AdaptiveAvgPool windows:
    output i averages ``floor(i*In/Out) .. ceil((i+1)*In/Out)``."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -((-(i + 1) * in_size) // out_size)
        m[i, start:end] = 1.0 / (end - start)
    return m


def _pool_matrices(x: torch.Tensor, sizes, out_sizes):
    return [torch.as_tensor(adaptive_pool_matrix(i, o), dtype=x.dtype, device=x.device)
            for i, o in zip(sizes, out_sizes)]


def adaptive_avg_pool_2d(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """x: [..., H, W, C] -> [..., oh, ow, C]."""
    mh, mw = _pool_matrices(x, (x.shape[-3], x.shape[-2]), out_hw)
    x = torch.einsum("...hwc,oh->...owc", x, mh)
    return torch.einsum("...owc,pw->...opc", x, mw)


def adaptive_avg_pool_3d(x: torch.Tensor, out_thw: Tuple[int, int, int]) -> torch.Tensor:
    """x: [..., T, H, W, C] -> [..., ot, oh, ow, C]."""
    mt, mh, mw = _pool_matrices(x, (x.shape[-4], x.shape[-3], x.shape[-2]), out_thw)
    x = torch.einsum("...thwc,ot->...ohwc", x, mt)
    x = torch.einsum("...ohwc,ph->...opwc", x, mh)
    return torch.einsum("...opwc,qw->...opqc", x, mw)


# ---------------------------------------------------------------------------
# The MLP family
# ---------------------------------------------------------------------------


class Identity(nn.Module):
    """``mlp_type="none"``: no parameters, the input as it is. Like merv_tpu's, it
    has no ``output_token_length``, so MERV's consistency check over several
    towers fails on it as merv_tpu's does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class LinearProjector(nn.Module):
    def __init__(
        self, vision_dim: int, llm_dim: int, pre_proj_layernorm: bool = False,
        param_dtype: torch.dtype = torch.float32, device: Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        self.pre_proj_layernorm = pre_proj_layernorm
        self.projector = Linear(vision_dim, llm_dim, param_dtype=param_dtype, device=device)
        if pre_proj_layernorm:
            self.layernorm = LayerNorm(vision_dim, param_dtype=param_dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pre_proj_layernorm:
            x = self.layernorm(x)
        return self.projector(x)

    @property
    def output_token_length(self) -> int:
        return 1


class MLPProjector(nn.Module):
    """``gelu-mlp``: Linear, GELU, Linear (``projector.0``, ``projector.1``)."""

    def __init__(
        self, vision_dim: int, llm_dim: int, pre_proj_layernorm: bool = False,
        param_dtype: torch.dtype = torch.float32, device: Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        self.vision_dim, self.llm_dim = vision_dim, llm_dim
        self.pre_proj_layernorm = pre_proj_layernorm
        self.projector = nn.ModuleList(
            [Linear(i, o, param_dtype=param_dtype, device=device) for i, o in self._dims()])
        if pre_proj_layernorm:
            self.layernorm = LayerNorm(vision_dim, param_dtype=param_dtype, device=device)

    def _dims(self) -> Tuple[Tuple[int, int], ...]:
        return ((self.vision_dim, self.llm_dim), (self.llm_dim, self.llm_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pre_proj_layernorm:
            x = self.layernorm(x)
        for i, lin in enumerate(self.projector):
            x = lin(x)
            if i < len(self.projector) - 1:
                x = gelu(x)
        return x

    @property
    def output_token_length(self) -> int:
        return 1


class MLPDeepProjector(MLPProjector):
    """Three Linears with GELUs between."""

    def _dims(self) -> Tuple[Tuple[int, int], ...]:
        return ((self.vision_dim, self.llm_dim), (self.llm_dim, self.llm_dim), (self.llm_dim, self.llm_dim))


class FusedMLPProjector(MLPProjector):
    """``fused-gelu-mlp``: a 4x-wide first Linear, then two more."""

    def _dims(self) -> Tuple[Tuple[int, int], ...]:
        wide = self.vision_dim * 4
        return ((self.vision_dim, wide), (wide, self.llm_dim), (self.llm_dim, self.llm_dim))


def get_mlp_projector(
    fused_vision_dim: int, llm_dim: int, mlp_type: str = "gelu-mlp",
    param_dtype: torch.dtype = torch.float32, device: Optional[torch.device] = None,
) -> nn.Module:
    kw = dict(param_dtype=param_dtype, device=device)
    if mlp_type == "linear":
        return LinearProjector(fused_vision_dim, llm_dim, **kw)
    if mlp_type == "gelu-mlp":
        return MLPProjector(fused_vision_dim, llm_dim, **kw)
    if mlp_type == "fused-gelu-mlp":
        return FusedMLPProjector(fused_vision_dim, llm_dim, **kw)
    if mlp_type == "none":
        return Identity()
    raise ValueError(f"Projector with mlp_type = {mlp_type!r} is not supported!")


# ---------------------------------------------------------------------------
# Token resamplers
# ---------------------------------------------------------------------------


class _Resampler(nn.Module):
    """A resampler's grid: ``output_frames`` x ``output_token_length`` tokens."""

    output_frames: int

    @property
    def output_frame_length(self) -> int:
        return self.output_frames

    def _check_frames(self, F_: int) -> None:
        if F_ != self.output_frames:
            raise ValueError(f"{type(self).__name__}: {F_} frames, built for {self.output_frames}")


class AveragePoolingProjector(_Resampler):
    """``avg``: each frame pooled adaptively to output_size^2 tokens, then the MLP:
    [B, F, N, C] -> [B, F*S*S, llm_dim]."""

    def __init__(
        self, vision_dim: int, llm_dim: int, output_size: int, output_frames: int = 8, mlp_type: str = "gelu-mlp",
        param_dtype: torch.dtype = torch.float32, device: Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        self.output_size, self.output_frames, self.mlp_type = output_size, output_frames, mlp_type
        self.projector = get_mlp_projector(vision_dim, llm_dim, mlp_type, param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, F_, N, C = x.shape
        self._check_frames(F_)
        H, S = math.isqrt(N), self.output_size
        x = adaptive_avg_pool_2d(x.reshape(B, F_, H, H, C), (S, S)).reshape(B, F_, S * S, C)
        return self.projector(x).reshape(B, F_ * S * S, -1)

    @property
    def output_token_length(self) -> int:
        return self.output_size ** 2


class AveragePooling3DProjector(_Resampler):
    """``3davg``: adaptive 3D avg-pool over (frames, H, W) + the MLP: [B, F, N, C] -> [B, ot*S*S, llm_dim]."""

    def __init__(
        self, vision_dim: int, llm_dim: int, output_frames: int, output_size: int, mlp_type: str = "gelu-mlp",
        param_dtype: torch.dtype = torch.float32, device: Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        self.output_frames, self.output_size, self.mlp_type = output_frames, output_size, mlp_type
        self.projector = get_mlp_projector(vision_dim, llm_dim, mlp_type, param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, F_, N, C = x.shape
        H = math.isqrt(N)
        x = adaptive_avg_pool_3d(x.reshape(B, F_, H, H, C), (self.output_frames, self.output_size, self.output_size))
        return self.projector(x.reshape(B, self.output_frames * self.output_size ** 2, C))

    @property
    def output_token_length(self) -> int:
        return self.output_size ** 2


class _XAttn(nn.Module):
    def __init__(self, dim: int, qkv_bias: bool, kw: dict) -> None:
        super().__init__()
        self.q = Linear(dim, dim, use_bias=qkv_bias, **kw)
        self.kv = Linear(dim, 2 * dim, use_bias=qkv_bias, **kw)
        self.proj = Linear(dim, dim, **kw)


class _BlockMLP(nn.Module):
    def __init__(self, dim: int, hidden: int, kw: dict) -> None:
        super().__init__()
        self.fc1 = Linear(dim, hidden, **kw)
        self.fc2 = Linear(hidden, dim, **kw)


class CrossAttentionBlock(nn.Module):
    """JEPA cross-attention block: ``q + xattn(q, norm1(x))``, then ``q + mlp(norm2(q))``."""

    def __init__(
        self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
        param_dtype: torch.dtype = torch.float32, device: Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        kw = dict(param_dtype=param_dtype, device=device, init_std=0.02, init_trunc=True)
        self.norm1 = LayerNorm(dim, param_dtype=param_dtype, device=device)
        self.norm2 = LayerNorm(dim, param_dtype=param_dtype, device=device)
        self.xattn = _XAttn(dim, qkv_bias, kw)
        self.mlp = _BlockMLP(dim, int(dim * mlp_ratio), kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        # merv_tpu's init (the JEPA reference's): zero Linear biases, proj and fc2 rescaled by 1/sqrt(2)
        with torch.no_grad():
            for lin in (self.xattn.q, self.xattn.kv, self.xattn.proj, self.mlp.fc1, self.mlp.fc2):
                if lin.bias is not None:
                    lin.bias.zero_()
            self.xattn.proj.weight.mul_(1.0 / math.sqrt(2.0))
            self.mlp.fc2.weight.mul_(1.0 / math.sqrt(2.0))

    def _xattn(self, q: torch.Tensor, x: torch.Tensor, impl: str) -> torch.Tensor:
        d, h = self.dim, self.num_heads
        hd = d // h
        B, n, _ = q.shape
        N = x.shape[1]
        qh = self.xattn.q(q).reshape(B, n, h, hd).transpose(1, 2).contiguous()
        kv = self.xattn.kv(x).reshape(B, N, 2, h, hd)
        kh = kv[:, :, 0].transpose(1, 2).contiguous()
        vh = kv[:, :, 1].transpose(1, 2).contiguous()
        out = attention(qh, kh, vh, causal=False, impl=impl)
        return self.xattn.proj(out.transpose(1, 2).reshape(B, n, d))

    def forward(self, q: torch.Tensor, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        q = q + self._xattn(q, self.norm1(x), impl)
        return q + self.mlp.fc2(gelu(self.mlp.fc1(self.norm2(q))))


class AttentivePooler(_Resampler):
    """``attntv``: learned queries cross-attend each frame's tokens, then the MLP:
    [B, F, N, C] -> [B, F*num_query_tokens, llm_dim]."""

    def __init__(
        self, vision_dim: int, llm_dim: int, num_query_tokens: int, num_heads: int = 8, output_frames: int = 8,
        mlp_type: str = "gelu-mlp", param_dtype: torch.dtype = torch.float32,
        device: Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        if vision_dim % num_heads:
            raise ValueError("vision_dim must be divisible by num_heads")
        self.num_query_tokens, self.output_frames, self.mlp_type = num_query_tokens, output_frames, mlp_type
        # merv_tpu keeps the queries in fp32 whatever the param dtype
        self.query_tokens = nn.Parameter(
            torch.empty(1, num_query_tokens, vision_dim, dtype=torch.float32, device=device), requires_grad=False)
        self.cross_attn = CrossAttentionBlock(vision_dim, num_heads, qkv_bias=True, param_dtype=param_dtype,
                                              device=device)
        self.projector = get_mlp_projector(vision_dim, llm_dim, mlp_type, param_dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.query_tokens, 0.02, generator)

    def forward(self, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        B, F_, N, C = x.shape
        self._check_frames(F_)
        x = x.reshape(B * F_, N, C)
        q = self.query_tokens.to(x.dtype).expand(B * F_, self.num_query_tokens, C)
        q = self.projector(self.cross_attn(q, x, impl))
        return q.reshape(B, F_ * self.num_query_tokens, -1)

    @property
    def output_token_length(self) -> int:
        return self.num_query_tokens


class _Conv(nn.Module):
    """A convolution's parameters: ``weight`` [out, in / groups, k...] (torch's layout), optional ``bias``."""

    def __init__(self, shape: Tuple[int, ...], bias: bool, param_dtype: torch.dtype, device) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape, dtype=param_dtype, device=device), requires_grad=False)
        self.bias = (nn.Parameter(torch.empty(shape[0], dtype=param_dtype, device=device), requires_grad=False)
                     if bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        # torch's Conv default, as merv_tpu's: U(+-1 / sqrt(fan_in)) for the weight and the bias
        bound = 1.0 / math.sqrt(int(np.prod(self.weight.shape[1:])))
        uniform_(self.weight, bound, generator)
        if self.bias is not None:
            uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor, groups: int = 1, padding: int = 0) -> torch.Tensor:
        conv = F.conv3d if self.weight.dim() == 5 else F.conv2d
        y = conv(x, self.weight.to(x.dtype), None, padding=padding, groups=groups)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype).reshape(1, -1, *([1] * (x.dim() - 2)))
        return y


class _LayerNorm2d(LayerNorm):
    """LayerNorm over the channels of [B, C, H, W] (timm's LayerNorm2d)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class _ConvNorm(nn.Module):
    def __init__(self, shape: Tuple[int, ...], param_dtype: torch.dtype, device) -> None:
        super().__init__()
        self.conv = _Conv(shape, False, param_dtype, device)
        self.bn = _LayerNorm2d(shape[0], param_dtype=param_dtype, device=device)


class _SqueezeExcite(nn.Module):
    def __init__(self, dim: int, rd: int, param_dtype: torch.dtype, device) -> None:
        super().__init__()
        self.fc1 = _Conv((rd, dim, 1, 1), True, param_dtype, device)
        self.fc2 = _Conv((dim, rd, 1, 1), True, param_dtype, device)


class _RegBlock(nn.Module):
    """timm RegNet ``Bottleneck`` (stride 1) as the Honeybee C-Abstractor builds it:
    conv1 1x1 -> LN2d -> SiLU; conv2 3x3 depthwise -> LN2d -> SiLU; squeeze-excite
    (``round(in * 0.25)`` channels, SiLU); conv3 1x1 -> LN2d; a 1x1 conv + LN2d
    shortcut where the width changes; SiLU of the sum."""

    def __init__(self, in_dim: int, out_dim: int, param_dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__()
        self.out_dim = out_dim
        rd = max(1, int(round(in_dim * 0.25)))
        self.conv1 = _ConvNorm((out_dim, in_dim, 1, 1), param_dtype, device)
        self.conv2 = _ConvNorm((out_dim, 1, 3, 3), param_dtype, device)
        self.se = _SqueezeExcite(out_dim, rd, param_dtype, device)
        self.conv3 = _ConvNorm((out_dim, out_dim, 1, 1), param_dtype, device)
        if in_dim != out_dim:
            self.downsample = _ConvNorm((out_dim, in_dim, 1, 1), param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        short = self.downsample.bn(self.downsample.conv(x)) if hasattr(self, "downsample") else x
        y = F.silu(self.conv1.bn(self.conv1.conv(x)))
        y = F.silu(self.conv2.bn(self.conv2.conv(y, groups=self.out_dim, padding=1)))
        s = F.silu(self.se.fc1(y.mean(dim=(2, 3), keepdim=True)))
        y = y * torch.sigmoid(self.se.fc2(s))
        return F.silu(self.conv3.bn(self.conv3.conv(y)) + short)


class ConvolutionalProjector(_Resampler):
    """``conv``: the Honeybee C-Abstractor, RegNet blocks -> adaptive 2D pool ->
    RegNet blocks -> the MLP: [B, F, N, C] -> [B, F*S*S, llm_dim]."""

    def __init__(
        self, vision_dim: int, llm_dim: int, output_size: int, block_depth: int = 3, output_frames: int = 8,
        mlp_type: str = "gelu-mlp", param_dtype: torch.dtype = torch.float32,
        device: Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        self.llm_dim, self.output_size, self.block_depth = llm_dim, output_size, block_depth
        self.output_frames, self.mlp_type = output_frames, mlp_type
        for i in range(block_depth):
            setattr(self, f"stage1_{i}", _RegBlock(vision_dim if i == 0 else llm_dim, llm_dim, param_dtype, device))
        for i in range(block_depth):
            setattr(self, f"stage2_{i}", _RegBlock(llm_dim, llm_dim, param_dtype, device))
        self.projector = get_mlp_projector(llm_dim, llm_dim, mlp_type, param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, F_, N, C = x.shape
        self._check_frames(F_)
        H, S = math.isqrt(N), self.output_size
        y = x.reshape(B * F_, H, H, C).permute(0, 3, 1, 2)  # [BF, C, H, W]
        for i in range(self.block_depth):
            y = getattr(self, f"stage1_{i}")(y)
        y = adaptive_avg_pool_2d(y.permute(0, 2, 3, 1), (S, S)).permute(0, 3, 1, 2)
        for i in range(self.block_depth):
            y = getattr(self, f"stage2_{i}")(y)
        y = self.projector(y.permute(0, 2, 3, 1).reshape(B, F_, S * S, self.llm_dim))
        return y.reshape(B, F_ * S * S, -1)

    @property
    def output_token_length(self) -> int:
        return self.output_size ** 2


class Convolutional3DProjector(_Resampler):
    """``3dconv``: Conv3d (kernel 3, padding 1) -> adaptive 3D pool -> the MLP:
    [B, F, N, C] -> [B, ot*S*S, llm_dim]. The conv's parameters are fp32, as merv_tpu's."""

    def __init__(
        self, vision_dim: int, llm_dim: int, output_frames: int, output_size: int, mlp_type: str = "gelu-mlp",
        param_dtype: torch.dtype = torch.float32, device: Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        self.llm_dim, self.output_frames, self.output_size, self.mlp_type = llm_dim, output_frames, output_size, mlp_type
        self.conv = _Conv((llm_dim, vision_dim, 3, 3, 3), True, torch.float32, device)
        self.projector = get_mlp_projector(llm_dim, llm_dim, mlp_type, param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, F_, N, C = x.shape
        H, S = math.isqrt(N), self.output_size
        y = self.conv(x.reshape(B, F_, H, H, C).permute(0, 4, 1, 2, 3), padding=1)  # [B, C', F, H, W]
        y = adaptive_avg_pool_3d(y.permute(0, 2, 3, 4, 1), (self.output_frames, S, S))
        return self.projector(y.reshape(B, self.output_frames * S * S, self.llm_dim))

    @property
    def output_token_length(self) -> int:
        return self.output_size ** 2
