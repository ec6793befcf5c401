"""Main-path projectors (counterpart of ``merv_tpu/nn/projectors.py``).

``AveragePooling3DProjector`` (the ``3davg`` resampler) pools a
``[B, F, N, C]`` frame-token grid adaptively over (frames, H, W) and applies
the ``linear`` projector. Adaptive pooling is a contraction with the constant
``[out, in]`` window-average matrices torch's ``AdaptiveAvgPool`` uses
(:func:`adaptive_pool_matrix`), exactly as in ``merv_tpu``. The other
resamplers and MLP projectors wait with the rest of the model zoo (ROADMAP A10).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from merv_tpu_torch.nn.core import LayerNorm, Linear


def adaptive_pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] averaging matrix of torch's AdaptiveAvgPool windows:
    output i averages ``floor(i*In/Out) .. ceil((i+1)*In/Out)``."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -((-(i + 1) * in_size) // out_size)
        m[i, start:end] = 1.0 / (end - start)
    return m


def adaptive_avg_pool_3d(x: torch.Tensor, out_thw: Tuple[int, int, int]) -> torch.Tensor:
    """x: [..., T, H, W, C] -> [..., ot, oh, ow, C]."""
    T, H, W = x.shape[-4], x.shape[-3], x.shape[-2]
    mt, mh, mw = (
        torch.as_tensor(adaptive_pool_matrix(i, o), dtype=x.dtype, device=x.device)
        for i, o in zip((T, H, W), out_thw)
    )
    x = torch.einsum("...thwc,ot->...ohwc", x, mt)
    x = torch.einsum("...ohwc,ph->...opwc", x, mh)
    return torch.einsum("...opwc,qw->...opqc", x, mw)


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


def get_mlp_projector(
    fused_vision_dim: int, llm_dim: int, mlp_type: str = "gelu-mlp",
    param_dtype: torch.dtype = torch.float32, device: Optional[torch.device] = None,
) -> nn.Module:
    if mlp_type == "linear":
        return LinearProjector(fused_vision_dim, llm_dim, param_dtype=param_dtype, device=device)
    raise NotImplementedError(f"mlp_type {mlp_type!r} is not ported yet (ROADMAP A10); only 'linear' is")


class AveragePooling3DProjector(nn.Module):
    """Adaptive 3D avg-pool over (frames, H, W) + projector: [B, F, N, C] -> [B, ot*S*S, llm_dim]."""

    def __init__(
        self, vision_dim: int, llm_dim: int, output_frames: int, output_size: int, mlp_type: str = "gelu-mlp",
        param_dtype: torch.dtype = torch.float32, device: Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        self.output_frames, self.output_size, self.mlp_type = output_frames, output_size, mlp_type
        self.projector = get_mlp_projector(vision_dim, llm_dim, mlp_type, param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, F, N, C = x.shape
        H = math.isqrt(N)
        x = adaptive_avg_pool_3d(x.reshape(B, F, H, H, C), (self.output_frames, self.output_size, self.output_size))
        return self.projector(x.reshape(B, self.output_frames * self.output_size ** 2, C))

    @property
    def output_token_length(self) -> int:
        return self.output_size ** 2

    @property
    def output_frame_length(self) -> int:
        return self.output_frames
