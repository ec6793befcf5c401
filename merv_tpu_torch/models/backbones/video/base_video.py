"""Video backbone abstraction (counterpart of ``merv_tpu/models/backbones/video/base_video.py``).

A backbone maps ``video_values`` to ``[B, num_patches, embed_dim]`` token
features and exposes ``embed_dim`` / ``num_patches`` / ``spatial_resolution`` /
``temporal_resolution`` / ``default_video_resolution`` /
``get_video_transform()``. Unlike the JAX backbone it owns its parameters: the
ViT lives in ``self.vit``, built on ``device`` at construction.
``vit_config`` may be overridden (tests build tiny towers that way), and
``param_dtype`` sets the dtype the parameters are stored in.
"""

from __future__ import annotations

import dataclasses
from abc import abstractmethod
from typing import Any, Mapping, Optional, Tuple

import torch
from torch import nn

from merv_tpu_torch.device import resolve_device
from merv_tpu_torch.models.backbones.video.vision_import import import_vision_state_dict
from merv_tpu_torch.models.backbones.video.vit import VisionTransformer, ViTConfig
from merv_tpu_torch.preprocessing.transforms import VideoTransform


class VideoBackbone(nn.Module):
    def __init__(
        self,
        video_backbone_id: str,
        image_resize_strategy: str,
        default_image_size: int = 224,
        num_frames: int = 8,
        vit_config: Optional[ViTConfig] = None,
        param_dtype: Optional[torch.dtype] = None,
    ) -> None:
        super().__init__()
        self.identifier = video_backbone_id
        self.image_resize_strategy = image_resize_strategy
        self.default_image_size = default_image_size
        self.num_frames = num_frames
        self._vit_config = vit_config
        self._param_dtype = param_dtype

    def _build(self, device: Optional[torch.device]) -> None:
        self.vit = VisionTransformer(self.vit_config, device=resolve_device(device))

    @property
    def vit_config(self) -> ViTConfig:
        cfg = self._vit_config if self._vit_config is not None else self.default_vit_config()
        if self._param_dtype is not None:
            cfg = dataclasses.replace(cfg, param_dtype=self._param_dtype)
        return cfg

    @abstractmethod
    def default_vit_config(self) -> ViTConfig: ...

    def import_state_dict(self, state: Mapping[str, Any], param_dtype: torch.dtype = torch.bfloat16) -> None:
        """Load a timm / HF checkpoint state dict into ``self.vit``, each value
        rounded to ``param_dtype`` first (see ``vision_import.py``). The
        counterpart of ``merv_tpu``'s ``load_state_dict``, which returns a
        tree; here ``load_state_dict`` stays torch's own."""
        self.vit.load_state_dict(import_vision_state_dict(self.vit_config, state, param_dtype=param_dtype))

    @abstractmethod
    def forward(self, video_values: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        """video_values -> [B, num_patches, embed_dim]."""

    def get_video_transform(self) -> VideoTransform:
        return self.video_transform

    @property
    @abstractmethod
    def default_video_resolution(self) -> Tuple[int, int, int, int]: ...

    @property
    def half_precision_dtype(self) -> torch.dtype:
        """The dtype a frozen tower is stored in for training."""
        return torch.bfloat16

    @property
    def embed_dim(self) -> int:
        return self.vit_config.hidden_size

    @property
    @abstractmethod
    def num_patches(self) -> int: ...

    @property
    def spatial_resolution(self) -> int:
        return self.num_patches // self.num_frames

    @property
    def temporal_resolution(self) -> int:
        assert self.num_patches % self.spatial_resolution == 0
        return self.num_patches // self.spatial_resolution
