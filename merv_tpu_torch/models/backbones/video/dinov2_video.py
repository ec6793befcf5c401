"""DINOv2 video backbone: per-frame ViT-L/14 with registers
(counterpart of ``merv_tpu/models/backbones/video/dinov2_video.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from merv_tpu_torch.models.backbones.video.base_video import VideoBackbone
from merv_tpu_torch.models.backbones.video.vit import DINOV2_LARGE_REG4, ViTConfig
from merv_tpu_torch.preprocessing.transforms import IMAGENET_MEAN, IMAGENET_STD, VideoTransform

DINOv2_VISION_BACKBONES = {
    "dinov2-video": "vit_large_patch14_reg4_dinov2.lvd142m",
    "dinov2-video-all-tokens": "vit_large_patch14_reg4_dinov2.lvd142m",
    "dinov2-video-classemb-at-first": "vit_large_patch14_reg4_dinov2.lvd142m",
    "dinov2-video-all-token-with-cls": "vit_large_patch14_reg4_dinov2.lvd142m",
}


class DinoV2VideoBackbone(VideoBackbone):
    def __init__(
        self,
        video_backbone_id: str,
        image_resize_strategy: str,
        default_image_size: int = 224,
        num_frames: int = 8,
        vit_config: Optional[ViTConfig] = None,
        param_dtype: Optional[torch.dtype] = None,
        device: Optional[torch.device] = None,
    ) -> None:
        super().__init__(
            video_backbone_id, image_resize_strategy, default_image_size, num_frames, vit_config, param_dtype
        )
        if video_backbone_id not in DINOv2_VISION_BACKBONES:
            raise ValueError(video_backbone_id)
        self.video_transform = VideoTransform(
            target_size=default_image_size, resize_strategy=image_resize_strategy,
            shortest_edge=default_image_size, interpolation="bicubic", mean=IMAGENET_MEAN, std=IMAGENET_STD,
        )
        self._build(device)

    def default_vit_config(self) -> ViTConfig:
        return dataclasses.replace(DINOV2_LARGE_REG4, image_size=self.default_image_size)

    def forward(self, video_values: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        """video_values: [B, F, C, H, W] -> [B, num_patches, D]."""
        B, F, C, H, W = video_values.shape
        frames = video_values.reshape(B * F, C, H, W)
        c = self.vit_config
        if self.identifier == "dinov2-video":
            feats = self.vit(frames, skip_last_layers=0, apply_final_norm=True, impl=impl)
            return feats[:, 0].reshape(B, F, c.hidden_size)
        feats = self.vit(frames, skip_last_layers=1, impl=impl)
        patches = feats[:, c.num_prefix_tokens :].reshape(B, -1, c.hidden_size)
        if "classemb-at-first" in self.identifier:
            cls = feats[:, :1].reshape(B, F, c.hidden_size).mean(dim=1, keepdim=True)
            return torch.cat([cls, patches], dim=1)
        if "all-token-with-cls" in self.identifier:
            return torch.cat([feats[:, :1].reshape(B, F, c.hidden_size), patches], dim=1)
        return patches

    @property
    def default_video_resolution(self) -> Tuple[int, int, int, int]:
        return (self.num_frames, 3, self.default_image_size, self.default_image_size)

    @property
    def num_patches(self) -> int:
        if "classemb-at-first" in self.identifier:
            return self.num_frames * self.vit_config.num_patches
        if "all-tokens" not in self.identifier and "all-token-with-cls" not in self.identifier:
            return self.num_frames
        return self.num_frames * self.vit_config.num_patches
