"""SigLIP video backbone: per-frame ViT-B/16, no cls token
(counterpart of ``merv_tpu/models/backbones/video/siglip.py``).

Only the ``all-no-cls`` variants (penultimate-layer patch tokens) are in this
slice; the pooled variants need the MAP attention-pool head, which waits with
the rest of the model zoo (ROADMAP A10).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from merv_tpu_torch.models.backbones.video.base_video import VideoBackbone
from merv_tpu_torch.models.backbones.video.vit import SIGLIP_BASE_224, ViTConfig
from merv_tpu_torch.preprocessing.transforms import SIGLIP_MEAN, SIGLIP_STD, VideoTransform

SIGLIP_VISION_BACKBONES = {
    "siglip-vit-b16-224px-all-no-cls": "vit_base_patch16_siglip_224",
}


class SiglipVideoBackbone(VideoBackbone):
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
        if video_backbone_id not in SIGLIP_VISION_BACKBONES:
            raise NotImplementedError(
                f"{video_backbone_id}: only the all-no-cls SigLIP variant is ported (pooled variants: ROADMAP A10)"
            )
        self.video_transform = VideoTransform(
            target_size=default_image_size, resize_strategy=image_resize_strategy,
            shortest_edge=default_image_size, interpolation="bicubic", mean=SIGLIP_MEAN, std=SIGLIP_STD,
        )
        self._build(device)

    def default_vit_config(self) -> ViTConfig:
        return dataclasses.replace(SIGLIP_BASE_224, image_size=self.default_image_size)

    def forward(self, video_values: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        """video_values: [B, F, C, H, W] -> [B, F*N, D] penultimate-layer patch tokens."""
        B, F, C, H, W = video_values.shape
        feats = self.vit(video_values.reshape(B * F, C, H, W), skip_last_layers=1, impl=impl)
        return feats.reshape(B, -1, self.embed_dim)

    @property
    def default_video_resolution(self) -> Tuple[int, int, int, int]:
        return (self.num_frames, 3, self.default_image_size, self.default_image_size)

    @property
    def num_patches(self) -> int:
        return self.num_frames * self.vit_config.num_patches
