"""ViViT video backbone: spatio-temporal tubelet transformer
(counterpart of ``merv_tpu/models/backbones/video/vivit.py``).

32-frame input with 2x16x16 tubelets -> [B, 3137, 768] last hidden state
(final LayerNorm applied); the main path's ``all-no-cls-16frames`` mode keeps
all 16 temporal slices without the cls token.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from merv_tpu_torch.models.backbones.video.base_video import VideoBackbone
from merv_tpu_torch.models.backbones.video.vit import VIVIT_BASE_16x2, ViTConfig
from merv_tpu_torch.preprocessing.transforms import SIGLIP_MEAN, SIGLIP_STD, VideoTransform

ViVIT_VISION_BACKBONES = {
    "vivit-google-b-cls-token": "google/vivit-b-16x2-kinetics400",
    "vivit-google-b-all-tokens": "google/vivit-b-16x2-kinetics400",
    "vivit-google-b-all-no-cls": "google/vivit-b-16x2-kinetics400",
    "vivit-google-b-all-no-cls-16frames": "google/vivit-b-16x2-kinetics400",
    "vivit-google-b-classemb-at-first-16frames": "google/vivit-b-16x2-kinetics400",
}


class ViVITVideoBackbone(VideoBackbone):
    def __init__(
        self,
        video_backbone_id: str,
        image_resize_strategy: str,
        default_image_size: int = 224,
        num_frames: int = 32,
        vit_config: Optional[ViTConfig] = None,
        param_dtype: Optional[torch.dtype] = None,
        device: Optional[torch.device] = None,
    ) -> None:
        super().__init__(
            video_backbone_id, image_resize_strategy, default_image_size, num_frames, vit_config, param_dtype
        )
        if video_backbone_id not in ViVIT_VISION_BACKBONES:
            raise ValueError(video_backbone_id)
        self.video_transform = VideoTransform(
            target_size=default_image_size, resize_strategy=image_resize_strategy, shortest_edge=256,
            interpolation="bilinear", mean=SIGLIP_MEAN, std=SIGLIP_STD,
        )
        self._build(device)

    def default_vit_config(self) -> ViTConfig:
        return dataclasses.replace(VIVIT_BASE_16x2, image_size=self.default_image_size, tubelet_frames=self.num_frames)

    @property
    def _grid(self) -> int:
        return self.default_image_size // self.vit_config.patch_size

    @property
    def _temporal_slices(self) -> int:
        return self.num_frames // self.vit_config.tubelet_t

    def forward(self, video_values: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        """video_values: [B, F, C, H, W] -> variant-dependent token features."""
        B = video_values.shape[0]
        feats = self.vit(video_values.transpose(1, 2), skip_last_layers=0, apply_final_norm=True, impl=impl)
        D = self.embed_dim
        if "cls-token" in self.identifier:
            return feats[:, :1]
        if "all-no-cls" in self.identifier:
            t, s = self._temporal_slices, self._grid
            tokens = feats[:, 1:].reshape(B, t, s, s, D)
            if "16frames" in self.identifier:
                return tokens.reshape(B, t * s * s, D)
            return tokens[:, ::2].reshape(B, (t // 2) * s * s, D)
        return feats  # all-tokens and classemb-at-first: cls + patches

    @property
    def default_video_resolution(self) -> Tuple[int, int, int, int]:
        return (self.num_frames, 3, self.default_image_size, self.default_image_size)

    @property
    def num_patches(self) -> int:
        t, s = self._temporal_slices, self._grid
        if "cls-token" in self.identifier:
            return 1
        if "all-tokens" in self.identifier:
            return t * s * s + 1
        if "all-no-cls-16frames" in self.identifier:
            return t * s * s
        if "all-no-cls" in self.identifier:
            return t * s * s // 2
        if "classemb-at-first" in self.identifier:
            return t * s * s
        raise NotImplementedError(self.identifier)

    @property
    def spatial_resolution(self) -> int:
        if "all-no-cls" in self.identifier or "classemb-at-first" in self.identifier:
            return self._grid * self._grid
        return self.num_patches
