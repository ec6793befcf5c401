"""LanguageBind-Video backbone: CLIP ViT-L/14 with per-layer temporal attention
(counterpart of ``merv_tpu/models/backbones/video/languagebind.py``).

Input ``[B, C, F, H, W]``; feature tap ``hidden_states[-2]``. Temporal attention
runs in windows of the checkpoint's ``temporal_frames`` (8) whatever the
runtime frame count, so 16-frame MERV input attends in two 8-frame windows.
As in ``merv_tpu``, there is no random horizontal flip at eval.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from merv_tpu_torch.models.backbones.video.base_video import VideoBackbone
from merv_tpu_torch.models.backbones.video.vit import LANGUAGEBIND_VIDEO_LARGE, ViTConfig
from merv_tpu_torch.preprocessing.transforms import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD, VideoTransform

_TOKEN_MODES = {
    "languagebind-video": None,
    "languagebind-video-averagetoken": "average",
    "languagebind-video-classemb": "classemb",
    "languagebind-video-noclass": "noclass",
    "languagebind-video-classemb-at-first": "classemb-at-first",
}


class LangBindVideoBackbone(VideoBackbone):
    def __init__(
        self,
        video_backbone_id: str,
        image_resize_strategy: str,
        default_image_size: int = 224,
        num_frames: int = 8,
        token: Optional[str] = None,
        vit_config: Optional[ViTConfig] = None,
        param_dtype: Optional[torch.dtype] = None,
        device: Optional[torch.device] = None,
    ) -> None:
        super().__init__(
            video_backbone_id, image_resize_strategy, default_image_size, num_frames, vit_config, param_dtype
        )
        if video_backbone_id not in _TOKEN_MODES:
            raise ValueError(video_backbone_id)
        self.token = token if token is not None else _TOKEN_MODES[video_backbone_id]
        self.video_transform = VideoTransform(
            target_size=default_image_size, resize_strategy="resize-crop", shortest_edge=default_image_size,
            interpolation="bilinear", mean=OPENAI_DATASET_MEAN, std=OPENAI_DATASET_STD, channels_first_time=True,
        )
        self._build(device)

    def default_vit_config(self) -> ViTConfig:
        return dataclasses.replace(LANGUAGEBIND_VIDEO_LARGE, image_size=self.default_image_size)

    def forward(self, video_values: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        """video_values: [B, C, F, H, W] -> token features (mode-dependent)."""
        B, C, F, H, W = video_values.shape
        frames = video_values.transpose(1, 2).reshape(B * F, C, H, W)
        c = self.vit_config
        window = min(c.temporal_frames, F)
        feats = self.vit(frames, skip_last_layers=1, frames=window, impl=impl)
        feats = feats.reshape(B, F, feats.shape[1], c.hidden_size)
        if self.token == "average":
            feats = feats.mean(dim=-2)
        elif self.token == "classemb":
            feats = feats[:, :, 0, :]
        elif self.token == "noclass":
            feats = feats[:, :, 1:, :]
        elif self.token == "classemb-at-first":
            cls = feats[:, :, 0, :].mean(dim=1, keepdim=True)
            return torch.cat([cls, feats[:, :, 1:, :].reshape(B, -1, self.embed_dim)], dim=1)
        return feats.reshape(B, -1, self.embed_dim)

    @property
    def default_video_resolution(self) -> Tuple[int, int, int, int]:
        return (3, self.num_frames, self.default_image_size, self.default_image_size)

    @property
    def num_patches(self) -> int:
        per_frame = self.vit_config.num_patches + 1
        if self.token is None:
            return self.num_frames * per_frame
        if self.token in ("average", "classemb"):
            return self.num_frames
        return self.num_frames * (per_frame - 1)
