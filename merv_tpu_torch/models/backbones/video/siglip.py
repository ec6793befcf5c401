"""SigLIP video backbone: a per-frame ViT with no cls token, B/16 or so400m/14
(counterpart of ``merv_tpu/models/backbones/video/siglip.py``).

The ``all-no-cls`` variants give the penultimate layer's patch tokens; the
pooled variants (every id without ``all-no-cls``) run timm's default forward,
full depth, the final norm and the MAP head, one token a frame. The
``all-tokens`` and ``classemb-at-first`` ids are refused with ``merv_tpu``'s
messages. Every id runs at ``default_image_size`` (224 in the registry, the
256 / 384 px ids too), as in ``merv_tpu``. so400m's head dim is 72 (1152 / 16):
its 256-token frames take K1 (``small_attention_kt``) at D = 72.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from merv_tpu_torch.models.backbones.video.base_video import VideoBackbone
from merv_tpu_torch.models.backbones.video.vit import SIGLIP_BASE_224, SIGLIP_SO400M_224, ViTConfig
from merv_tpu_torch.preprocessing.transforms import SIGLIP_MEAN, SIGLIP_STD, VideoTransform

SIGLIP_VISION_BACKBONES = {
    "siglip-vit-b16-224px": "vit_base_patch16_siglip_224",
    "siglip-vit-b16-224px-all-tokens": "vit_base_patch16_siglip_224",
    "siglip-vit-b16-224px-all-no-cls": "vit_base_patch16_siglip_224",
    "siglip-vit-b16-224px-classemb-at-first": "vit_base_patch16_siglip_224",
    "siglip-vit-b16-256px": "vit_base_patch16_siglip_256",
    "siglip-vit-b16-256px-all-tokens": "vit_base_patch16_siglip_256",
    "siglip-vit-b16-384px": "vit_base_patch16_siglip_384",
    "siglip-vit-b16-384px-all-tokens": "vit_base_patch16_siglip_384",
    "siglip-vit-so400m": "vit_so400m_patch14_siglip_224",
    "siglip-vit-so400m-all-tokens": "vit_so400m_patch14_siglip_224",
    "siglip-vit-so400m-384px": "vit_so400m_patch14_siglip_384",
    "siglip-vit-so400m-384px-all-tokens": "vit_so400m_patch14_siglip_384",
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
            raise ValueError(video_backbone_id)
        self.class_token = "all-no-cls" not in video_backbone_id
        if "all-tokens" in video_backbone_id:
            raise NotImplementedError("SigLIP all-tokens variant is unsupported (no class token in SigLIP)")
        if "classemb-at-first" in video_backbone_id:
            raise NotImplementedError("SigLIP classemb-at-first is inconsistent upstream (no prefix tokens)")
        self.video_transform = VideoTransform(
            target_size=default_image_size, resize_strategy=image_resize_strategy,
            shortest_edge=default_image_size, interpolation="bicubic", mean=SIGLIP_MEAN, std=SIGLIP_STD,
        )
        self._build(device)

    def default_vit_config(self) -> ViTConfig:
        base = SIGLIP_SO400M_224 if "so400m" in self.identifier else SIGLIP_BASE_224
        return dataclasses.replace(base, image_size=self.default_image_size, attn_pool=self.class_token,
                                   attn_pool_heads=base.num_heads)

    def forward(self, video_values: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        """video_values: [B, F, C, H, W] -> [B, F*N, D] penultimate-layer patch
        tokens (all-no-cls) or [B, F, D] (pooled: the MAP head, one token a frame)."""
        B, F, C, H, W = video_values.shape
        frames = video_values.reshape(B * F, C, H, W)
        if self.class_token:
            return self.vit(frames, apply_attn_pool=True, impl=impl).reshape(B, F, self.embed_dim)
        feats = self.vit(frames, skip_last_layers=1, impl=impl)
        return feats.reshape(B, -1, self.embed_dim)

    @property
    def default_video_resolution(self) -> Tuple[int, int, int, int]:
        return (self.num_frames, 3, self.default_image_size, self.default_image_size)

    @property
    def num_patches(self) -> int:
        if self.class_token:
            return self.num_frames
        return self.num_frames * self.vit_config.num_patches
