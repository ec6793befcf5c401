"""Model configurations of the main path (counterpart of ``merv_tpu/conf/models.py``).

Only the fields the inference path reads are kept: which towers and LLM to
build, the projector grammar, the fusion and the token lengths. The training
hyperparameters and the draccus-style CLI registry wait for the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Union


@dataclass
class ModelConfig:
    model_id: str
    arch_specifier: str
    feature_fusion: str
    video_backbone_ids: List[str]
    llm_backbone_id: str
    image_resize_strategy: str
    llm_max_length: int
    num_frames: Union[int, List[int]]
    projector_token_length: int
    visual_feature_length: int

    def __post_init__(self) -> None:
        if isinstance(self.num_frames, int):
            self.num_frames = [self.num_frames for _ in range(len(self.video_backbone_ids))]


@dataclass
class MERV_Base(ModelConfig):
    model_id: str = "merv-base"
    arch_specifier: str = "no-align+3davg+linear"
    feature_fusion: str = "cross_attention_avg_lq"
    video_backbone_ids: List[str] = field(
        default_factory=lambda: [
            "languagebind-video-noclass",
            "dinov2-video-all-tokens",
            "vivit-google-b-all-no-cls-16frames",
            "siglip-vit-b16-224px-all-no-cls",
        ]
    )
    llm_backbone_id: str = "llama2-7b-pure"
    image_resize_strategy: str = "resize-naive"
    llm_max_length: int = 2048
    num_frames: Union[int, List[int]] = field(default_factory=lambda: [16, 16, 32, 16])
    projector_token_length: int = 64
    visual_feature_length: int = 1024


@dataclass
class MERV_Full(MERV_Base):
    model_id: str = "merv-full"
    arch_specifier: str = "3davg+linear"

