"""Model configurations of the main path (counterpart of ``merv_tpu/conf/models.py``).

The fields of ``merv_tpu``'s ``ModelConfig`` (names, defaults and the
``merv-base`` / ``merv-full`` values): the towers and LLM, the projector
grammar, the fusion, the token lengths and the two stages' training recipes.
The draccus-style CLI registry and the single-encoder variants wait (ROADMAP
A1, A10).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Union


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

    # align stage
    align_epochs: int
    align_max_steps: Optional[int]
    align_global_batch_size: int
    align_per_device_batch_size: int
    align_learning_rate: float
    align_weight_decay: float
    align_max_grad_norm: float
    align_lr_scheduler_type: str
    align_warmup_ratio: float
    align_train_strategy: str

    # finetune stage
    finetune_epochs: int
    finetune_max_steps: Optional[int]
    finetune_global_batch_size: int
    finetune_per_device_batch_size: int
    finetune_learning_rate: float
    finetune_weight_decay: float
    finetune_max_grad_norm: float
    finetune_lr_scheduler_type: str
    finetune_warmup_ratio: float
    finetune_train_strategy: str

    enable_gradient_checkpointing: bool = True  # per-layer activation checkpointing of the LLM
    save_checkpoint_after: int = 512  # optimizer steps between checkpoints
    enable_mixed_precision_training: bool = True  # bf16 compute (the port has no fp32 compute path)
    reduce_in_full_precision: bool = False  # merv_tpu's field, so its config.json dumps load here

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

    align_epochs: int = 1
    align_max_steps: Optional[int] = None
    align_global_batch_size: int = 256
    align_per_device_batch_size: int = 16
    align_learning_rate: float = 1e-3
    align_weight_decay: float = 0.0
    align_max_grad_norm: float = 1.0
    align_lr_scheduler_type: str = "linear-warmup+cosine-decay"
    align_warmup_ratio: float = 0.03
    align_train_strategy: str = "fsdp-shard-grad-op"

    finetune_epochs: int = 1
    finetune_max_steps: Optional[int] = None
    finetune_global_batch_size: int = 128
    finetune_per_device_batch_size: int = 8
    finetune_learning_rate: float = 2e-5
    finetune_weight_decay: float = 0.1
    finetune_max_grad_norm: float = 1.0
    finetune_lr_scheduler_type: str = "linear-warmup+cosine-decay"
    finetune_warmup_ratio: float = 0.03
    finetune_train_strategy: str = "fsdp-full-shard"


@dataclass
class MERV_Full(MERV_Base):
    model_id: str = "merv-full"
    arch_specifier: str = "3davg+linear"
    align_train_strategy: str = "fsdp-full-shard"
    align_learning_rate: float = 1e-4

