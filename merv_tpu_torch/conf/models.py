"""Model configurations (counterpart of ``merv_tpu/conf/models.py``).

The fields of ``merv_tpu``'s ``ModelConfig`` (names, defaults and values):
the towers and LLM, the projector grammar, the fusion, the token lengths and
the two stages' training recipes; and its seven registered variants
(``merv-base``, ``merv-full``, the four single-encoder models and the
LLaVA-1.5-13B reproduction), each registered under ``merv_tpu``'s id
(``ModelConfig.get_choice_class(model_id)``, ``ModelRegistry``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum, unique
from typing import List, Optional, Union

from merv_tpu_torch.conf.registry import ChoiceRegistry


@dataclass
class ModelConfig(ChoiceRegistry):
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



@dataclass
class LanguageBind_Single_Encoder(MERV_Base):
    model_id: str = "languagebind-single"
    video_backbone_ids: List[str] = field(default_factory=lambda: ["languagebind-video-noclass"])
    num_frames: Union[int, List[int]] = field(default_factory=lambda: [16])


@dataclass
class DINOv2_Single_Encoder(MERV_Base):
    model_id: str = "dinov2-single"
    video_backbone_ids: List[str] = field(default_factory=lambda: ["dinov2-video-all-tokens"])
    num_frames: Union[int, List[int]] = field(default_factory=lambda: [16])


@dataclass
class ViViT_Single_Encoder(MERV_Base):
    model_id: str = "vivit-single"
    video_backbone_ids: List[str] = field(default_factory=lambda: ["vivit-google-b-all-no-cls-16frames"])
    num_frames: Union[int, List[int]] = field(default_factory=lambda: [32])


@dataclass
class SigLIP_Single_Encoder(MERV_Base):
    model_id: str = "siglip-single"
    video_backbone_ids: List[str] = field(default_factory=lambda: ["siglip-vit-b16-224px-all-no-cls"])
    num_frames: Union[int, List[int]] = field(default_factory=lambda: [16])


@dataclass
class LLaVa_v15_Reproduction_13B(MERV_Base):
    model_id: str = "reproduction-llava-v15+13b"
    llm_backbone_id: str = "vicuna-v15-13b"


@unique
class ModelRegistry(Enum):
    MERV_BASE = MERV_Base
    MERV_FULL = MERV_Full

    LANGUAGEBIND_SINGLE = LanguageBind_Single_Encoder
    DINOV2_SINGLE = DINOv2_Single_Encoder
    VIVIT_SINGLE = ViViT_Single_Encoder
    SIGLIP_SINGLE = SigLIP_Single_Encoder

    LLAVA_REPRO_13B = LLaVa_v15_Reproduction_13B

    @property
    def model_id(self) -> str:
        return self.value.model_id


for model_variant in ModelRegistry:
    ModelConfig.register_subclass(model_variant.model_id, model_variant.value)
