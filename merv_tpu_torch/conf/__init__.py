from merv_tpu_torch.conf.datasets import DatasetConfig, DatasetRegistry, VideoLLaVA_Config
from merv_tpu_torch.conf.models import (
    DINOv2_Single_Encoder,
    LanguageBind_Single_Encoder,
    LLaVa_v15_Reproduction_13B,
    MERV_Base,
    MERV_Full,
    ModelConfig,
    ModelRegistry,
    SigLIP_Single_Encoder,
    ViViT_Single_Encoder,
)

__all__ = [
    "DatasetConfig",
    "DatasetRegistry",
    "DINOv2_Single_Encoder",
    "LanguageBind_Single_Encoder",
    "LLaVa_v15_Reproduction_13B",
    "MERV_Base",
    "MERV_Full",
    "ModelConfig",
    "ModelRegistry",
    "SigLIP_Single_Encoder",
    "VideoLLaVA_Config",
    "ViViT_Single_Encoder",
]
