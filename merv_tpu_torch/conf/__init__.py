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
    "DINOv2_Single_Encoder",
    "LanguageBind_Single_Encoder",
    "LLaVa_v15_Reproduction_13B",
    "MERV_Base",
    "MERV_Full",
    "ModelConfig",
    "ModelRegistry",
    "SigLIP_Single_Encoder",
    "ViViT_Single_Encoder",
]
