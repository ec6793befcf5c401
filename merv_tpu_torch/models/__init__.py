from merv_tpu_torch.models.materialize import (
    get_llm_backbone_and_tokenizer,
    get_video_backbone_and_transform,
    get_vidlm,
)

__all__ = ["get_llm_backbone_and_tokenizer", "get_video_backbone_and_transform", "get_vidlm"]
