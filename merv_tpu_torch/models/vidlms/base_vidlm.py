"""VidLM abstraction (counterpart of ``merv_tpu/models/vidlms/base_vidlm.py``)."""

from __future__ import annotations

from typing import List

from torch import nn

from merv_tpu_torch.models.backbones.llm.base_llm import LLMBackbone
from merv_tpu_torch.models.backbones.video.base_video import VideoBackbone

IGNORE_INDEX = -100


class VidLM(nn.Module):
    def __init__(
        self, model_family: str, model_id: str, video_backbones: List[VideoBackbone], llm_backbone: LLMBackbone
    ) -> None:
        super().__init__()
        self.model_family = model_family
        self.model_id = model_id
        self.video_backbones = nn.ModuleList(video_backbones)
        self.llm_backbone = llm_backbone
