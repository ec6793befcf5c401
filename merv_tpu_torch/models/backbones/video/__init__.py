from merv_tpu_torch.models.backbones.video.base_video import VideoBackbone
from merv_tpu_torch.models.backbones.video.dinov2_video import DinoV2VideoBackbone
from merv_tpu_torch.models.backbones.video.hiera import HieraVideoBackbone
from merv_tpu_torch.models.backbones.video.languagebind import LangBindVideoBackbone
from merv_tpu_torch.models.backbones.video.siglip import SiglipVideoBackbone
from merv_tpu_torch.models.backbones.video.vivit import ViVITVideoBackbone

__all__ = [
    "DinoV2VideoBackbone",
    "HieraVideoBackbone",
    "LangBindVideoBackbone",
    "SiglipVideoBackbone",
    "VideoBackbone",
    "ViVITVideoBackbone",
]
