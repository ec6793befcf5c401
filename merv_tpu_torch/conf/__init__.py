from merv_tpu_torch.conf.models import MERV_Base, MERV_Full, ModelConfig

__all__ = ["MERV_Base", "MERV_Full", "ModelConfig"]
