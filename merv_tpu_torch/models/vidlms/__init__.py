from merv_tpu_torch.models.vidlms.base_vidlm import IGNORE_INDEX, VidLM
from merv_tpu_torch.models.vidlms.merv import MERV

__all__ = ["IGNORE_INDEX", "MERV", "VidLM"]
