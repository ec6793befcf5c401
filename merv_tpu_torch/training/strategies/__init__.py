from merv_tpu_torch.training.strategies.base_strategy import TrainingStrategy
from merv_tpu_torch.training.strategies.ddp import DDPStrategy
from merv_tpu_torch.training.strategies.fsdp import FSDPStrategy

__all__ = ["DDPStrategy", "FSDPStrategy", "TrainingStrategy"]
