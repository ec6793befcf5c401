"""Training (counterpart of ``merv_tpu/training``): the schedule and the
clipped AdamW, the train step and its sharding over a mesh, metrics and
trackers, checkpoints, and the strategies with their loop."""

from merv_tpu_torch.training.materialize import TRAIN_STRATEGIES, get_train_strategy
from merv_tpu_torch.training.metrics import JSONLinesTracker, Metrics, Tracker, WeightsBiasesTracker
from merv_tpu_torch.training.strategies import DDPStrategy, FSDPStrategy, TrainingStrategy

__all__ = [
    "DDPStrategy",
    "FSDPStrategy",
    "JSONLinesTracker",
    "Metrics",
    "TRAIN_STRATEGIES",
    "Tracker",
    "TrainingStrategy",
    "WeightsBiasesTracker",
    "get_train_strategy",
]
