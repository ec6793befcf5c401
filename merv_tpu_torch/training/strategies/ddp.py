"""The DDP strategy (counterpart of ``merv_tpu/training/strategies/ddp.py``):
every rank holds the whole model, ``DistributedDataParallel`` sums the
gradients over the batch ranks; with the reference's restriction to zero
weight decay."""

from __future__ import annotations

from merv_tpu_torch.training.strategies.base_strategy import TrainingStrategy


class DDPStrategy(TrainingStrategy):
    sharding_strategy = "ddp"

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        assert self.weight_decay == 0, "DDP training does not currently support `weight_decay` > 0!"
