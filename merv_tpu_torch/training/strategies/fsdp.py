"""The FSDP-named strategies (counterpart of ``merv_tpu/training/strategies/fsdp.py``).

``fsdp-full-shard`` (ZeRO-3) and ``fsdp-shard-grad-op`` (ZeRO-2) are the
names the recipes carry. On one device there is nothing to shard, so both
run :class:`TrainingStrategy`'s single-device loop; sharding parameters and
optimizer state across cards waits for ROADMAP A12.
"""

from __future__ import annotations

from merv_tpu_torch.training.strategies.base_strategy import TrainingStrategy


class FSDPStrategy(TrainingStrategy):
    def __init__(self, *args, sharding_strategy: str = "full-shard", **kwargs) -> None:
        self.sharding_strategy = (
            "fsdp-full-shard" if sharding_strategy in ("full-shard", "fsdp-full-shard") else "fsdp-shard-grad-op"
        )
        super().__init__(*args, **kwargs)
