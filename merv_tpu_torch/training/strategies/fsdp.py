"""The FSDP strategies (counterpart of ``merv_tpu/training/strategies/fsdp.py``).

``fsdp-full-shard`` (ZeRO-3) and ``fsdp-shard-grad-op`` (ZeRO-2) shard the
parameters, gradients and AdamW moments over the mesh's ``fsdp`` axis with
FSDP2's ``fully_shard``, each parameter on the dim that carries
``merv_tpu``'s ``fsdp`` axis: full-shard frees the gathered parameters after
each unit's forward, shard-grad-op keeps them through the step's backward
(:func:`~merv_tpu_torch.training.train_step.shard_train_state`). On one
rank there is nothing to shard and the one-device step runs.
"""

from __future__ import annotations

from merv_tpu_torch.training.strategies.base_strategy import TrainingStrategy


class FSDPStrategy(TrainingStrategy):
    def __init__(self, *args, sharding_strategy: str = "full-shard", **kwargs) -> None:
        self.sharding_strategy = (
            "fsdp-full-shard" if sharding_strategy in ("full-shard", "fsdp-full-shard") else "fsdp-shard-grad-op"
        )
        super().__init__(*args, **kwargs)
