"""Train-strategy factory (counterpart of ``merv_tpu/training/materialize.py``).

All three strategy names are accepted; each shards the train state over
``mesh`` (by default every rank of a multi-process world on ``fsdp``; on one
process the one-device step runs).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from merv_tpu_torch.training.strategies import DDPStrategy, FSDPStrategy, TrainingStrategy

TRAIN_STRATEGIES = {
    "fsdp-shard-grad-op": {"cls": FSDPStrategy, "kwargs": {"sharding_strategy": "shard-grad-op"}},
    "fsdp-full-shard": {"cls": FSDPStrategy, "kwargs": {"sharding_strategy": "full-shard"}},
    "ddp": {"cls": DDPStrategy, "kwargs": {}},
}


def get_train_strategy(
    train_strategy: str,
    vidlm: Any,
    device_id: int = 0,
    stage: str = "finetune",
    epochs: int = 1,
    max_steps: Optional[int] = None,
    global_batch_size: int = 128,
    per_device_batch_size: int = 8,
    learning_rate: float = 2e-5,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
    lr_scheduler_type: str = "linear-warmup+cosine-decay",
    warmup_ratio: float = 0.03,
    enable_gradient_checkpointing: bool = True,
    enable_mixed_precision_training: bool = True,
    worker_init_fn: Optional[Callable[[int], None]] = None,
    save_checkpoint_after: int = 512,
    loss_chunk_size: Optional[int] = None,
    mesh: Any = None,
) -> TrainingStrategy:
    if train_strategy not in TRAIN_STRATEGIES:
        raise ValueError(f"Train Strategy `{train_strategy}` is not supported!")
    entry = TRAIN_STRATEGIES[train_strategy]
    return entry["cls"](
        vidlm,
        device_id=device_id,
        stage=stage,
        epochs=epochs,
        max_steps=max_steps,
        global_batch_size=global_batch_size,
        per_device_batch_size=per_device_batch_size,
        learning_rate=learning_rate,
        weight_decay=weight_decay,
        max_grad_norm=max_grad_norm,
        lr_scheduler_type=lr_scheduler_type,
        warmup_ratio=warmup_ratio,
        enable_gradient_checkpointing=enable_gradient_checkpointing,
        enable_mixed_precision_training=enable_mixed_precision_training,
        worker_init_fn=worker_init_fn,
        save_checkpoint_after=save_checkpoint_after,
        loss_chunk_size=loss_chunk_size,
        mesh=mesh,
        **entry["kwargs"],
    )
