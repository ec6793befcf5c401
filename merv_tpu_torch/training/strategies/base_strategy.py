"""The training strategy and its loop (counterpart of
``merv_tpu/training/strategies/base_strategy.py``), on one device.

What ``merv_tpu`` does, kept: the batch divisibility check and
``grad_accumulation_steps``; the frozen towers cast to their half-precision
dtype; the sampler by stage (:class:`SplitModalitySampler` for finetune, a
seeded epoch permutation otherwise); epochs inflated to 100 under
``max_steps``; the resume fast-forward over consumed batches; checkpoints
every ``save_checkpoint_after`` steps, written in the background while
training goes on (``blocking=False``), and at each epoch's end, blocking
(recording the next epoch); every write done before :meth:`run_training`
returns; the step's loss read one step late, so the host does not wait on the
step it has just queued.

What differs: the step is :func:`make_train_step`'s eager loop, not a jitted
program; the world is one device (the model's), so the sharding strategies
differ only in name until multi-card training lands (ROADMAP A12).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from merv_tpu_torch.overwatch import initialize_overwatch
from merv_tpu_torch.training.checkpointing import load_checkpoint, save_checkpoint, wait_for_checkpoints
from merv_tpu_torch.training.metrics import Metrics
from merv_tpu_torch.training.optimizers import build_optimizer, build_schedule
from merv_tpu_torch.training.train_step import make_loss_fn, make_train_step
from merv_tpu_torch.util.batching_utils import EpochShardSampler, SplitModalitySampler

overwatch = initialize_overwatch(__name__)


class TrainingStrategy:
    sharding_strategy: str = "fsdp-full-shard"

    def __init__(
        self,
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
        mixed_precision_dtype: torch.dtype = torch.bfloat16,
        worker_init_fn: Optional[Callable[[int], None]] = None,
        save_checkpoint_after: int = 512,
        loss_chunk_size: Optional[int] = None,
        **_: Any,
    ) -> None:
        self.vidlm, self.stage = vidlm, stage
        self.epochs, self.max_steps = epochs, max_steps
        self.global_batch_size, self.per_device_batch_size = global_batch_size, per_device_batch_size
        self.learning_rate, self.weight_decay, self.max_grad_norm = learning_rate, weight_decay, max_grad_norm
        self.lr_scheduler_type, self.warmup_ratio = lr_scheduler_type, warmup_ratio
        self.enable_gradient_checkpointing = enable_gradient_checkpointing
        self.worker_init_fn = worker_init_fn
        self.save_checkpoint_after = save_checkpoint_after
        self.loss_chunk_size = loss_chunk_size
        self.world_size = 1

        assert self.global_batch_size % (self.per_device_batch_size * self.world_size) == 0, (
            f"global_bsz {global_batch_size} must be divisible by per_device_bsz {per_device_batch_size}"
            f" x world {self.world_size}"
        )
        self.grad_accumulation_steps = self.global_batch_size // self.per_device_batch_size // self.world_size
        if not enable_mixed_precision_training:
            raise NotImplementedError("the port computes in bf16 only: there is no fp32 compute path yet")
        assert mixed_precision_dtype == torch.bfloat16, "Only bf16 mixed precision is supported!"

        # set by run_setup
        self.tx = None
        self.schedule = None
        self.step_fn: Optional[Callable] = None
        self.total_steps = 0
        self._resume_step = 0
        self._resume_epoch = 0

    # -- setup -------------------------------------------------------------------

    def run_setup(
        self,
        run_dir: Path,
        n_train_examples: int,
        video_transforms: Optional[List[Any]] = None,
        resume_from_checkpoint: Optional[Path] = None,
        seed: int = 7,
    ) -> None:
        """Schedule, optimizer and step for the model as it stands (weights
        loaded or initialised by the caller, ``freeze_backbones`` applied)."""
        steps_per_epoch = max(n_train_examples // self.global_batch_size, 1)
        self.total_steps = self.max_steps if self.max_steps is not None else steps_per_epoch * self.epochs

        for vb in self.vidlm.video_backbones:  # frozen towers in their half-precision dtype
            vb.to(vb.half_precision_dtype)

        trainable = self.vidlm.trainable_mask()
        self.schedule = build_schedule(self.lr_scheduler_type, self.learning_rate, self.total_steps, self.warmup_ratio)
        self.tx = build_optimizer(dict(self.vidlm.named_parameters()), self.schedule, self.weight_decay,
                                  self.max_grad_norm, trainable_mask=trainable)
        loss_fn = make_loss_fn(self.vidlm, remat=self.enable_gradient_checkpointing,
                               video_transforms=video_transforms, loss_chunk_size=self.loss_chunk_size)
        self.step_fn = make_train_step(loss_fn, self.tx, grad_accumulation_steps=self.grad_accumulation_steps)

        if resume_from_checkpoint is not None:
            self.load_checkpoint(resume_from_checkpoint)
        overwatch.info(f"Strategy `{self.sharding_strategy}` ready: accum={self.grad_accumulation_steps}, "
                       f"total_steps={self.total_steps}")

    # -- checkpointing -----------------------------------------------------------

    def _trainable_keys(self) -> List[str]:
        return self.vidlm.trainable_module_keys or ["projectors", "feature_fusion"]

    def save_checkpoint(self, run_dir: Path, global_step: int, epoch: int, train_loss: Optional[float] = None,
                        blocking: bool = True) -> None:
        save_checkpoint(run_dir, global_step, epoch, train_loss if train_loss is not None else 0.0,
                        self.vidlm, self._trainable_keys(), optimizer=self.tx, blocking=blocking)

    def load_checkpoint(self, checkpoint_path: Path) -> None:
        restored = load_checkpoint(checkpoint_path, map_location=self.vidlm.device)
        for key, state in restored["model"].items():
            getattr(self.vidlm, key).load_state_dict(state, strict=True)
        self.tx.load_state_dict(restored["optimizer"])
        self._resume_step, self._resume_epoch = restored["step"], restored["epoch"]
        overwatch.info(f"Resumed from {checkpoint_path} at step {self._resume_step}")

    # -- the loop ------------------------------------------------------------------

    def _put_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The collated numpy batch as tensors on the model's device (ids and
        labels as int64, videos as they come: uint8 frames)."""
        dev = self.vidlm.device

        def put(x, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(x))
            return t.to(dev, dtype=dtype, non_blocking=True)

        return dict(
            input_ids=put(batch["input_ids"], torch.long), attention_mask=put(batch["attention_mask"]),
            labels=put(batch["labels"], torch.long), is_multimodal=put(batch["is_multimodal"]),
            video_values=[put(v) for v in batch["video_values"]],
        )

    def run_training(
        self,
        dataset,
        collator,
        metrics: Metrics,
        stage: str = "finetune",
        seed: int = 7,
        run_dir: Optional[Path] = None,
        num_workers: int = 2,
        step_timings: Optional[List[Dict[str, float]]] = None,
    ) -> None:
        """Train until ``max_steps`` or the last epoch. ``step_timings`` (a
        list) receives each step's phase split (``make_train_step``'s
        ``timings``, with device syncs), its wall time ``step_s`` and its
        ``loss`` (the mean over its micro-batches)."""
        import time

        import torch.utils.data as tud

        if "finetune" in stage:
            sampler = SplitModalitySampler(dataset, dataset.get_modality_lengths(),
                                           global_batch_size=self.global_batch_size, seed=seed)
        else:
            sampler = EpochShardSampler(dataset, seed=seed)
        dataloader = tud.DataLoader(dataset, batch_size=self.global_batch_size, sampler=sampler, collate_fn=collator,
                                    num_workers=num_workers, drop_last=True, worker_init_fn=self.worker_init_fn)

        steps_per_epoch = len(dataloader)
        epochs = self.epochs
        if self.max_steps is not None and steps_per_epoch < self.max_steps:
            epochs = 100  # reference base_strategy.py:163-167

        global_step = self._resume_step
        loss = 0.0
        done = False
        pending = None  # (global step, 0-d loss on the device), read one step late

        def drain_pending() -> None:
            nonlocal loss, pending
            if pending is None:
                return
            p_step, p_loss = pending
            pending = None
            loss = float(p_loss)
            metrics.commit(global_step=p_step, lr=float(self.schedule(p_step)), update_step_time=True, loss=loss)
            status = metrics.push()
            if p_step % 10 == 0:
                overwatch.info(status)

        for epoch in range(self._resume_epoch, epochs):
            sampler.set_epoch(epoch)
            for batch_idx, batch in enumerate(dataloader):
                if epoch == self._resume_epoch and self._resume_step > 0:
                    if batch_idx < (self._resume_step % max(steps_per_epoch, 1)):
                        continue
                timings = None if step_timings is None else {}
                t = time.perf_counter()
                step_metrics = self.step_fn(self._put_batch(batch), timings)
                global_step += 1
                if timings is not None:
                    timings["step_s"] = time.perf_counter() - t
                    timings["loss"] = float(step_metrics["loss"])
                    step_timings.append(timings)

                drain_pending()
                pending = (global_step, step_metrics["loss"])

                if run_dir is not None and global_step % self.save_checkpoint_after == 0:
                    drain_pending()
                    # async: the write runs beside the next steps; the host copy is all this waits for
                    self.save_checkpoint(run_dir, global_step, epoch, loss, blocking=False)

                if self.max_steps is not None and global_step >= self.max_steps:
                    done = True
                    break
            drain_pending()
            if run_dir is not None:  # records the next epoch, so a resume does not replay this one (blocking:
                self.save_checkpoint(run_dir, global_step, epoch + 1, loss)  # the run may end right after)
            if done:
                break
        drain_pending()
        wait_for_checkpoints()
