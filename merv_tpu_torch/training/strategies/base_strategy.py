"""The training strategy and its loop (counterpart of
``merv_tpu/training/strategies/base_strategy.py``).

What ``merv_tpu`` does, kept: the mesh (by default every rank of the world on
``fsdp``, ``build_mesh()``); the world size as data x fsdp, the ranks the
batch splits over, and the batch divisibility check over it;
``grad_accumulation_steps``; the frozen towers cast to their half-precision
dtype; the state sharded by the strategy (:func:`shard_train_state`) and the
step run in the mesh's activation scope; the sampler by stage
(:class:`SplitModalitySampler` for finetune, a seeded epoch permutation
otherwise); epochs inflated to 100 under ``max_steps``; the resume
fast-forward over consumed batches; checkpoints every
``save_checkpoint_after`` steps, written in the background while training
goes on (``blocking=False``), and at each epoch's end, blocking (recording
the next epoch); every write done before :meth:`run_training` returns; the
step's loss read one step late, so the host does not wait on the step it has
just queued; metrics and trackers on rank zero.

What differs: the step is :func:`make_train_step`'s eager loop, not a jitted
program. The port runs one process a rank, where one ``merv_tpu`` process
spans every local device: the samplers take ``num_replicas`` = data x fsdp
and the rank's batch coordinate (``merv_tpu`` takes the process count and
index), so ranks that differ only in ``sp`` or ``pp`` read the same
examples, and each rank's loader yields its own part of the global batch.
Under ``pp`` each rank keeps only its stage's decoder layers. Without a mesh
and in a world of one process, the one-device step runs (no process group).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from merv_tpu_torch.overwatch import initialize_overwatch
from merv_tpu_torch.parallel.mesh import PIPE_AXIS, axis_rank, axis_size, batch_rank, batch_size, build_mesh, world
from merv_tpu_torch.tracing import ProfilerTrace, span
from merv_tpu_torch.training.checkpointing import (
    load_checkpoint,
    load_sharded_state,
    save_checkpoint,
    wait_for_checkpoints,
)
from merv_tpu_torch.training.metrics import Metrics
from merv_tpu_torch.training.optimizers import build_optimizer, build_schedule
from merv_tpu_torch.training.train_step import TrainSharding, make_loss_fn, make_train_step, shard_train_state
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
        mesh: Any = None,
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
        if mesh is None and world()[1] > 1:  # merv_tpu's default: every rank on fsdp
            mesh = build_mesh(device_type=vidlm.device.type)
        self.mesh = mesh
        # the batch splits over data x fsdp only: tensor / sp / pp ranks split each example's work, not the batch
        self.world_size = batch_size(mesh)

        assert self.global_batch_size % (self.per_device_batch_size * self.world_size) == 0, (
            f"global_bsz {global_batch_size} must be divisible by per_device_bsz {per_device_batch_size}"
            f" x world {self.world_size}"
        )
        self.grad_accumulation_steps = self.global_batch_size // self.per_device_batch_size // self.world_size
        assert self.grad_accumulation_steps >= 1, (
            f"global_bsz {global_batch_size} < per_device_bsz {per_device_batch_size} x world {self.world_size}"
        )
        if not enable_mixed_precision_training:
            raise NotImplementedError("the port computes in bf16 only: there is no fp32 compute path yet")
        assert mixed_precision_dtype == torch.bfloat16, "Only bf16 mixed precision is supported!"

        # set by run_setup
        self.sharding: Optional[TrainSharding] = None
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
            if any(p.dtype != vb.half_precision_dtype for p in vb.parameters()):
                vb.to(vb.half_precision_dtype)

        module = self.vidlm
        if self.mesh is not None:
            pp = axis_size(self.mesh, PIPE_AXIS)
            if pp > 1 and self.vidlm.llm_backbone.decoder.cfg.pipeline_parallel:
                self.vidlm.llm_backbone.decoder.keep_stage(pp, axis_rank(self.mesh, PIPE_AXIS))
            self.sharding = shard_train_state(self.vidlm, self.mesh, self.sharding_strategy)
            module = self.sharding.module
        trainable = self.vidlm.trainable_mask()
        self.schedule = build_schedule(self.lr_scheduler_type, self.learning_rate, self.total_steps, self.warmup_ratio)
        self.tx = build_optimizer(dict(self.vidlm.named_parameters()), self.schedule, self.weight_decay,
                                  self.max_grad_norm, trainable_mask=trainable)
        if self.sharding is not None:
            self.tx.norm_groups, self.tx.norm_keys = self.sharding.sq_norm_groups, self.sharding.norm_keys
        loss_fn = make_loss_fn(module, remat=self.enable_gradient_checkpointing,
                               video_transforms=video_transforms, loss_chunk_size=self.loss_chunk_size)
        self.step_fn = make_train_step(loss_fn, self.tx, grad_accumulation_steps=self.grad_accumulation_steps,
                                       sharding=self.sharding)

        if resume_from_checkpoint is not None:
            self.load_checkpoint(resume_from_checkpoint)
        shape = None if self.mesh is None else dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))
        overwatch.info(f"Strategy `{self.sharding_strategy}` ready: mesh={shape}, accum={self.grad_accumulation_steps}, "
                       f"total_steps={self.total_steps}")

    # -- checkpointing -----------------------------------------------------------

    def _trainable_keys(self) -> List[str]:
        return self.vidlm.trainable_module_keys or ["projectors", "feature_fusion"]

    def save_checkpoint(self, run_dir: Path, global_step: int, epoch: int, train_loss: Optional[float] = None,
                        blocking: bool = True) -> None:
        save_checkpoint(run_dir, global_step, epoch, train_loss if train_loss is not None else 0.0,
                        self.vidlm, self._trainable_keys(), optimizer=self.tx, blocking=blocking, mesh=self.mesh)

    def load_checkpoint(self, checkpoint_path: Path) -> None:
        """Resume from a checkpoint written at any world size."""
        if self.mesh is None:
            restored = load_checkpoint(checkpoint_path, map_location=self.vidlm.device)
            for key, state in restored["model"].items():
                getattr(self.vidlm, key).load_state_dict(state, strict=True)
            self.tx.load_state_dict(restored["optimizer"])
        else:
            restored = load_checkpoint(checkpoint_path)
            load_sharded_state(self.vidlm, self.tx, restored, self.mesh)
        self._resume_step, self._resume_epoch = restored["step"], restored["epoch"]
        overwatch.info(f"Resumed from {checkpoint_path} at step {self._resume_step}")

    # -- the loop ------------------------------------------------------------------

    def _put_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The rank's collated numpy batch (its sampler's part of the global
        batch) as tensors on the model's device (ids and labels as int64,
        videos as they come: uint8 frames)."""
        dev = self.vidlm.device

        def put(x, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(x))
            return t.to(dev, dtype=dtype, non_blocking=True)

        return dict(
            input_ids=put(batch["input_ids"], torch.long), attention_mask=put(batch["attention_mask"]),
            labels=put(batch["labels"], torch.long), is_multimodal=put(batch["is_multimodal"]),
            video_values=[put(v) for v in batch["video_values"]],
        )

    def sampler(self, dataset, stage: str, seed: int):
        """The stage's sampler over the batch ranks: ``num_replicas`` data x
        fsdp and this rank's batch coordinate, so that ranks differing only in
        ``sp`` or ``pp`` read the same examples (one process a rank; ``merv_tpu``
        takes the process count, one process holding every local device)."""
        replicas, rank = self.world_size, batch_rank(self.mesh)
        if "finetune" in stage:
            return SplitModalitySampler(dataset, dataset.get_modality_lengths(),
                                        global_batch_size=self.global_batch_size, num_replicas=replicas, rank=rank,
                                        seed=seed)
        return EpochShardSampler(dataset, num_replicas=replicas, rank=rank, seed=seed)

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
        ``timings``, with device syncs), its wall time ``step_s`` (the
        ``train.batch`` span: the batch's upload and the step), its ``loss``
        (the mean over its micro-batches) and its ``grad_norm``.

        ``MERV_TPU_PROFILE=<dir>`` profiles steps 3-8 on rank zero into
        ``<dir>/train_steps.json`` (:class:`~merv_tpu_torch.tracing.ProfilerTrace`:
        the device's activity on the card, the host's operators on a CPU run,
        and the program's spans)."""
        import torch.utils.data as tud

        sampler = self.sampler(dataset, stage, seed)
        dataloader = tud.DataLoader(dataset, batch_size=self.global_batch_size // self.world_size, sampler=sampler,
                                    collate_fn=collator,
                                    num_workers=num_workers, drop_last=True, worker_init_fn=self.worker_init_fn)

        steps_per_epoch = len(dataloader)
        epochs = self.epochs
        if self.max_steps is not None and steps_per_epoch < self.max_steps:
            epochs = 100  # reference base_strategy.py:163-167

        profile_dir = os.environ.get("MERV_TPU_PROFILE") if world()[0] == 0 else None
        profiler: Optional[ProfilerTrace] = None

        def stop_profile() -> None:
            nonlocal profiler
            if profiler is not None and profiler.prof is not None:
                overwatch.info(f"profile of steps {self._resume_step + 4}-{global_step} -> {profiler.stop()}")

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
            if p_step % 10 == 0 and world()[0] == 0:
                overwatch.info(status)

        for epoch in range(self._resume_epoch, epochs):
            sampler.set_epoch(epoch)
            for batch_idx, batch in enumerate(dataloader):
                if epoch == self._resume_epoch and self._resume_step > 0:
                    if batch_idx < (self._resume_step % max(steps_per_epoch, 1)):
                        continue
                if profile_dir and profiler is None and global_step == self._resume_step + 3:
                    profiler = ProfilerTrace(Path(profile_dir) / "train_steps.json")
                    profiler.start()
                timings = None if step_timings is None else {}
                with span("train.batch", timings=timings, key="step_s"):
                    step_metrics = self.step_fn(self._put_batch(batch), timings)
                global_step += 1
                if global_step >= self._resume_step + 8:
                    stop_profile()
                if timings is not None:
                    timings["loss"] = float(step_metrics["loss"])
                    timings["grad_norm"] = float(step_metrics["grad_norm"])
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
        stop_profile()
        wait_for_checkpoints()
