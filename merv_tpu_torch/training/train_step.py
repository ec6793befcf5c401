"""The training step (counterpart of ``merv_tpu/training/train_step.py``).

``merv_tpu`` compiles one XLA program per step: a ``lax.scan`` over
micro-batches that sums gradients, then the clipped AdamW update. The port
runs the same sequence eagerly: for each micro-batch a forward and
``backward()`` that accumulates into ``.grad``, then the mean over the
micro-batches and :class:`~merv_tpu_torch.training.optimizers.ClippedAdamW`.

Frozen parameters are the ones with ``requires_grad`` False
(:meth:`MERV.freeze_backbones`): autograd gives them no ``.grad`` buffer and
skips their weight-gradient products, the counterpart of ``stop_gradient``
on the masked leaves. The sharding functions of ``merv_tpu`` (train-state
specs, sharded jit) wait for multi-card training (ROADMAP A12).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from merv_tpu_torch.models.generation import _sync
from merv_tpu_torch.training.optimizers import ClippedAdamW

Batch = Dict[str, Any]
LossFn = Callable[..., torch.Tensor]


def make_loss_fn(
    model: Any,
    remat: bool = True,
    video_transforms: Optional[Sequence[Any]] = None,
    loss_chunk_size: Optional[int] = None,
    attn_impl: str = "auto",
) -> LossFn:
    """``loss_fn(batch, timings=None)``: the multimodal next-token loss of one
    micro-batch. With ``video_transforms``, ``batch["video_values"]`` holds
    uint8 frames at each tower's geometry ``[B, F, S, S, C]``, normalised on
    the card by ``VideoTransform.device_finish``. ``loss_chunk_size`` streams
    the loss over token blocks (:func:`chunked_causal_lm_loss`). ``attn_impl="plain"``
    runs every attention call through the kernels' plain versions."""

    def loss_fn(batch: Batch, timings: Optional[Dict[str, float]] = None) -> torch.Tensor:
        videos = batch["video_values"]
        if video_transforms is not None:
            t = time.perf_counter()
            videos = [tf.device_finish(v) for tf, v in zip(video_transforms, videos)]
            if timings is not None:
                _sync(videos[0].device)
                timings["towers_s"] = timings.get("towers_s", 0.0) + time.perf_counter() - t
        out = model.forward(
            batch["input_ids"], batch["attention_mask"], videos, labels=batch["labels"],
            is_multimodal=batch.get("is_multimodal"), attn_impl=attn_impl, remat=remat,
            loss_chunk_size=loss_chunk_size, timings=timings,
        )
        return out["loss"]

    return loss_fn


def micro_batch(batch: Batch, i: int, n: int) -> Batch:
    """The i-th of n equal slices of every batch entry along dim 0 (lists of
    per-encoder videos are sliced entry by entry)."""

    def cut(x):
        if isinstance(x, (list, tuple)):
            return [cut(e) for e in x]
        m = x.shape[0] // n
        return x[i * m : (i + 1) * m]

    return {k: cut(v) for k, v in batch.items()}


def make_train_step(
    loss_fn: LossFn,
    tx: ClippedAdamW,
    grad_accumulation_steps: int = 1,
) -> Callable[..., Dict[str, Any]]:
    """``train_step(batch, timings=None) -> {"loss", "grad_norm", "step"}``.

    ``batch`` holds the global batch (leading dim ``accum * micro``); the step
    takes ``grad_accumulation_steps`` equal micro-batches, sums their
    gradients, divides by their count (the plain mean ``merv_tpu`` takes,
    exact for equal micro-batches), clips and updates. ``loss`` is the mean
    of the micro-batch losses, ``grad_norm`` the global norm before the clip,
    both 0-d tensors on the device (read them when needed: reading syncs).

    ``timings`` (a dict) adds a device sync at each boundary and fills
    ``towers_s`` (frame normalisation and the towers), ``llm_s`` (projectors,
    fusion, LLM forward and backward, the loss) and ``optimizer_s``."""
    n = grad_accumulation_steps
    if n < 1:
        raise ValueError(f"grad_accumulation_steps must be >= 1, got {n}")

    def train_step(batch: Batch, timings: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
        device = tx.params[0].device
        tx.zero_grad()
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        if timings is not None:
            timings.update(towers_s=0.0, llm_s=0.0)
            _sync(device)
        for i in range(n):
            t = time.perf_counter()
            loss = loss_fn(micro_batch(batch, i, n) if n > 1 else batch, timings)
            loss.backward()
            loss_sum += loss.detach().float()
            if timings is not None:
                _sync(device)
                timings["llm_s"] += time.perf_counter() - t
        if timings is not None:
            timings["llm_s"] -= timings["towers_s"]
            t = time.perf_counter()
        with torch.no_grad():
            for p in tx.params:
                if p.grad is not None and n > 1:
                    p.grad.div_(n)
        grad_norm = tx.step()
        if timings is not None:
            _sync(device)
            timings["optimizer_s"] = time.perf_counter() - t
        return {"loss": loss_sum / n, "grad_norm": grad_norm, "step": tx.count}

    return train_step
