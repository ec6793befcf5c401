"""Align-stage training-step benchmark (counterpart of ``scripts/bench_train.py``).

One optimizer step of the align stage: projectors and fusion trainable, the
towers and the LLM frozen, the backward still flowing through the LLM's
activations to reach the spliced visual tokens (K3, ``flash_attention_backward``,
once a layer). Parameters are zeros in bf16 with the trainables in fp32 (the
master weights), as ``merv_tpu``'s bench makes them; remat on. Reports
steps/s and examples/s.

``merv_tpu`` shards the step over a one-axis ``fsdp`` mesh of the local
devices. The port runs its single-device step (``training/train_step.py``,
the path ``training/strategies/fsdp.py`` takes, which differs from the
single-device strategy only in name until the parallel paths are ported).

Env: ``BENCH_LLM_LAYERS`` (8), ``BENCH_BATCH`` (2), ``BENCH_TEXT`` (64).
Prints the launch counts, then one JSON line: ``metric``,
``examples_per_sec``, ``step_sec``, ``loss``, plus ``steps`` (every step run)
and the device.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from merv_tpu_torch import benchkit
from merv_tpu_torch.device import resolve_device
from merv_tpu_torch.models.vidlms import IGNORE_INDEX


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="the card unless 'cpu' (the tiny model)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    from merv_tpu_torch.training.optimizers import build_optimizer, build_schedule
    from merv_tpu_torch.training.train_step import make_loss_fn, make_train_step

    layers = int(os.environ.get("BENCH_LLM_LAYERS", "8"))
    B = int(os.environ.get("BENCH_BATCH", "2"))
    T = int(os.environ.get("BENCH_TEXT", "64"))
    model = benchkit.build_model(layers, tiny=dev.type == "cpu", device=dev)
    model.freeze_backbones("align")
    model.to(torch.bfloat16)
    trainable = model.trainable_mask()
    for name, p in model.named_parameters():  # trainables in fp32 (master weights)
        if trainable[name]:
            p.data = p.data.float()
    benchkit.materialize(model, dev)
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            t.zero_()

    schedule = build_schedule("linear-warmup+cosine-decay", 1e-3, total_steps=1000)
    tx = build_optimizer(dict(model.named_parameters()), schedule, weight_decay=0.0, max_grad_norm=1.0,
                         trainable_mask=trainable)
    step_fn = make_train_step(make_loss_fn(model, remat=True), tx, grad_accumulation_steps=1)

    rng = np.random.RandomState(0)

    def put(x):
        return torch.from_numpy(x).to(dev)

    labels = np.where(np.arange(T)[None] > 0, rng.randint(3, 250, size=(B, T)), IGNORE_INDEX)
    batch = {
        "input_ids": put(rng.randint(3, 250, size=(B, T)).astype(np.int64)),
        "attention_mask": put(np.ones((B, T), np.int64)),
        "labels": put(labels.astype(np.int64)),
        "video_values": [put(rng.randn(B, *vb.default_video_resolution).astype(np.float32))
                         for vb in model.video_backbones],
        "is_multimodal": put(np.ones((B,), bool)),
    }

    loss = float(step_fn(batch)["loss"])  # warm-up step
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = step_fn(batch)
        float(out["loss"])
        times.append(time.perf_counter() - t0)
    dt = min(times)
    return benchkit.emit({
        "metric": f"align-stage train step (llm depth {layers}/32, bsz {B})",
        "examples_per_sec": round(B / dt, 3),
        "step_sec": round(dt, 4),
        "loss": round(loss, 4),
        "steps": 4, "layers": layers, "batch": B,
    }, dev)


if __name__ == "__main__":
    main()
