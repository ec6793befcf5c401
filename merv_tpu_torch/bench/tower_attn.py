"""Tower attention implementations, whole towers timed under each
(counterpart of ``scripts/bench_tower_attn.py``).

The towers that have a choice of attention route (LanguageBind and DINOv2 of
the ``merv`` set) timed whole at the bench shapes, so that what a kernel
changes around itself is counted too. Each implementation is one switch of
the towers' routes, as ``ViTLayer`` reads them:

- ``small``: ``MERV_TPU_TOWER_ATTN=small``, K1 (``small_attention_kt``) on
  the kt layout;
- ``xla_kt``: ``MERV_TPU_TOWER_ATTN=xla_kt``, the same layout through plain
  PyTorch (no kernel);
- ``xla``: ``MERV_TPU_TOWER_ATTN=xla``, plain projections and
  ``attention()``'s small plan, B3 (``small_attention``);
- ``fused_block``: ``MERV_TPU_FUSED_VIT_BLOCK=1``, B6
  (``fused_vit_attn_block``) for LayerNorm, q/k/v, attention, o-projection,
  LayerScale and the residual;
- ``default``: no switch (K1 at these towers).

Each runs in a fresh subprocess (``--one`` with ``TOWER_ATTN_IMPL``), so one
implementation's memory and state cannot reach the next. Each tower is
timed by CUDA events over repeated calls on the card, by the host clock on
the CPU.

Usage: ``python -m merv_tpu_torch.bench.tower_attn [--batch 2]
[--impls small,xla_kt,xla] [--device cpu]``. Prints one JSON line
``{"batch", "rows": [{"impl", "languagebind_ms", "dinov2_ms", "calls",
"launches"}, ...]}`` and the device.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from merv_tpu_torch import benchkit
from merv_tpu_torch.device import resolve_device

# the merv set's towers with a choice of attention route (ViViT's and SigLIP's dispatch elsewhere)
TOWERS = {0: "languagebind", 1: "dinov2"}
ITERS = 8


@torch.inference_mode()
def run_one(batch: int, dev: torch.device) -> dict:
    impl = os.environ.get("TOWER_ATTN_IMPL", "small")
    if impl == "fused_block":
        os.environ["MERV_TPU_FUSED_VIT_BLOCK"] = "1"
    elif impl != "default":
        os.environ["MERV_TPU_TOWER_ATTN"] = impl
    model = benchkit.make_bench_params(benchkit.build_model(2, tiny=dev.type == "cpu", device=dev))
    out = {"impl": impl, "calls": 0}
    for i, name in TOWERS.items():
        vb = model.video_backbones[i]
        video = torch.from_numpy(np.random.RandomState(i).randn(batch, *vb.default_video_resolution)
                                 .astype(np.float32)).to(dev, torch.bfloat16)

        def call(vb=vb, video=video):
            out["calls"] += 1
            return vb(video)

        out[name + "_ms"] = round(benchkit.stage_ms(call, dev, ITERS), 3)
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--one", action="store_true", help="one implementation (TOWER_ATTN_IMPL) in this process")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--impls", default="small,xla_kt,xla")
    ap.add_argument("--device", default=None, help="the card unless 'cpu' (the tiny model)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.one:
        return benchkit.emit(run_one(args.batch, dev), dev)

    rows = []
    for impl in args.impls.split(","):
        env = dict(os.environ, TOWER_ATTN_IMPL=impl)
        row, launches, _ = benchkit.run_child(
            ["merv_tpu_torch.bench.tower_attn", "--one", "--batch", str(args.batch)]
            + (["--device", args.device] if args.device else []), env=env)
        row.update(launches=launches)
        rows.append({k: v for k, v in row.items() if k not in ("device", "device_count", "nvidia_smi")})
    return benchkit.emit({"batch": args.batch, "rows": rows}, dev)


if __name__ == "__main__":
    main()
