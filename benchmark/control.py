"""The controls of ``correct``: what a lower precision reads on a cell's compared numbers, and the planted
faults a training cell is also held against. Not part of a benchmark run; run on the card at the cell's own
size when a limit is set:

    python3 -m benchmark.control --workload qwen7b.describe --seeds 11 12 13 --seconds 12
    python3 -m benchmark.control --workload qwen3b.align --seeds 11 12 13

- Serving: the program's own lower precision, its int8 path (``quantize_tree`` on the LLM's Linears, K4,
  and an int8 slot cache, K5), serves the cell's traffic for a short window; its served tokens are held
  against the float32 reference as a run's are (``max_gap``).
- Training: the reference put in the program's place and computed in fp8 (every Linear's inputs and
  weights rounded to float8 e4m3 with a per-row scale), held against the float32 reference on the checked
  steps; and the reference with half of each micro-batch left out (the mean over the rest). A state left
  unchanged reads 1 on ``change_gap`` by its definition and needs no run.

One JSON line per seed and control on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Optional


def serve_control(cell, seconds: float) -> Dict[str, Any]:
    from benchmark import harness
    from benchmark.drivers import serve_closed as drv

    b = drv.build(cell, int8=True, compute_dtype=cell.compute_dtype)
    drv.warm_up(b, cell)
    cell.seconds = seconds
    w = drv.window(b, cell)
    done = drv.served(b)
    picked = drv.sample(done, cell.mix["check_requests"], cell.seed)
    pool = b["pool"]
    del b
    harness.free(cell.device)
    harness.strict_fp32()
    return dict(control="int8", **drv.gaps(cell, picked, pool), answers=w["answers"],
                served_checked=sum(len(d["tokens"]) for d in picked))


def train_controls(cell) -> List[Dict[str, Any]]:
    from benchmark import harness
    from benchmark.drivers import train_align as drv
    from benchmark.reference import merv as ref
    from merv_tpu_torch.models.backbones.llm.base_llm import LLM_SPECS

    harness.strict_fp32()
    data = drv.make_batches(cell, LLM_SPECS[cell.cfg["llm_backbone_id"]].pad_token_id)
    n = cell.mix["checked_steps"]
    fp32 = drv.reference_steps(cell, data, n)
    out = []
    fp8 = drv.reference_steps(cell, data, n, P=ref.Precision("fp8"))
    out.append(dict(control="fp8", **{k: v for k, v in drv.compare(fp8, fp32).items() if k != "left_out"}))
    half = cell.cfg["align"]["per_device_batch_size"] // 2
    halved = drv.reference_steps(cell, data, n, keep=lambda i: i < half)
    out.append(dict(control="half_batch", **{k: v for k, v in drv.compare(halved, fp32).items() if k != "left_out"}))
    return out


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    args = ap.parse_args(argv)

    from benchmark import harness, run

    harness.cache_dirs()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("the controls run on the card")
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    w, c, _, _ = run.cell_entries(bench, args.workload)
    cfg = json.loads((harness.ROOT / c["file"]).read_text())
    mix = json.loads((harness.BENCH / "workloads" / f"{w['traffic']}.json").read_text())
    for seed in args.seeds:
        cell = harness.Cell(name=args.workload, cfg=cfg, mix=mix, limits={}, seed=seed, seconds=args.seconds,
                            trace=False, device=torch.device("cuda"), t_process=time.perf_counter())
        rows = [serve_control(cell, args.seconds)] if mix["driver"] == "serve_closed" else train_controls(cell)
        for r in rows:
            print(json.dumps(dict(workload=args.workload, seed=seed, **r)), flush=True)
        harness.free(cell.device)
    sys.stderr.write(f"forbidden modules loaded: {run.forbidden_modules()}\n")


if __name__ == "__main__":
    main()
