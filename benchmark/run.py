"""Run one cell of the benchmark once and print its result as the last line of standard output.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration file and its traffic mix are found by name from
``BENCHMARK.json``; the mix names its driver (``benchmark/drivers/<name>.py``)
and each per-layer metric its reader (``benchmark/metrics/<name>.py``). With
``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy time in a profiled
slice of the window and the slice's breakdown. A run needs the card: without
one (or with fewer than the cell asks for) it prints no result and exits 2.
The numbers compared for ``correct`` are printed beside their limits, last on
standard error and last in the result line.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "merv_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cell_entries(bench: dict, workload: str):
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload named {workload!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    layer = [m for m in bench["per_layer"] if "workloads" not in m or workload in m["workloads"]]
    return cell, config, e2e, layer


def result_line(cell, e2e_values: Dict[str, float], e2e: list, layer: list, peak: int) -> Dict[str, Any]:
    """The contract's last line: correct, attempted, failed, metrics, device (and breakdown when traced),
    then the compared numbers with their limits."""
    from benchmark import harness

    metrics: Dict[str, Dict[str, Any]] = {}
    if cell.trace:
        for m in layer:
            value = harness.load_by_path("metrics", m["name"]).read(cell)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            value = cell.obs["setup_s"] if m["name"] == "setup_s" else e2e_values[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in cell.checks.values())
    device = harness.device_fields(cell.device, peak)
    out: Dict[str, Any] = {"correct": correct, "attempted": cell.obs.get("attempted", 0),
                           "failed": cell.obs.get("failed", 0), "metrics": metrics, "device": device}
    prof = cell.obs.get("profile")
    if cell.trace and prof and prof.get("busy_s"):
        device["busy_s"], device["window_s"] = prof["busy_s"], prof["window_s"]
        out["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    out["checks"] = cell.checks
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    harness.cache_dirs()
    import torch

    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    w, c, e2e, layer = cell_entries(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        sys.stderr.write(f"{args.workload} needs {w['chips']} CUDA device(s); "
                         f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}\n")
        raise SystemExit(2)
    cfg = json.loads((harness.ROOT / c["file"]).read_text())
    mix = json.loads((harness.BENCH / "workloads" / f"{w['traffic']}.json").read_text())
    limits = json.loads((harness.BENCH / "limits" / f"{args.workload}.json").read_text())
    cell = harness.Cell(name=args.workload, cfg=cfg, mix=mix, limits=limits, seed=args.seed, seconds=args.seconds,
                        trace=bool(args.trace), device=torch.device("cuda"), t_process=T_PROCESS)
    driver = harness.load_by_path("drivers", mix["driver"])
    values = driver.run(cell)
    out = result_line(cell, values, e2e, layer, cell.obs.get("memory_peak_bytes", 0))
    found = forbidden_modules()
    if found:
        sys.stderr.write(f"modules of JAX or the JAX package are loaded: {found}\n")
        raise SystemExit(3)
    sys.stderr.write("readings " + json.dumps(harness.summary(cell.obs), default=str) + "\n")
    for name, chk in cell.checks.items():
        sys.stderr.write(f"check {name}: {chk['value']!r} (limit {chk['limit']!r})\n")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
