"""VidLM-level prefix caching, end to end through the port's evaluation
command (counterpart of ``scripts/bench_vidlm_prefix.py``).

Workload: ``eval_data/dummy_openended_scaled``, 4 videos x 8 questions (the
shape of the reference's eval sets, which ask several questions per video),
on merv-full from ``runs/merv-full-randinit`` (written by
:mod:`merv_tpu_torch.cli.make_randinit_run` when missing; random weights:
the same work, no trained numbers needed for a throughput comparison). Each
mode is one ``python -m merv_tpu_torch.cli.eval_openended`` process with
``--serving_passes 2``: the workload is served twice in the process and the
second pass is reported, so the first holds every graph capture.

- ``engine_shared``: ``--use_engine --share_video_prefix``: towers and the
  ``[BOS | visual]`` prefill run once per video; every question admits
  suffix-only against the shared cache;
- ``engine_unshared``: ``--use_engine --share_video_prefix false``: per-answer
  slot retirement, but every question pays the towers and the full prefill;
- ``group``: ``--batch_size 2``, group-synchronous ``generate_batch``.

The arguments are ``merv_tpu``'s, chosen for its single TPU chip: an int8 LLM and
int8 cache, at most 2 registered prefixes beside the engine's slot cache,
and batch 2 for the group path. They are kept as they are, so that the
workload is the same; the card has room for more.

Env: ``BENCH_VP_MAX_NEW`` (32), the decode budget per question;
``BENCH_VP_SLOTS`` (4), the engine's slots. Prints one JSON line: each mode's
serving telemetry (``serving_wall_s``, ``questions_per_sec``, the process's
launches, ``proc_s``), ``shared_vs_unshared`` and ``shared_vs_group``, and
the device.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time
from typing import Optional, Sequence

from merv_tpu_torch import benchkit
from merv_tpu_torch.device import resolve_device

ROOT = benchkit.REPO_ROOT
RUN = "merv-full-randinit"
DATASET = "dummy_openended_scaled"
MODES = {
    "engine_shared": ["--use_engine", "true", "--share_video_prefix", "true", "--engine_slots", "{slots}",
                      "--prefix_budget", "2"],
    "engine_unshared": ["--use_engine", "true", "--share_video_prefix", "false", "--engine_slots", "{slots}"],
    "group": ["--batch_size", "2"],
}


def _run_eval(args: Sequence[str]) -> subprocess.CompletedProcess:
    """The evaluation command in a fresh process, from the repository root."""
    return subprocess.run([sys.executable, "-m", "merv_tpu_torch.cli.eval_openended", *args], capture_output=True,
                          text=True, cwd=ROOT, env=benchkit.child_env())


def run_mode(mode: str, max_new: int, slots: int, device: Optional[str] = None) -> dict:
    """One mode: one evaluation process -> its serving line, with ``proc_s``."""
    result_dir = ROOT / "eval_result" / RUN
    if result_dir.exists():  # stale _done shards would satisfy the resume and skip the work
        shutil.rmtree(result_dir)
    args = ["--model_path", RUN, "--eval_dataset", DATASET, "--allow_random_weights", "true",
            "--quantize_llm", "true", "--int8_kv", "true", "--max_new_tokens", str(max_new), "--skip_flops", "true",
            "--serving_passes", "2"] + [a.format(slots=slots) for a in MODES[mode]]
    if device:
        args += ["--device", device]
    t0 = time.perf_counter()
    proc = _run_eval(args)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        sys.stderr.write((proc.stdout + proc.stderr)[-4000:])
        raise SystemExit(f"mode {mode} failed (rc={proc.returncode})")
    stats = next((d for d in reversed(benchkit.json_lines(proc.stdout)) if "serving_wall_s" in d), None)
    if stats is None:
        sys.stderr.write((proc.stdout + proc.stderr)[-4000:])
        raise SystemExit(f"mode {mode}: no serving-wall JSON line in its output")
    stats["proc_s"] = round(wall, 2)
    return stats


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    max_new = int(os.environ.get("BENCH_VP_MAX_NEW", "32"))
    slots = int(os.environ.get("BENCH_VP_SLOTS", "4"))
    if not (ROOT / "runs" / RUN).exists():
        from merv_tpu_torch.cli.make_randinit_run import write_run_dir

        write_run_dir(ROOT / "runs" / RUN, device=dev)
    out = {"dataset": DATASET, "max_new_tokens": max_new, "slots": slots}
    for mode in MODES:  # one process each, so each starts from a fresh card
        out[mode] = run_mode(mode, max_new, slots, args.device)
    qs = {m: out[m]["questions_per_sec"] for m in MODES}
    out["shared_vs_unshared"] = round(qs["engine_shared"] / qs["engine_unshared"], 3)
    out["shared_vs_group"] = round(qs["engine_shared"] / qs["group"], 3)
    return benchkit.emit(out, dev)


if __name__ == "__main__":
    main()
