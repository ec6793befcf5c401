"""The controls of ``correct`` (``benchmark/control.py``) at the tiny size on the CPU: each reads above its
cell's limit, so a lower precision than the configuration states comes out not correct. On the card the same
functions run at the cells' own sizes (``python3 -m benchmark.control``; the ``cuda`` test below runs one
seed of each)."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import control, harness
from benchmark.drivers import serve_closed
from benchmark.tests import tiny


def served_gaps(int8: bool, n: int = 12):
    """The first n requests of the tiny serving traffic, served by the float32 program or by its int8 path
    (the control), all their tokens held against the reference."""
    cell = tiny.cell("serve")
    cell.compute_dtype = torch.float32
    b = serve_closed.build(cell, int8=int8, compute_dtype=torch.float32)
    reqs = [b["traffic"].request(i) for i in range(n)]
    b["engine"].run([b["Request"](f"r{r.index}", prompt_text=r.prompt, video=b["pool"][r.video],
                                  max_new_tokens=r.budget) for r in reqs])
    done = serve_closed.served(b)
    return cell, serve_closed.gaps(cell, done, b["pool"])


def test_the_int8_serving_control_fails_the_limit():
    cell, sound = served_gaps(int8=False)
    _, control = served_gaps(int8=True)
    assert sound["max_gap"] <= cell.limits["max_gap"] < control["max_gap"], (sound, control)
    assert control["off_best"] > 0 == sound["off_best"]


def test_the_fp8_and_half_batch_training_controls_fail_the_limits():
    cell = tiny.cell("train")
    for row in control.train_controls(cell):
        assert any(row[k] > cell.limits[k] for k in ("loss_gap", "grad_gap", "change_gap")), row


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["qwen7b.describe", "qwen3b.align"])
def test_the_controls_fail_the_cells_limits_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("the cells run on a CUDA device")
    proc = subprocess.run([sys.executable, "-m", "benchmark.control", "--workload", workload, "--seeds", "5"],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lim = json.loads((harness.BENCH / "limits" / f"{workload}.json").read_text())
    rows = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    assert rows and all(any(r[k] > v for k, v in lim.items() if k in r) for r in rows), rows
