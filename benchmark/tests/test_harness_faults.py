"""A run of each cell at the tiny size on the CPU, past the look for a card, with the timed path broken
underneath: ``correct`` comes out false for every fault the cell can have, and true for the sound program
(computing in float32 here, so the cell's tiny limits sit far above its rounding and far below a fault).

- serving: a served token altered where the engine hands the answer over;
- training: a step that leaves the state unchanged (the optimizer applies no update); half of each
  micro-batch left out, the mean taken over the rest.
One card and no collective: the exchange between chips has nothing to leave out."""

import json

import numpy as np
import pytest
import torch

from benchmark import harness, run
from benchmark.tests import tiny


def result(kind: str):
    cell = tiny.cell(kind, seconds=1.0)
    cell.compute_dtype = torch.float32
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    _, _, e2e, layer = run.cell_entries(bench, "qwen7b.describe" if kind == "serve" else "qwen3b.align")
    values = harness.load_by_path("drivers", cell.mix["driver"]).run(cell)
    return run.result_line(cell, values, e2e, layer, 0)


def altered_token(monkeypatch):
    from merv_tpu_torch.serving.engine import ContinuousBatchingEngine

    finish = ContinuousBatchingEngine._finish

    def wrong(self, req, emitted, reason):
        emitted = list(emitted)
        emitted[len(emitted) // 2] = (int(emitted[len(emitted) // 2]) + 1) % 151936
        return finish(self, req, emitted, reason)

    monkeypatch.setattr(ContinuousBatchingEngine, "_finish", wrong)


def state_unchanged(monkeypatch):
    from merv_tpu_torch.training.optimizers import ClippedAdamW

    monkeypatch.setattr(ClippedAdamW, "step", lambda self: self.global_norm())


def half_batch(monkeypatch):
    import merv_tpu_torch.training.train_step as ts

    whole = ts.micro_batch
    # each micro-batch's first half: the loss is then the mean over those rows alone
    monkeypatch.setattr(ts, "micro_batch", lambda batch, i, n: whole(whole(batch, i, n), 0, 2))


@pytest.mark.parametrize("kind,fault", [("serve", None), ("serve", altered_token), ("train", None),
                                        ("train", state_unchanged), ("train", half_batch)],
                         ids=["serve-sound", "serve-altered-token", "train-sound", "train-state-unchanged",
                              "train-half-batch"])
def test_correct_catches_the_fault(monkeypatch, kind, fault):
    if fault is not None:
        fault(monkeypatch)
    out = result(kind)
    assert out["correct"] is (fault is None), out["checks"]
    assert list(out)[-1] == "checks" and all(np.isfinite(c["value"]) for c in out["checks"].values())
