"""The per-layer metrics read from the program's own spans, on tiny traced runs of each driver on the CPU.

A traced run records the program's spans while its slice's profiler runs; each new reader then reads a
finite number, and ``benchmark.idle_split`` adds the slice's ``idle_by_span`` to the readings. A run
whose program has no span recorder (the parent commit's case) or no spans reads None from every one of
them, and the result line leaves them out."""

import json
import sys

import numpy as np
import pytest
import torch

from benchmark import harness, idle_split, run, spans
from benchmark.tests import tiny

NEW = {"qwen7b.describe": ["admit_prep_ms.serve", "engine_towers_ms.serve", "engine_prefill_ms.serve"],
       "qwen3b.align": ["step_towers_ms.train", "step_forward_ms.train", "step_backward_ms.train"]}


def traced(kind: str, monkeypatch):
    monkeypatch.setattr(harness, "ProfileSlice", idle_split.SplitSlice)
    monkeypatch.setattr(run, "result_line", idle_split.result_line)
    cell = tiny.cell(kind, seconds=3.0, trace=True)  # the CPU profiler slows a tiny traced run several times
    cell.compute_dtype = torch.float32
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    _, _, e2e, layer = run.cell_entries(bench, "qwen7b.describe" if kind == "serve" else "qwen3b.align")
    values = harness.load_by_path("drivers", cell.mix["driver"]).run(cell)
    return cell, run.result_line(cell, values, e2e, layer, 0)


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_traced_run_reads_every_span_metric(monkeypatch, kind):
    cell, out = traced(kind, monkeypatch)
    names = NEW["qwen7b.describe" if kind == "serve" else "qwen3b.align"]
    for name in names:
        assert name in out["metrics"], (name, sorted(out["metrics"]))
        assert np.isfinite(out["metrics"][name]["value"]) and out["metrics"][name]["value"] >= 0
    prof = cell.obs["profile"]
    assert isinstance(prof["idle_by_span"], dict)
    assert "idle_by_span" in json.dumps(harness.summary(cell.obs), default=str)
    got = spans.program_spans(cell)
    assert got and all(s.name for s in got)
    if kind == "train":  # the towers split equals the spans' own per-micro-step sum
        micro = [s for s in got if s.name == "train.micro"]
        assert micro and all(s.device_ms is not None for s in micro)


def test_readers_return_none_without_spans(monkeypatch):
    cell = tiny.cell("serve", trace=True)
    cell._program_spans = []
    for name in NEW["qwen7b.describe"] + NEW["qwen3b.align"]:
        assert harness.load_by_path("metrics", name).read(cell) is None, name
    # a program without the recorder: the import fails, the readers read nothing and do not raise
    monkeypatch.setitem(sys.modules, "merv_tpu_torch.tracing", None)
    cell = tiny.cell("train", trace=True)
    assert spans.program_spans(cell) == []
    for name in NEW["qwen3b.align"] + NEW["qwen7b.describe"]:
        assert harness.load_by_path("metrics", name).read(cell) is None, name


def test_split_lays_spans_on_the_trace():
    """Idle gaps fall to the innermost main-thread span at their middle; graph launches inside a
    chunk.replay span are counted to the clock's slack."""
    from merv_tpu_torch.tracing import Span

    base = 1_000_000_000
    us = 1000  # ns
    s = [Span("engine.chunk", 1, None, 7, None, base, base + 100 * us),
         Span("chunk.replay", 2, 1, 7, None, base + 10 * us, base + 20 * us),
         Span("engine.admit", 3, None, 7, None, base + 100 * us, base + 300 * us),
         Span("towers", 4, 3, 7, "r0", base + 150 * us, base + 250 * us)]
    doc = {"baseTimeNanoseconds": base, "traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 40},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 60, "dur": 140},  # gap 40-60: engine.chunk
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 260, "dur": 10},  # gap 200-260: towers
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 400, "dur": 10},  # gap 270-400 (mid 335): none
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 12, "dur": 5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 500, "dur": 5}]}
    out = spans.split(doc, s)
    assert out["idle_by_span"] == pytest.approx({"engine.chunk": 20e-6, "towers": 60e-6, "none": 130e-6})
    assert out["idle_admit_share"] == pytest.approx(60 / 210)
    assert out["graph_launches"] == {"total": 2, "in_chunk_replay": 1}


def test_split_without_spans_puts_all_idle_under_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "merv_tpu_torch.tracing", None)
    doc = {"traceEvents": [{"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 10},
                           {"ph": "X", "cat": "kernel", "name": "k", "ts": 30, "dur": 10}]}
    out = spans.split(doc, [])
    assert out["idle_by_span"] == pytest.approx({"none": 20e-6}) and out["idle_admit_share"] == 0.0
