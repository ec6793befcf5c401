"""The port's span recorder (merv_tpu_torch.tracing) on tiny models on the CPU.

Off, a tiny engine run and a two-micro-step train step record nothing and
construct no CUDA event, and ``span()`` reads no clock and hands back one
shared object. On, the engine's spans form the tree ``PERF.md`` §3 names, keyed
by request id, and the train step's micro-steps hold their four spans.
``timings=`` keeps its keys. Under a CPU ``torch.profiler``, a span around a
matmul contains the profiler's ``aten::mm`` after ``chrome_events``' mapping,
and ``MERV_TPU_PROFILE`` writes a trace that holds the steps' spans.
"""

import json

import numpy as np
import pytest
import torch

import merv_tpu_torch.tracing as tracing
from merv_tpu_torch.device import make_generator
from merv_tpu_torch.models.backbones.llm.base_llm import tiny_llm_backbone
from merv_tpu_torch.models.backbones.video import DinoV2VideoBackbone, SiglipVideoBackbone
from merv_tpu_torch.models.backbones.video.vit import tiny_vit_config
from merv_tpu_torch.models.generation import GenerationConfig
from merv_tpu_torch.models.vidlms import MERV
from merv_tpu_torch.nn.core import init_weights
from merv_tpu_torch.serving import ContinuousBatchingEngine, Request
from merv_tpu_torch.training import Metrics, get_train_strategy
from merv_tpu_torch.training.optimizers import build_optimizer, build_schedule
from merv_tpu_torch.training.train_step import make_loss_fn, make_train_step
from merv_tpu_torch.util.data_utils import PaddedCollatorForLanguageModeling

CPU = torch.device("cpu")
LLM = dict(vocab_size=320, hidden_size=64, intermediate_size=64, num_heads=2, num_kv_heads=1, head_dim=32)
ENGINE_NAMES = {"engine.admit", "admit.request", "towers", "project_fuse", "admit.prefill", "admit.place",
                "engine.chunk", "chunk.replay", "chunk.readback", "chunk.bookkeeping", "prefetch.prepare",
                "admit.prefetch_wait", "request.submit", "request.first_token", "request.finish"}
MICRO_CHILDREN = {"train.frames", "towers", "train.forward", "train.backward"}


def _merv(seed=3):
    towers = [
        DinoV2VideoBackbone("dinov2-video-all-tokens", "resize-naive", default_image_size=32, num_frames=4,
                            vit_config=tiny_vit_config(num_cls_tokens=1, num_register_tokens=4, use_layerscale=True),
                            device=CPU),
        SiglipVideoBackbone("siglip-vit-b16-224px-all-no-cls", "resize-naive", default_image_size=32, num_frames=4,
                            vit_config=tiny_vit_config(num_cls_tokens=0, pos_embed_includes_prefix=False,
                                                       act="gelu_tanh"), device=CPU),
    ]
    m = MERV("tiny-merv", towers, tiny_llm_backbone(compute_dtype=torch.float32, device=CPU, **LLM), device=CPU,
             arch_specifier="no-align+3davg+linear", feature_fusion="cross_attention_avg_lq",
             projector_token_length=4, visual_feature_length=16, text_embedding_dim=32)
    init_weights(m, make_generator(CPU, seed))
    return m


@pytest.fixture(scope="module")
def merv():
    return _merv().eval()


@pytest.fixture(autouse=True)
def _recorder_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _serve(m, n=3, slots=2):
    rng = np.random.RandomState(0)
    engine = ContinuousBatchingEngine.for_vidlm(
        m, slots=slots, max_len=96, steps_per_sync=4, length_bucket=16,
        config=GenerationConfig(max_new_tokens=6, eos_token_id=-1, pad_token_id=m.llm_backbone.pad_token_id))
    reqs = [Request(f"q{i}", prompt_text=f"In: what happens {i}?\nOut: ",
                    video=rng.randint(0, 256, size=(8, 40, 48, 3)).astype(np.uint8), max_new_tokens=4 + i)
            for i in range(n)]
    return engine, engine.run(reqs)


def _train_step(m, timings=None):
    m.train()
    m.freeze_backbones("align")
    transforms = [vb.get_video_transform() for vb in m.video_backbones]
    named = dict(m.named_parameters())
    tx = build_optimizer(named, build_schedule("constant", 1e-3, 10), 0.0, 1.0, m.trainable_mask())
    step = make_train_step(make_loss_fn(m, remat=True, video_transforms=transforms, loss_chunk_size=8), tx, 2)
    rng = np.random.RandomState(1)
    ids = torch.as_tensor(rng.randint(3, 250, size=(4, 10))).long()
    labels = ids.clone()
    labels[:, 0] = -100
    batch = dict(input_ids=ids, attention_mask=torch.ones_like(ids), labels=labels,
                 is_multimodal=torch.ones(4, dtype=torch.bool),
                 video_values=[torch.as_tensor(rng.randint(0, 256, size=(4, vb.num_frames, tf.target_size,
                                                                         tf.target_size, 3)).astype(np.uint8))
                               for vb, tf in zip(m.video_backbones, transforms)])
    out = step(batch, timings)
    m.eval()
    return out


def _ancestors(s, by_id):
    out = []
    while s.parent is not None:
        s = by_id[s.parent]
        out.append(s.name)
    return out


def test_off_records_nothing_and_makes_no_event(monkeypatch, merv):
    """Off: the engine and a two-micro-step train step record no span and construct no CUDA event; span()
    returns the one shared no-op context and reads no clock."""

    def no_event(*a, **k):
        raise AssertionError("a CUDA event was constructed with tracing off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    monkeypatch.setattr(tracing.torch.cuda, "Event", no_event)
    engine, results = _serve(merv)
    assert len(results) == 3
    _train_step(_merv(seed=4))
    assert tracing.drain() == []

    def no_clock():
        raise AssertionError("a clock was read with tracing off")

    clocks = (tracing.time.perf_counter_ns, tracing.time.perf_counter, tracing.time.time_ns)
    try:
        tracing.time.perf_counter_ns = tracing.time.perf_counter = tracing.time.time_ns = no_clock
        a, b = tracing.span("x"), tracing.span("y", device=True, request="r")
        with a:
            tracing.event("request.submit", request="r")
    finally:
        tracing.time.perf_counter_ns, tracing.time.perf_counter, tracing.time.time_ns = clocks
    assert a is b
    assert tracing.drain() == []


def test_engine_spans_form_the_tree(merv):
    """3 requests at 2 slots: each request's towers and prefill sit under an engine.admit with its id, as do
    its submit, first-token and finish instants; the chunk's three parts sit under engine.chunk."""
    tracing.enable()
    engine, results = _serve(merv)
    tracing.disable()
    spans = tracing.drain()
    assert tracing.dropped() == 0
    names = {s.name for s in spans}
    assert ENGINE_NAMES <= names, ENGINE_NAMES - names
    by_id = {s.id: s for s in spans}
    for rid in results:
        for name in ("towers", "admit.prefill", "admit.place"):
            mine = [s for s in spans if s.name == name and s.request == rid]
            assert len(mine) == 1, (rid, name)
            assert "engine.admit" in _ancestors(mine[0], by_id)
            assert mine[0].end_ns >= mine[0].start_ns
        for name in ("towers", "admit.prefill"):  # device spans: on the CPU, the host's time
            (s,) = [s for s in spans if s.name == name and s.request == rid]
            assert s.device_ms == pytest.approx(s.host_ms)
        for name in ("request.submit", "request.first_token", "request.finish"):
            assert sum(s.name == name and s.request == rid and s.instant for s in spans) == 1, (rid, name)
    for s in spans:
        if s.name.startswith("chunk."):
            assert _ancestors(s, by_id) == ["engine.chunk"]
        if s.name in ("engine.admit", "engine.chunk"):
            assert s.parent is None
    # the third request's host preparation ran on the prefetch thread while a chunk ran
    (pre,) = [s for s in spans if s.name == "prefetch.prepare"]
    admit = next(s for s in spans if s.name == "engine.admit")
    assert pre.request == "q2" and pre.parent is None and pre.thread != admit.thread
    assert set(engine.stats.ttft_s) == set(results) and all(v > 0 for v in engine.stats.ttft_s.values())


def test_train_step_spans():
    """A step of 2 micro-steps: train.step over 2 train.micro (indices 0 and 1), each holding train.frames,
    towers, train.forward and train.backward, then train.optimizer."""
    tracing.enable()
    _train_step(_merv(seed=5))
    tracing.disable()
    spans = tracing.drain()
    by_id = {s.id: s for s in spans}
    (step,) = [s for s in spans if s.name == "train.step"]
    micro = [s for s in spans if s.name == "train.micro"]
    assert sorted(s.index for s in micro) == [0, 1] and all(s.parent == step.id for s in micro)
    for m in micro:
        kids = [s for s in spans if s.parent == m.id]
        assert sorted(s.name for s in kids) == sorted(MICRO_CHILDREN)
        assert all(s.device_ms is not None and s.device_ms >= 0 for s in kids)
    (opt,) = [s for s in spans if s.name == "train.optimizer"]
    assert opt.parent == step.id and _ancestors(opt, by_id) == ["train.step"]


def test_timings_keep_their_keys(merv):
    """``timings=`` through the spans: the train step's and MERV.generate's keys, each a positive time
    (``run_training``'s ``step_s``: the exporter's test below)."""
    t = {}
    _train_step(_merv(seed=6), t)
    assert {"towers_s", "llm_s", "optimizer_s"} <= set(t) and all(t[k] > 0 for k in t)
    g = {}
    video = np.random.RandomState(2).randint(0, 256, size=(8, 40, 48, 3)).astype(np.uint8)
    merv.generate(video, "In: what is it?\nOut: ", max_new_tokens=4, timings=g)
    assert {"prepare_s", "towers_s", "project_fuse_s", "prefill_s", "decode_s", "decode_steps",
            "decode_capture_s"} <= set(g)
    assert all(g[k] > 0 for k in ("prepare_s", "towers_s", "project_fuse_s", "prefill_s", "decode_s"))
    assert tracing.drain() == []  # timings alone record no span


def test_spans_lie_on_the_profilers_clock():
    """Under a CPU torch.profiler, which turns recording on, a span around torch.mm contains the profiler's
    aten::mm event once mapped through the trace's baseTimeNanoseconds."""
    from torch.profiler import ProfilerActivity, profile

    a, b = torch.randn(256, 256), torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.recording()
        with tracing.span("matmul"):
            torch.mm(a, b)
    assert not tracing.recording()
    (s,) = tracing.drain()
    path = pytest.importorskip("tempfile").mktemp(suffix=".json")
    prof.export_chrome_trace(path)
    trace = json.loads(open(path).read())
    base = int(trace.get("baseTimeNanoseconds", 0))
    (mine,) = tracing.chrome_events([s], base)
    mm = [e for e in trace["traceEvents"] if e.get("name") == "aten::mm" and e.get("ph") == "X"]
    assert mm
    for e in mm:
        assert mine["ts"] <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= mine["ts"] + mine["dur"]


def test_buffer_drops_the_oldest_and_requests_pass_down():
    """A full buffer drops its oldest spans and counts them; a span given no request takes its parent's;
    chrome_events gives X and i events on one track a thread."""
    tracing.enable(capacity=3)
    with tracing.span("outer", request=("a", "b")):
        with tracing.span("inner"):
            pass
        tracing.event("mark")
    for i in range(3):
        with tracing.span("late", index=i):
            pass
    spans = tracing.drain()
    assert tracing.dropped() == 3 and [s.name for s in spans] == ["late"] * 3
    with tracing.span("outer", request=("a", "b")):
        with tracing.span("inner"):
            pass
        tracing.event("mark")
    spans = tracing.drain()
    inner, mark, outer = sorted(spans, key=lambda s: s.name)
    assert inner.request == mark.request == ("a", "b") and inner.parent == outer.id and mark.instant
    ev = tracing.chrome_events(spans, base_ns=outer.start_ns)
    assert {e["ph"] for e in ev} == {"X", "i"} and len({e["tid"] for e in ev}) == 1
    assert next(e for e in ev if e["name"] == "outer")["ts"] == 0.0
    assert next(e for e in ev if e["name"] == "inner")["args"]["request"] == ["a", "b"]


class _Captions:
    def __init__(self, n, resolutions, tokenizer):
        rng = np.random.RandomState(0)
        self.items = []
        for _ in range(n):
            ids = np.asarray(tokenizer("a red ball moves left" + tokenizer.eos_token).input_ids, np.int32)
            labels = ids.copy()
            labels[0] = -100
            self.items.append(dict(video_values=[rng.randint(0, 256, size=r).astype(np.uint8) for r in resolutions],
                                   input_ids=ids, labels=labels, is_image=False))

    def __getitem__(self, i):
        return self.items[i]

    def __len__(self):
        return len(self.items)


def test_operator_profile_holds_the_step_spans(tmp_path, monkeypatch):
    """MERV_TPU_PROFILE=<dir>: run_training profiles steps 4-5 of a 5-step run into one Chrome trace that
    holds the profiler's events and two train.step spans; every step's timings hold step_s, the loop's
    call, at least the step's own parts."""
    m = _merv(seed=7)
    m.freeze_backbones("align")
    transforms = [vb.get_video_transform() for vb in m.video_backbones]
    res = [(vb.num_frames, tf.target_size, tf.target_size, 3) for vb, tf in zip(m.video_backbones, transforms)]
    ds = _Captions(10, res, m.llm_backbone.tokenizer)
    strategy = get_train_strategy("fsdp-shard-grad-op", m, stage="align", epochs=1, max_steps=5,
                                  global_batch_size=2, per_device_batch_size=2, learning_rate=1e-3,
                                  weight_decay=0.0, max_grad_norm=1.0, loss_chunk_size=8)
    strategy.run_setup(tmp_path, n_train_examples=len(ds), video_transforms=transforms, seed=0)
    metrics = Metrics(("jsonl",), "run", tmp_path, {"lr": 1e-3}, "align", grad_accumulation_steps=1, total_steps=5)
    monkeypatch.setenv("MERV_TPU_PROFILE", str(tmp_path / "profile"))
    timings = []
    strategy.run_training(ds, PaddedCollatorForLanguageModeling(24, m.llm_backbone.pad_token_id, res), metrics,
                          stage="align", seed=0, num_workers=0, step_timings=timings)
    metrics.finalize()
    assert len(timings) == 5
    assert all(t["step_s"] >= t["towers_s"] + t["llm_s"] + t["optimizer_s"] > 0 for t in timings)
    trace = json.loads((tmp_path / "profile" / "train_steps.json").read_text())
    ev = trace["traceEvents"]
    steps = [e for e in ev if e.get("name") == "train.step" and e.get("cat") == "program"]
    assert len(steps) == 2
    assert sum(e.get("name") == "train.batch" for e in ev) == 2
    assert any(e.get("name") == "aten::mm" for e in ev)
    assert not tracing.recording()
