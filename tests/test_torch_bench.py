"""The port's bench modules (merv_tpu_torch.benchkit, merv_tpu_torch.bench.*)
against merv_tpu's (merv_tpu/benchkit.py, scripts/bench_*.py), on the CPU.

- ``build_model(tiny=True)``: the same towers, projectors and fusion as
  merv_tpu's; with merv_tpu's tiny parameters carried over by
  merv_tpu_torch.bridge, the same prefill logits within 1e-4 (absolute and
  relative, fp32, as tests/test_crossstack_parity.py holds logits);
- ``make_bench_params``: the leaf names, shapes and dtypes of merv_tpu's
  ``jax.eval_shape`` of its ``make_bench_params``, plain, packed and int8
  (one dtype differs by design: the port keeps its int8 scales in fp32);
- each bench's ``main`` at ``--device cpu`` prints its launch counts and one
  JSON line with the keys of the merv_tpu script, cited by line (the JAX
  scripts are not run);
- the unroll knobs raise.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import merv_tpu.benchkit as jax_benchkit
import merv_tpu.models.backbones.llm.base_llm as jax_base_llm
import merv_tpu_torch.models.backbones.llm.base_llm as port_base_llm
from merv_tpu_torch import benchkit
from merv_tpu_torch.bench import breakdown, decode, loader, serving, tower_attn, tower_ops, train
from merv_tpu_torch.bridge import state_dict_from_jax
from merv_tpu_torch.models.generation import prefill

CPU = ["--device", "cpu"]
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One CPU thread for these tiny models, in this process and the benches' child processes: the suite runs
    several test processes at once, and torch's thread pools, each sized to every core, then fight for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize_layerscale(tree, rng):
    """LayerScale inits at 1e-5, which would hide the tower layers from the comparison."""
    if isinstance(tree, dict):
        return {k: (rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32) if k == "gamma"
                    else _randomize_layerscale(v, rng)) for k, v in tree.items()}
    return tree


@pytest.fixture
def fp32_tiny_llm(monkeypatch):
    """Both packages' bench tiny LLM computing in fp32 (its default is bf16)."""
    monkeypatch.setattr(jax_base_llm, "tiny_llm_backbone",
                        functools.partial(jax_base_llm.tiny_llm_backbone, compute_dtype=jnp.float32))
    monkeypatch.setattr(port_base_llm, "tiny_llm_backbone",
                        functools.partial(port_base_llm.tiny_llm_backbone, compute_dtype=torch.float32))


def test_tiny_bench_model_matches_merv_tpu(fp32_tiny_llm):
    jm = jax_benchkit.build_model(2, tiny=True)
    pm = benchkit.build_model(2, tiny=True, device="cpu")
    assert pm.bench_device == torch.device("cpu")
    assert (pm.model_id, pm.arch_specifier, pm.feature_fusion_type) == (jm.model_id, jm.arch_specifier,
                                                                         jm.feature_fusion_type)
    assert [vb.identifier for vb in pm.video_backbones] == [vb.identifier for vb in jm.video_backbones]
    assert [vb.default_video_resolution for vb in pm.video_backbones] == [
        tuple(vb.default_video_resolution) for vb in jm.video_backbones]
    assert [type(p).__name__ for p in pm.projectors] == [type(p).__name__ for p in jm.projectors]
    assert type(pm.feature_fusion).__name__ == type(jm.feature_fusion).__name__
    assert (pm.projector_token_length, pm.visual_feature_length) == (jm.projector_token_length,
                                                                    jm.visual_feature_length)

    params = _randomize_layerscale(_np_tree(jm.init(jax.random.PRNGKey(3))), np.random.RandomState(3))
    benchkit.materialize(pm, torch.device("cpu"))
    pm.load_state_dict(state_dict_from_jax(params), strict=True)

    rng = np.random.RandomState(4)
    B, T = 2, 12
    ids = rng.randint(3, 250, size=(B, T))
    ids[:, 0] = 1
    mask = np.ones((B, T), np.int64)
    mask[1, 9:] = 0
    videos = [rng.randn(B, *vb.default_video_resolution).astype(np.float32) for vb in pm.video_backbones]

    feats = jm.encode_videos(params, [jnp.asarray(v) for v in videos])
    visual, _ = jm.project_and_fuse(params, feats)
    embeds, jmask, _ = jm.embed_multimodal(params, jnp.asarray(ids), jnp.asarray(mask), visual)
    last = jnp.sum(jmask, axis=1).astype(jnp.int32) - 1
    want, _ = jm.llm_backbone.decoder(params["llm_backbone"], inputs_embeds=embeds,
                                      attention_mask=jmask.astype(jnp.int32), logits_indices=last)
    with torch.inference_mode():
        pe, pmask = pm.build_inputs_embeds(torch.from_numpy(ids), torch.from_numpy(mask),
                                           [torch.from_numpy(v) for v in videos])
        got, _, _ = prefill(pm.llm_backbone.decoder, pe, pmask.long(), pe.shape[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32)[:, 0], **TOL)


def _jax_bench_tree(int8):
    jm = jax_benchkit.build_model(2, tiny=True)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    out = jax.eval_shape(lambda: jax_benchkit.make_bench_params(shapes, int8=int8))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), out)
    return {k: (tuple(t.shape), t.dtype) for k, t in state_dict_from_jax(zeros).items()}


@pytest.mark.parametrize("layout", ["plain", "packed", "int8"])
def test_bench_params_have_merv_tpus_leaves(layout, monkeypatch):
    monkeypatch.setenv("BENCH_PACK", "0" if layout == "plain" else "1")
    want = _jax_bench_tree(layout == "int8")
    model = benchkit.make_bench_params(benchkit.build_model(2, tiny=True, device="cpu"), int8=layout == "int8")
    got = {k: (tuple(t.shape), t.dtype) for k, t in model.state_dict().items()}
    assert sorted(got) == sorted(want)
    for name, (shape, dtype) in want.items():
        # merv_tpu's bench draws every float leaf in bf16, its int8 scales too; the port keeps them fp32
        if name.endswith(".scale") and name.replace(".scale", ".weight_q") in want:
            dtype = torch.float32
        assert got[name] == (shape, dtype), name
    packed = any("qkv_proj" in k for k in got)
    assert packed == (layout != "plain")
    floats = [t for t in model.state_dict().values() if t.is_floating_point() and t.dtype == torch.bfloat16]
    assert all(torch.isfinite(t.float()).all() for t in floats)
    w = torch.cat([t.float().flatten() for t in floats])
    assert abs(w.std().item() - 0.02) < 2e-3  # N(0, 0.02)
    ints = [t for t in model.state_dict().values() if t.dtype == torch.int8]
    assert bool(ints) == (layout == "int8")
    assert all(int(t.min()) >= -127 and int(t.max()) <= 126 for t in ints)


def test_bench_params_are_seeded():
    a = benchkit.make_bench_params(benchkit.build_model(2, tiny=True, device="cpu"), seed=1)
    b = benchkit.make_bench_params(benchkit.build_model(2, tiny=True, device="cpu"), seed=1)
    c = benchkit.make_bench_params(benchkit.build_model(2, tiny=True, device="cpu"), seed=2)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)


@pytest.mark.parametrize("knob", benchkit.UNROLL_KNOBS)
@pytest.mark.parametrize("value", ["2", "1,2,1,1"])
def test_unroll_knobs_raise(knob, value, monkeypatch):
    monkeypatch.setenv(knob, value)
    with pytest.raises(ValueError, match="unroll"):
        benchkit.build_model(2, tiny=True, device="cpu")


def test_unroll_knob_at_one_is_accepted(monkeypatch):
    for knob in benchkit.UNROLL_KNOBS:
        monkeypatch.setenv(knob, "1")
    benchkit.build_model(2, tiny=True, device="cpu")


def test_full_width_bench_model_costs_no_memory(monkeypatch):
    """The bench zoo is built on meta: merv-full's towers and a 2-layer Llama-2-7B, for every BENCH_TOWERS set."""
    for towers, n in (("merv", 4), ("dinov2", 1), ("siglip+dinov2", 2)):
        monkeypatch.setenv("BENCH_TOWERS", towers)
        m = benchkit.build_model(2, device="cpu")
        assert len(m.video_backbones) == n and all(p.is_meta for p in m.parameters())
        assert m.llm_backbone.decoder.cfg.num_layers == 2 and m.visual_feature_length == 1024


def _lines(capsys):
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert set(lines[-2]) == {"launches"}, lines
    assert lines[-1]["device"] == "cpu"
    return lines[-1]


# scripts/bench_decode.py:109-117
DECODE_KEYS = {"metric", "decode_tokens_per_sec", "ttft_p50_sec", "unit"}


@pytest.mark.parametrize("int8", [False, True])
def test_decode_main(int8, capsys, monkeypatch):
    monkeypatch.setenv("BENCH_DECODE_STEPS", "6")
    monkeypatch.setenv("BENCH_INT8", "1" if int8 else "0")
    monkeypatch.setenv("BENCH_INT8_KV", "1" if int8 else "0")
    decode.main(CPU)
    out = _lines(capsys)
    assert DECODE_KEYS <= set(out)
    assert out["decode_tokens_per_sec"] > 0 and out["ttft_p50_sec"] > 0
    assert out["metric"].endswith(", int8 weights, int8 kv)" if int8 else "bsz 1)")
    assert (out["prefills"], out["decode_steps"]) == (10, 3 + 3 * 6)


# scripts/bench_train.py:105-110
def test_train_main(capsys, monkeypatch):
    monkeypatch.setenv("BENCH_TEXT", "16")
    train.main(CPU)
    out = _lines(capsys)
    assert {"metric", "examples_per_sec", "step_sec", "loss"} <= set(out)
    assert out["examples_per_sec"] > 0 and np.isfinite(out["loss"])
    assert out["metric"] == "align-stage train step (llm depth 8/32, bsz 2)"


# scripts/bench_serving.py:470-488 (the merged line); each phase's partials at :89-92 and :416-430
SERVING_KEYS = {"metric", "layers", "slots", "requests", "total_new_tokens", "group_tok_s", "engine_tok_s",
                "engine_vs_group", "engine_util", "spec_tok_s", "spec_tokens_per_step", "spec_step_overhead", "int8",
                "int8_kv", "platform"}


def test_serving_main_merges_its_three_phases(capsys, monkeypatch):
    monkeypatch.setenv("BENCH_LLM_LAYERS", "2")
    monkeypatch.setenv("BENCH_REQUESTS", "3")
    serving.main(CPU)
    out = _lines(capsys)
    assert SERVING_KEYS <= set(out)
    assert out["platform"] == "cpu" and out["requests"] == 3
    assert all(out[k] > 0 for k in ("group_tok_s", "engine_tok_s", "spec_tok_s", "spec_step_overhead"))
    for ph in serving.PHASES:
        assert out["phases"][ph]["work"]["decode_forwards"] > 0 and set(out["phases"][ph]["launches"])


# scripts/bench_serving.py:179-185 (churn), :252-258 (prefix), :362-366 and :403-411 (spec_curve)
PHASE_KEYS = {
    "churn": {"fused", "fused_blocking", "batched", "per_request"},
    "prefix": {"shared", "full", "prefix_len", "budget", "prefix_requests"},
    "spec_curve": {"plain_step_ms", "plain_tok_s_per_slot", "curve", "realized"},
}


@pytest.mark.parametrize("phase", list(PHASE_KEYS))
def test_serving_phase(phase, capsys, monkeypatch):
    monkeypatch.setenv("BENCH_PHASE", phase)
    monkeypatch.setenv("BENCH_LLM_LAYERS", "2")
    monkeypatch.setenv("BENCH_CHURN_REQUESTS", "6")
    monkeypatch.setenv("BENCH_PREFIX_LEN", "32")
    monkeypatch.setenv("BENCH_PREFIX_REQUESTS", "4")
    monkeypatch.setenv("BENCH_STEPS_PER_SYNC", "4")
    serving.main(CPU)
    out = _lines(capsys)
    assert PHASE_KEYS[phase] <= set(out)
    if phase == "spec_curve":
        assert [c["gamma"] for c in out["curve"]] == [2, 4, 8]
        assert [r["corrupt_every"] for r in out["realized"]] == [1, 2, 4, 0]
        # the clean oracle is the verify program's own stream: it drafts truth between no corruptions
        assert out["realized"][-1]["tokens_per_step"] > out["realized"][0]["tokens_per_step"]
    if phase == "prefix":
        assert out["shared"]["prefills"] >= 1 and out["full"]["tok_s"] > 0


def test_breakdown_main(capsys):
    breakdown.main(CPU + ["--layers", "2"])
    captured = capsys.readouterr()
    # merv_tpu prints these stage lines (scripts/bench_breakdown.py:85, :91, :105, :106); the port keeps them on stderr
    for stage in ("tower[0]", "tower[3]", "projectors+fusion", "llm prefill (seq=", "sum of stages"):
        assert stage in captured.err
    out = json.loads(captured.out.strip().splitlines()[-1])
    assert {"towers_ms", "projectors_fusion_ms", "llm_prefill_ms", "sum_ms", "seq"} <= set(out)
    assert len(out["towers_ms"]) == 4 and out["seq"] == 64 + 16
    assert out["sum_ms"] == pytest.approx(sum(out["towers_ms"].values()) + out["projectors_fusion_ms"]
                                          + out["llm_prefill_ms"], abs=1e-2)


# scripts/bench_tower_attn.py:86-94 (each row) and :128 (the line)
def test_tower_attn_main_runs_each_impl_apart(capsys):
    tower_attn.main(CPU + ["--impls", "small,fused_block"])
    out = _lines(capsys)
    assert {"batch", "rows"} <= set(out)
    assert [r["impl"] for r in out["rows"]] == ["small", "fused_block"]
    for row in out["rows"]:
        assert {"impl", "languagebind_ms", "dinov2_ms"} <= set(row) and row["languagebind_ms"] > 0
        assert set(row["launches"]) >= {"small_attention_kt", "fused_vit_attn_block"}


def test_tower_attn_one_sets_the_switch(capsys, monkeypatch):
    seen = {}
    import merv_tpu_torch.models.backbones.video.vit as vit

    real = vit.dispatch_plan

    def spy(*a, **k):
        seen["switch"] = os.environ.get("MERV_TPU_TOWER_ATTN")
        return real(*a, **k)

    monkeypatch.setattr(vit, "dispatch_plan", spy)
    monkeypatch.setenv("TOWER_ATTN_IMPL", "xla_kt")
    monkeypatch.delenv("MERV_TPU_TOWER_ATTN", raising=False)
    try:
        tower_attn.main(CPU + ["--one"])
    finally:
        os.environ.pop("MERV_TPU_TOWER_ATTN", None)
    out = _lines(capsys)
    assert out["impl"] == "xla_kt" and seen["switch"] == "xla_kt"


# scripts/bench_tower_ops.py:179-180
def test_tower_ops_main(capsys):
    tower_ops.main(CPU)
    out = _lines(capsys)
    assert {"tower", "batch", "components_ms"} <= set(out)
    names = list(out["components_ms"])
    assert names[0] == "full tower" and names[-1] == "full tower, fp32 input"
    for chain in ("GEMM chain", "attention chain", "LayerNorm chain", "GELU chain", "patch-embed conv"):
        assert any(n.startswith(chain) for n in names), chain
    assert all(v > 0 for v in out["components_ms"].values())


# scripts/bench_loader.py:96-101
def test_loader_main(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("BENCH_LOADER_VIDEO", str(tmp_path / "clip.mp4"))
    loader.main(CPU + ["--seconds", "0.5"])
    out = _lines(capsys)
    assert {"metric", "value", "unit", "workers_to_saturate_device"} <= set(out)
    assert out["value"] > 0 and out["video_backend"] in ("native", "cv2", "imageio")
