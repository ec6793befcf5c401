"""Sequence-parallel serving of the port's tiny MERV at sp = 2 (one spawned
gloo world of 2 ranks on the CPU) against merv_tpu at sp = 2 on its virtual
devices and against the port at sp = 1: ``generate_batch`` (and its prefill's
logits), ``score_options`` (the ring), the continuous-batching engine and
``eval_openended --mesh_seq 2 --device cpu`` through its group path and
``--use_engine``. Greedy tokens identical; logits within 1e-4 in fp32."""

import json
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import merv_tpu_torch.models.generation as G
import scripts.eval_openended as jax_oe
import torch_sp_workers
from merv_tpu.parallel import MeshConfig as JaxMeshConfig
from merv_tpu.parallel import build_mesh as jax_build_mesh
from merv_tpu.serving import ContinuousBatchingEngine as JaxEngine
from merv_tpu.serving import Request as JaxRequest
from merv_tpu_torch.models.generation import GenerationConfig
from merv_tpu_torch.serving import ContinuousBatchingEngine, Request
from test_torch_generation_shared import PROMPTS, _videos, merv_pair
from test_torch_ring_attention import spawn_world

REPO = Path(__file__).resolve().parent.parent
WORLD = 2
MAX_NEW = 6
OPTIONS = [["A", "B"], ["A", "B", "C"], ["B", "C"]]
ENGINE_MAX_LEN = 96
MODEL_CFG = types.SimpleNamespace(num_frames=[4, 4])
EVAL_ARGS = ["--model_path", "tiny-run", "--eval_dataset", "dummy_openended", "--max_new_tokens", "4",
             "--eval_data_root", str(REPO / "eval_data"), "--allow_random_weights", "true", "--skip_flops", "true"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jm, params, pm = merv_pair()
    cwd = tmp_path_factory.mktemp("sp_eval")
    inp = dict(model=pm, videos=_videos(3), prompts=PROMPTS, options=OPTIONS, max_new=MAX_NEW,
               engine_max_len=ENGINE_MAX_LEN, model_cfg=MODEL_CFG, cwd=str(cwd), eval_args=EVAL_ARGS)
    ranks = spawn_world(torch_sp_workers.serving_world, WORLD, inp, tmp_path_factory.mktemp("serving_world"))
    jm.llm_backbone.sequence_parallel = True  # merv_tpu's drivers set it so on an sp mesh
    jmesh = jax_build_mesh(JaxMeshConfig(data=1, fsdp=-1, tensor=1, seq=WORLD))
    return jm, params, pm, jmesh, inp, ranks


def test_sp_generate_matches_merv_tpu_and_sp1(world):
    jm, params, pm, jmesh, inp, ranks = world
    want = jm.generate_batch(params, inp["videos"], PROMPTS, max_new_tokens=MAX_NEW, mesh=jmesh)
    seen = []
    prefill = G.prefill

    def recorded(*args, **kwargs):
        out = prefill(*args, **kwargs)
        seen.append(out[0].clone())
        return out

    G.prefill = recorded
    try:
        sp1 = pm.generate_batch(inp["videos"], PROMPTS, max_new_tokens=MAX_NEW)
    finally:
        G.prefill = prefill
    for r in ranks:
        assert r["generate"] == want == sp1
        assert r["generate_sharded"]  # the decode cache tiles sp: the sharded route
        rel = float((r["generate_logits"] - seen[0]).norm() / seen[0].norm())
        assert rel <= 1e-4, rel
    cache_len = ranks[0]["generate_cache_rows"]
    assert all(r["generate_cache_rows"] == cache_len for r in ranks)


def test_sp_score_options_matches_merv_tpu_and_sp1(world):
    jm, params, pm, jmesh, inp, ranks = world
    want = jm.score_options(params, inp["videos"], PROMPTS, OPTIONS, mesh=jmesh)
    assert pm.score_options(inp["videos"], PROMPTS, OPTIONS) == want
    for r in ranks:
        assert r["score"] == want


def test_sp_engine_matches_merv_tpu_and_sp1(world):
    jm, params, pm, jmesh, inp, ranks = world
    gcfg = GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=pm.llm_backbone.stop_token_id,
                            pad_token_id=pm.llm_backbone.pad_token_id)
    engine = ContinuousBatchingEngine.for_vidlm(pm, slots=2, max_len=ENGINE_MAX_LEN, length_bucket=8, config=gcfg)
    reqs = [(str(i), v, p) for i, (v, p) in enumerate(zip(inp["videos"], PROMPTS))]
    sp1 = {k: r.token_ids.tolist() for k, r in engine.run([Request(i, prompt_text=p, video=v, max_new_tokens=MAX_NEW)
                                                           for i, v, p in reqs]).items()}
    from merv_tpu.models.generation import GenerationConfig as JaxGenConfig

    jcfg = JaxGenConfig(max_new_tokens=MAX_NEW, eos_token_id=jm.llm_backbone.stop_token_id,
                        pad_token_id=jm.llm_backbone.pad_token_id)
    jengine = JaxEngine.for_vidlm(jm, params, slots=2, max_len=ENGINE_MAX_LEN, length_bucket=8, config=jcfg,
                                  mesh=jmesh)
    want = {k: np.asarray(r.token_ids).tolist()
            for k, r in jengine.run([JaxRequest(i, prompt_text=p, video=v, max_new_tokens=MAX_NEW)
                                     for i, v, p in reqs]).items()}
    assert ranks[0]["engine"] == want == sp1
    assert ranks[1]["engine"] == {}  # only rank 0 returns results
    # rows rounded up to tile sp: each rank holds its half and a scratch row (sp = 1: all of them and one)
    assert ranks[0]["engine_rows"] == -(-ENGINE_MAX_LEN // WORLD) + 1 < engine._state.k.shape[3]


@pytest.mark.parametrize("label, extra", [("group", dict(batch_size=2)), ("engine", dict(use_engine=True))])
def test_sp_eval_openended_matches_merv_tpu(world, label, extra, monkeypatch, tmp_path):
    jm, params, pm, jmesh, inp, ranks = world
    monkeypatch.setattr(jax_oe, "load_vid", lambda *a, **k: (jm, params, MODEL_CFG))
    monkeypatch.chdir(tmp_path)
    jax_oe.evaluate(cfg=jax_oe.EvalConfig(
        model_path="tiny-run", eval_dataset="dummy_openended", max_new_tokens=4, eval_data_root=REPO / "eval_data",
        eval_result_root=tmp_path, allow_random_weights=True, skip_flops=True, mesh_seq=WORLD, **extra))
    preds = lambda p: {r["question_id"]: r["pred"] for r in map(json.loads, p.read_text().splitlines()) if r}  # noqa: E731
    want = preds(tmp_path / "tiny-run" / "dummy_openended_pred_merge.jsonl")
    port_dir = Path(inp["cwd"]) / f"oe_{label}" / "tiny-run"
    assert ranks[0][f"eval/{label}"] == ["dummy_openended_pred_merge.jsonl"]  # rank 0 wrote the merged file only
    assert ranks[1][f"eval/{label}"] is None
    assert len(want) == 3 and preds(port_dir / "dummy_openended_pred_merge.jsonl") == want
    jax.clear_caches()
