"""The port's evaluation drivers (merv_tpu_torch.cli) against scripts/eval_*.py, on a tiny model on the CPU.

Both drivers of each pair run on the same questions (``eval_data/dummy_mcq``,
``eval_data/dummy_openended``) with the same weights: merv_tpu's tiny MERV and
the port's copy of it through merv_tpu_torch.bridge (``merv_pair``), handed to
each driver in place of its ``load_vid``; one more case runs both drivers'
own ``load_vid`` on a run directory that merv_tpu writes (the ``run_dir``
fixture of tests/test_torch_load_vid.py: four tiny towers, an Orbax checkpoint). Each port run must give
merv_tpu's ``pred`` for every ``question_id``, write the same merged and scored
files, and log no per-group or per-item failure (a fallback would hide a fault
of the batched path). ``--quantize_llm`` and ``--int8_kv`` are held the same way (both
packages' scripts handed the pair with int8 LLM weights for the first). Also:
``flops.json``'s parameter count equals merv_tpu's,
and its GFLOPs (FlopCounterMode's products) are compared with merv_tpu's (XLA's
cost analysis).
"""

import copy
import json
import logging
import os
import types
from pathlib import Path

import jax
import numpy as np
import pytest

import merv_tpu_torch.cli.eval_mcq as port_mcq
import merv_tpu_torch.cli.eval_openended as port_oe
import scripts.eval_mcq as jax_mcq
import scripts.eval_openended as jax_oe
from merv_tpu.nn.quantization import quantize_tree as jax_quantize_tree
from merv_tpu_torch.nn.quantization import quantize_tree
from test_torch_generation_shared import merv_pair
from test_torch_load_vid import run_dir  # noqa: F401  (the fixture: a run directory merv_tpu writes)

REPO = Path(__file__).resolve().parent.parent
MODEL_CFG = types.SimpleNamespace(num_frames=[4, 4])
MAX_NEW = 4


@pytest.fixture(scope="module")
def models():
    return merv_pair()


@pytest.fixture
def drivers(models, monkeypatch, tmp_path):
    """Both packages' drivers load the tiny pair; the port's is asked for the CPU."""
    jm, params, pm = models
    asked = []

    def port_load(src, get_model_cfg=False, allow_random_weights=False, quantize_llm=False, device=None):
        asked.append(device)
        return pm, MODEL_CFG

    monkeypatch.setattr(jax_mcq, "load_vid", lambda *a, **k: (jm, params, MODEL_CFG))
    monkeypatch.setattr(jax_oe, "load_vid", lambda *a, **k: (jm, params, MODEL_CFG))
    monkeypatch.setattr(port_mcq, "load_vid", port_load)
    monkeypatch.chdir(tmp_path)
    yield asked
    assert asked and set(asked) == {"cpu"}


def _args(**kw):
    return [a for k, v in kw.items() for a in (f"--{k}", str(v))]


def _common(dataset, root):
    return dict(model_path="tiny-run", eval_dataset=dataset, max_new_tokens=MAX_NEW,
                eval_data_root=REPO / "eval_data", eval_result_root=root, allow_random_weights=True)


def _preds(path):
    return {r["question_id"]: r["pred"] for r in map(json.loads, path.read_text().splitlines()) if r}


def _port_failures(caplog):
    return [r.getMessage() for r in caplog.records if r.name.startswith("merv_tpu_torch") and r.levelno >= logging.ERROR]


MCQ_CASES = {
    "naive_batch1": dict(batch_size=1),
    "naive_batch2": dict(batch_size=2),
    "likelihood": dict(strategy="likelihood", batch_size=2),
    "share_video_prefix": dict(share_video_prefix=True, batch_size=2),
}


@pytest.mark.parametrize("case", list(MCQ_CASES))
def test_eval_mcq_matches_script(case, drivers, tmp_path, caplog):
    kw = MCQ_CASES[case]
    strategy = kw.get("strategy", "naive")
    jax_mcq.evaluate(cfg=jax_mcq.EvalConfig(**_common("dummy_mcq", tmp_path / "jax"), **kw))
    caplog.clear()
    with caplog.at_level(logging.INFO):
        port_mcq.evaluate(args=_args(**_common("dummy_mcq", tmp_path / "port"), device="cpu", **kw))
    assert not _port_failures(caplog)
    jdir, pdir = tmp_path / "jax" / "tiny-run", tmp_path / "port" / "tiny-run"
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == sorted(
        [f"dummy_mcq_{strategy}_pred_merge.jsonl", f"dummy_mcq_{strategy}_gpt.json"])
    merged = f"dummy_mcq_{strategy}_pred_merge.jsonl"
    want, got = _preds(jdir / merged), _preds(pdir / merged)
    assert len(got) == 6 and got == want
    assert json.loads((pdir / f"dummy_mcq_{strategy}_gpt.json").read_text()).keys() == want.keys()


def test_eval_openended_matches_script_and_resumes(drivers, tmp_path, caplog, capsys):
    kw = dict(batch_size=2)
    jax_oe.evaluate(cfg=jax_oe.EvalConfig(**_common("dummy_openended", tmp_path / "jax"), **kw))
    jdir = tmp_path / "jax" / "tiny-run"
    want = _preds(jdir / "dummy_openended_pred_merge.jsonl")
    assert len(want) == 3
    capsys.readouterr()
    with caplog.at_level(logging.INFO):
        port_oe.evaluate(cfg=port_oe.EvalConfig(**_common("dummy_openended", tmp_path / "port"), device="cpu", **kw))
    assert not _port_failures(caplog)
    pdir = tmp_path / "port" / "tiny-run"
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == ["dummy_openended_pred_merge.jsonl", "flops.json"]
    assert _preds(pdir / "dummy_openended_pred_merge.jsonl") == want
    served = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert served["questions"] == 3 and served["serving_wall_s"] >= 0

    jflops, pflops = (json.loads((d / "flops.json").read_text()) for d in (jdir, pdir))
    assert pflops["params"] == jflops["params"]
    ratio = pflops["gflops"] / jflops["gflops"]
    with capsys.disabled():
        print(f"flops.json: port {pflops['gflops']:.6f} GFLOPs (FlopCounterMode), merv_tpu {jflops['gflops']:.6f} "
              f"(XLA cost analysis), ratio {ratio:.4f}")
    assert 0.5 <= ratio <= 2.0

    # resume: a temp shard already holds the first question's line; the port serves the other two
    rdir = tmp_path / "resume" / "tiny-run"
    rdir.mkdir(parents=True)
    first = next(line for line in (jdir / "dummy_openended_pred_merge.jsonl").read_text().splitlines()
                 if json.loads(line)["question_id"] == "dummy_oe_0")
    (rdir / "dummy_openended_pred_1_0.jsonl").write_text(first + "\n")
    port_oe.evaluate(cfg=port_oe.EvalConfig(**_common("dummy_openended", tmp_path / "resume"), device="cpu",
                                            skip_flops=True, **kw))
    served = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert served["questions"] == 2
    assert sorted(os.listdir(rdir)) == ["dummy_openended_pred_merge.jsonl"]
    assert _preds(rdir / "dummy_openended_pred_merge.jsonl") == want


def test_eval_mcq_on_a_run_directory_matches_script(run_dir, monkeypatch, tmp_path, caplog):
    """Both drivers load the same run directory with their own ``load_vid``
    (``--model_path`` relative to the working directory, the port's on
    ``--device cpu``): the same ``pred`` for every question, the same files."""
    monkeypatch.chdir(run_dir.parent)
    kw = dict(_common("dummy_mcq", tmp_path / "jax"), model_path=run_dir.name, allow_random_weights=False,
              batch_size=2)
    jax_mcq.evaluate(cfg=jax_mcq.EvalConfig(**kw))
    with caplog.at_level(logging.INFO):
        port_mcq.evaluate(args=_args(**dict(kw, eval_result_root=tmp_path / "port"), device="cpu"))
    assert not _port_failures(caplog)
    jdir, pdir = tmp_path / "jax" / run_dir.name, tmp_path / "port" / run_dir.name
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    want = _preds(jdir / "dummy_mcq_naive_pred_merge.jsonl")
    assert len(want) == 6 and _preds(pdir / "dummy_mcq_naive_pred_merge.jsonl") == want


@pytest.mark.parametrize("module, axis", [(port_mcq, "tensor"), (port_oe, "tensor")])
def test_unported_flags_raise(module, axis, run_dir, tmp_path, caplog):
    """--mesh_seq serves (tests/test_torch_sp_serving.py), and so does a
    serving mesh with a tensor axis: the drivers' loader turns packing off
    under it with merv_tpu's info line (the rules key on the unpacked
    paths). On a virtual mesh, whose ranks share one process, the weights
    stay whole (a device mesh cuts them: tests/test_torch_tensor_parallel.py),
    and the model answers as the loader's model without a mesh does."""
    from merv_tpu_torch.parallel import VirtualMesh

    cfg = module.EvalConfig(**dict(_common("dummy_mcq", tmp_path), model_path=str(run_dir),
                                   allow_random_weights=False), device="cpu")
    with caplog.at_level(logging.INFO):
        on_mesh, _ = module.load_model(cfg, VirtualMesh(1, **{axis: 2}))
    assert any("disabling packed serving layout" in r.getMessage() for r in caplog.records)
    plain, _ = module.load_model(cfg)
    dec = on_mesh.llm_backbone.decoder
    assert "qkv_proj" not in dec.layers[0].attn._modules and dec.tp is None
    assert "qkv_proj" in plain.llm_backbone.decoder.layers[0].attn._modules
    video = np.random.RandomState(3).randint(0, 256, size=(8, 40, 48, 3)).astype(np.uint8)
    prompt = "In: what is in this video?\nOut: "
    assert on_mesh.generate_batch([video], [prompt], max_new_tokens=MAX_NEW, mesh=VirtualMesh(1, **{axis: 2})) == \
        plain.generate_batch([video], [prompt], max_new_tokens=MAX_NEW)


@pytest.fixture(scope="module")
def int8_models(models):
    """The tiny pair with its LLM's Linears in merv_tpu's weight-only int8 layout, on both sides."""
    jm, params, pm = models
    qparams = {**params, "llm_backbone": jax.tree_util.tree_map(np.asarray, jax_quantize_tree(params["llm_backbone"]))}
    qpm = copy.deepcopy(pm)
    quantize_tree(qpm.llm_backbone)
    return jm, qparams, qpm


@pytest.mark.parametrize("script, flag", [("mcq", "quantize_llm"), ("mcq", "int8_kv"), ("openended", "quantize_llm"),
                                          ("openended", "int8_kv")])
def test_int8_flags_match_script(script, flag, models, int8_models, monkeypatch, tmp_path, caplog):
    """``--quantize_llm`` (both scripts' loaders asked for it and handed the
    int8 pair) and ``--int8_kv``: merv_tpu's ``pred`` for every question, with
    eval_mcq's shared video prefix (the int8 prefix cache) and eval_openended's
    batch of 2."""
    jm, params, pm = int8_models if flag == "quantize_llm" else models
    asked = {"jax": [], "port": []}

    def jax_load(*a, **k):
        asked["jax"].append(k.get("quantize_llm"))
        return jm, params, MODEL_CFG

    def port_load(src, get_model_cfg=False, allow_random_weights=False, quantize_llm=False, device=None):
        asked["port"].append(quantize_llm)
        return pm, MODEL_CFG

    jax_mod, port_mod = (jax_mcq, port_mcq) if script == "mcq" else (jax_oe, port_oe)
    monkeypatch.setattr(jax_mod, "load_vid", jax_load)
    monkeypatch.setattr(port_mcq, "load_vid", port_load)
    monkeypatch.chdir(tmp_path)
    dataset = "dummy_mcq" if script == "mcq" else "dummy_openended"
    kw = dict(batch_size=2, **{flag: True}, **(dict(share_video_prefix=True) if script == "mcq" else
                                                dict(skip_flops=True)))
    jax_mod.evaluate(cfg=jax_mod.EvalConfig(**_common(dataset, tmp_path / "jax"), **kw))
    with caplog.at_level(logging.INFO):
        port_mod.evaluate(cfg=port_mod.EvalConfig(**_common(dataset, tmp_path / "port"), device="cpu", **kw))
    assert not _port_failures(caplog)
    assert asked["jax"] == asked["port"] == [flag == "quantize_llm"]
    merged = f"{dataset}_naive_pred_merge.jsonl" if script == "mcq" else f"{dataset}_pred_merge.jsonl"
    want = _preds(tmp_path / "jax" / "tiny-run" / merged)
    assert len(want) == (6 if script == "mcq" else 3) and _preds(tmp_path / "port" / "tiny-run" / merged) == want


def test_drivers_default_to_the_card(monkeypatch, tmp_path):
    """Without --device the drivers load on the card, and raise where there is none."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for module in (port_mcq, port_oe):
        assert module.EvalConfig().device is None
        with pytest.raises(RuntimeError, match="device='cpu'"):
            module.evaluate(cfg=module.EvalConfig(**_common("dummy_mcq", tmp_path)))
