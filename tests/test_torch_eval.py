"""The port's evaluation drivers (merv_tpu_torch.cli) against scripts/eval_*.py, on a tiny model on the CPU.

Both drivers of each pair run on the same questions (``eval_data/dummy_mcq``,
``eval_data/dummy_openended``) with the same weights: merv_tpu's tiny MERV and
the port's copy of it through merv_tpu_torch.bridge (``merv_pair``), handed to
each driver in place of its ``load_vid``; one more case runs both drivers'
own ``load_vid`` on a run directory that merv_tpu writes (the ``run_dir``
fixture of tests/test_torch_load_vid.py: four tiny towers, an Orbax checkpoint). Each port run must give
merv_tpu's ``pred`` for every ``question_id``, write the same merged and scored
files, and log no per-group or per-item failure (a fallback would hide a fault
of the batched path). Also: ``flops.json``'s parameter count equals merv_tpu's,
and its GFLOPs (FlopCounterMode's products) are compared with merv_tpu's (XLA's
cost analysis).
"""

import json
import logging
import os
import types
from pathlib import Path

import pytest

import merv_tpu_torch.cli.eval_mcq as port_mcq
import merv_tpu_torch.cli.eval_openended as port_oe
import scripts.eval_mcq as jax_mcq
import scripts.eval_openended as jax_oe
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


@pytest.mark.parametrize("module, flag, item", [
    (port_mcq, "quantize_llm", "A2"), (port_mcq, "int8_kv", "A4"), (port_mcq, "mesh_seq", "A12"),
    (port_oe, "int8_kv", "A4"),
    (port_oe, "quantize_llm", "A2"), (port_oe, "mesh_seq", "A12"),
])
def test_unported_flags_raise(module, flag, item, tmp_path):
    value = {"mesh_seq": 2}.get(flag, True)
    with pytest.raises(NotImplementedError, match=item):
        module.evaluate(cfg=module.EvalConfig(**_common("dummy_mcq", tmp_path), device="cpu", **{flag: value}))


def test_drivers_default_to_the_card(monkeypatch, tmp_path):
    """Without --device the drivers load on the card, and raise where there is none."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for module in (port_mcq, port_oe):
        assert module.EvalConfig().device is None
        with pytest.raises(RuntimeError, match="device='cpu'"):
            module.evaluate(cfg=module.EvalConfig(**_common("dummy_mcq", tmp_path)))
