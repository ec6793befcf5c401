"""The port's serving commands on a run directory that merv_tpu writes, on the CPU.

``python -m merv_tpu_torch.cli.serve`` and ``eval_openended --use_engine``
(and ``--speculative``) load the tiny run directory of
tests/test_torch_load_vid.py (four tiny towers, an Orbax checkpoint written by
merv_tpu) with the port's own ``load_vid`` on ``--device cpu``. Every request
must be answered, only the request naming a missing video may fail, and each
answer's text must be what the port's ``MERV.generate`` gives for it; the
resume protocol must skip what is already on disk.
"""

import json
import logging
from pathlib import Path

import pytest

import merv_tpu_torch.cli.eval_openended as port_oe
import merv_tpu_torch.cli.serve as port_serve
from merv_tpu_torch import load_vid
from test_torch_load_vid import DEMO, run_dir  # noqa: F401  (the fixture: a run directory merv_tpu writes)

REPO = Path(__file__).resolve().parent.parent
PROMPTS = ["What is happening in this video?", "What color is the background?", "Is there a person?"]
MAX_NEW = 4


def _args(**kw):
    return [a for k, v in kw.items() for a in (f"--{k}", str(v))]


def _failures(caplog):
    return [r.getMessage() for r in caplog.records if r.name.startswith("merv_tpu_torch") and r.levelno >= logging.ERROR]


def _requests(path, pm, missing):
    builder = lambda q: pm.llm_backbone.prompt_builder_fn("merv").get_potential_prompt(q)  # noqa: E731
    reqs = [dict(request_id=f"v{i}", prompt=builder(q), video=str(DEMO)) for i, q in enumerate(PROMPTS)]
    reqs += [dict(request_id="t0", prompt=builder("Say something about cats."), max_new_tokens=3),
             dict(request_id="bad", prompt=builder(PROMPTS[0]), video=str(missing))]
    path.write_text("".join(json.dumps(r) + "\n" for r in reqs))
    return reqs


@pytest.mark.parametrize("mode", ["shared", "unshared", "speculative"])
def test_serve_answers_every_request_as_generate_does(mode, run_dir, tmp_path, caplog, capsys):
    pm = load_vid(run_dir, device="cpu")
    reqs = _requests(tmp_path / "reqs.jsonl", pm, tmp_path / "missing.mp4")
    want = {r["request_id"]: pm.generate(r.get("video"), r["prompt"], max_new_tokens=r.get("max_new_tokens", MAX_NEW))
            for r in reqs if r["request_id"] != "bad"}
    out = tmp_path / "out.jsonl"
    extra = {"shared": {}, "unshared": dict(share_video_prefix=False), "speculative": dict(speculative=3)}[mode]
    argv = _args(model_path=run_dir, requests=tmp_path / "reqs.jsonl", output=out, slots=2, max_len=256,
                 max_new_tokens=MAX_NEW, device="cpu", **extra)
    capsys.readouterr()
    with caplog.at_level(logging.INFO):
        port_serve.serve(args=argv)
    rows = {r["request_id"]: r for r in map(json.loads, out.read_text().splitlines())}
    assert sorted(rows) == sorted(r["request_id"] for r in reqs)
    assert [rid for rid, r in rows.items() if r["finish_reason"] == "error"] == ["bad"] and rows["bad"]["error"]
    assert {rid: r["text"] for rid, r in rows.items() if rid != "bad"} == want
    assert [m for m in _failures(caplog) if "request bad failed" not in m] == []
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["requests"] == len(reqs) and summary["errors"] == 1
    if mode != "unshared":
        # one demo-video prefix for the three questions; the text-only request prefills in full
        assert summary["prefix_builds"] == 1 and summary["prefix_admissions"] == 3
        assert summary["prefills"] - summary["suffix_prefills"] == 1
    else:
        assert summary["prefix_admissions"] == 0 and summary["prefills"] == 4
    if mode == "speculative":
        assert summary["spec_steps"] > 0

    # resume: a rerun on the same output serves nothing again
    port_serve.serve(args=argv)
    assert len(out.read_text().splitlines()) == len(reqs)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["requests"] == 0


def test_serve_int8_answers_as_merv_tpu_generates(run_dir, tmp_path, caplog, capsys):
    """``--quantize_llm --int8_kv`` with prefix sharing: every request
    answered (only the missing video fails) with the text merv_tpu's
    ``generate`` gives on its int8 model and int8 cache."""
    import merv_tpu.models.load_vid as jax_load_vid_mod

    jm, jparams = jax_load_vid_mod.load_vid(str(run_dir), quantize_llm=True)
    pm = load_vid(run_dir, device="cpu")
    reqs = _requests(tmp_path / "reqs.jsonl", pm, tmp_path / "missing.mp4")
    want = {r["request_id"]: jm.generate(jparams, r.get("video"), r["prompt"],
                                         max_new_tokens=r.get("max_new_tokens", MAX_NEW), kv_cache_dtype="int8")
            for r in reqs if r["request_id"] != "bad"}
    out = tmp_path / "out.jsonl"
    argv = _args(model_path=run_dir, requests=tmp_path / "reqs.jsonl", output=out, slots=2, max_len=256,
                 max_new_tokens=MAX_NEW, device="cpu", quantize_llm=True, int8_kv=True)
    capsys.readouterr()
    with caplog.at_level(logging.INFO):
        port_serve.serve(args=argv)
    rows = {r["request_id"]: r for r in map(json.loads, out.read_text().splitlines())}
    assert [rid for rid, r in rows.items() if r["finish_reason"] == "error"] == ["bad"]
    assert {rid: r["text"] for rid, r in rows.items() if rid != "bad"} == want
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["prefix_builds"] == 1 and summary["decode_forwards"] > 0


def _common(run_dir, root, **kw):
    return dict(model_path=run_dir.name, eval_dataset="dummy_openended_scaled", max_new_tokens=MAX_NEW,
                eval_data_root=REPO / "eval_data", eval_result_root=root, skip_flops=True, num_chunks=2, device="cpu",
                **kw)


def _preds(path):
    return {r["question_id"]: r["pred"] for r in map(json.loads, path.read_text().splitlines()) if r}


def test_eval_openended_engine_and_speculative_give_generate_answers(run_dir, monkeypatch, tmp_path, caplog, capsys):
    """The first chunk of dummy_openended_scaled (16 questions on 2 videos):
    the engine's answers (shared prefixes, and un-shared), and the batch-1
    loop's with --speculative, each equal to the batch-1 loop's."""
    monkeypatch.chdir(run_dir.parent)
    port_oe.evaluate(cfg=port_oe.EvalConfig(**_common(run_dir, tmp_path / "plain")))
    shard = f"{run_dir.name}/dummy_openended_scaled_pred_2_0_done.jsonl"
    want = _preds(tmp_path / "plain" / shard)
    assert len(want) == 16
    runs = {"engine_shared": dict(use_engine=True, serving_passes=2),
            "engine_unshared": dict(use_engine=True, share_video_prefix=False),
            "speculative": dict(speculative=2)}
    for name, kw in runs.items():
        caplog.clear()
        capsys.readouterr()
        with caplog.at_level(logging.INFO):
            port_oe.evaluate(cfg=port_oe.EvalConfig(**_common(run_dir, tmp_path / name), **kw))
        assert not _failures(caplog), name
        assert _preds(tmp_path / name / shard) == want, name
        served = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert served["questions"] == 16
        if name == "engine_shared":
            assert served["prefix_admissions"] == 16 and served["passes"] == 2
    with pytest.raises(ValueError, match="batch_size 1"):
        port_oe.evaluate(cfg=port_oe.EvalConfig(**_common(run_dir, tmp_path / "x"), speculative=2, batch_size=2))
