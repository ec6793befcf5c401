"""The port's tooling modules against merv_tpu's scripts, on the CPU:
merv_tpu_torch.cli.make_randinit_run (scripts/make_randinit_run.py),
merv_tpu_torch.cli.export_towers (scripts/export_towers.py),
merv_tpu_torch.cli.preprocess (scripts/preprocess.py) and
merv_tpu_torch.bench.vidlm_prefix (scripts/bench_vidlm_prefix.py).

Tiny towers and LLM stand in for merv-full's (the modules of
tests/test_torch_load_vid.py and tests/test_torch_vision_zoo.py); weights
and files are compared exactly, after the same rounding on both sides.
"""

import ast
import contextlib
import io
import json
import subprocess
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import merv_tpu.models.backbones.video.vision_import as jax_vision_import
import merv_tpu_torch.cli.eval_mcq as port_mcq
import merv_tpu_torch.cli.eval_openended as port_oe
import merv_tpu_torch.models.load_vid as port_load_vid_mod
import merv_tpu_torch.models.materialize as port_materialize
import scripts.preprocess as jax_preprocess
from merv_tpu_torch import benchkit, load_vid
from merv_tpu_torch.bench import vidlm_prefix
from merv_tpu_torch.bridge import module_state_dicts, state_dict_from_jax
from merv_tpu_torch.cli import export_towers, make_randinit_run
from merv_tpu_torch.cli import preprocess as port_preprocess
from merv_tpu_torch.models.backbones.video.vision_import import load_pretrained_tower
from merv_tpu_torch.models.vidlms import MERV
from merv_tpu_torch.nn.quantization import quantize_tree
from merv_tpu_torch.training.checkpointing import latest_checkpoint, load_checkpoint
from test_torch_hiera import _hiera_pth_state
from test_torch_load_vid import RUN_CONFIG, TOWERS, _jax_merv, _jax_tower, _languagebind_state, _port_llm, _port_tower
from test_torch_vision_zoo import _tiny_pair

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


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


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def _assert_same_values(got, want):
    """Equal values: the port's tiny tower stores fp32 what both importers rounded to bf16."""
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k].float(), want[k].float()), k


# ---------------------------------------------------------------------------
# make_randinit_run
# ---------------------------------------------------------------------------


def test_randinit_config_is_merv_tpus_key_for_key():
    """scripts/make_randinit_run.py:38-52, read from its source (the script is not run)."""
    tree = ast.parse((REPO / "scripts" / "make_randinit_run.py").read_text())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "model_cfg" for t in n.targets))
    want = ast.literal_eval(node.value)
    assert list(make_randinit_run.MERV_FULL_MODEL.items()) == list(want.items())


def _tiny_factories(monkeypatch, module):
    """``module``'s three registry factories build the tiny towers, LLM and MERV of tests/test_torch_load_vid.py."""
    monkeypatch.setattr(module, "get_video_backbone_and_transform",
                        lambda *a, device=None, **k: ([_port_tower(n, torch.float32, device) for n in TOWERS], []))
    monkeypatch.setattr(module, "get_llm_backbone_and_tokenizer",
                        lambda *a, device=None, **k: (_port_llm(torch.float32, device=device), None))
    monkeypatch.setattr(module, "get_vidlm",
                        lambda model_id, arch, fusion, vbs, llm, device=None, param_dtype=torch.float32, **k: MERV(
                            model_id, vbs, llm, arch_specifier=arch, feature_fusion=fusion,
                            projector_token_length=k["projector_token_length"],
                            visual_feature_length=k["visual_feature_length"], text_embedding_dim=32,
                            param_dtype=param_dtype, device=device))


def test_randinit_run_loads_into_load_vid_with_merv_tpus_names(tmp_path, monkeypatch):
    _tiny_factories(monkeypatch, port_materialize)
    _tiny_factories(monkeypatch, port_load_vid_mod)
    model = {k: v for k, v in RUN_CONFIG.items() if k != "type"}
    run = tmp_path / "run"
    saved = make_randinit_run.write_run_dir(run, device="cpu", seed=3, model=model)
    assert json.loads((run / "config.json").read_text()) == {"model": model}

    # the checkpoint: merv_tpu's projector and fusion leaves, by the bridge's names, with their shapes, in fp32
    ckpt = load_checkpoint(latest_checkpoint(run))["model"]
    shapes = jax.eval_shape(lambda: _jax_merv().init(jax.random.PRNGKey(0)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    want = module_state_dicts({k: zeros[k] for k in make_randinit_run.TRAINABLE})
    for key in make_randinit_run.TRAINABLE:
        assert {n: tuple(t.shape) for n, t in ckpt[key].items()} == {n: tuple(t.shape) for n, t in want[key].items()}
        assert all(t.dtype == torch.float32 for t in ckpt[key].values())
        _assert_same(ckpt[key], saved[key])

    vidlm = load_vid(run, device="cpu", allow_random_weights=True)
    _assert_same({k: v for k, v in vidlm.projectors.state_dict().items()}, saved["projectors"])
    _assert_same({k: v for k, v in vidlm.feature_fusion.state_dict().items()}, saved["feature_fusion"])

    again = make_randinit_run.write_run_dir(run, device="cpu", seed=3, model=model)  # written fresh, same seed
    _assert_same(again["projectors"], saved["projectors"])


def test_randinit_run_refuses_a_merv_tpu_checkpoint(tmp_path):
    orbax = tmp_path / "run" / "checkpoints" / "step-000001-epoch-00-loss=9.9000"
    orbax.mkdir(parents=True)
    (orbax / "_METADATA").write_text("{}")
    with pytest.raises(FileExistsError, match="Orbax"):
        make_randinit_run.write_run_dir(tmp_path / "run", device="cpu")
    assert (orbax / "_METADATA").exists()


# ---------------------------------------------------------------------------
# export_towers
# ---------------------------------------------------------------------------


def _export_factories(monkeypatch, towers):
    monkeypatch.setattr(export_towers.materialize, "get_video_backbone_and_transform",
                        lambda ids, *a, device=None, **k: ([towers[ids[0]]()], []))


def test_export_towers_round_trips_local_checkpoints(tmp_path, monkeypatch):
    """A dual-tower LanguageBind checkpoint and an original-layout Hiera .pth ->
    {identifier}.safetensors under their torch names, which both packages'
    load_pretrained_tower read to the same weights."""
    lb_state = {k: v for k, v in _languagebind_state().items()}
    lb_ckpt = tmp_path / "languagebind_video_merge.pt"
    torch.save({**lb_state, "text_model.embeddings.token_embedding.weight": torch.zeros(7, 4),
                "logit_scale": torch.ones(())}, lb_ckpt)
    jhiera, phiera, _ = _tiny_pair("hiera-base-plus-video")
    hiera_pth = tmp_path / "hiera.pth"
    hiera_state = _hiera_pth_state(phiera.hiera_config, np.random.RandomState(6))
    torch.save({"model_state": hiera_state}, hiera_pth)

    lb_id, hiera_id = TOWERS["languagebind"][2], "hiera-base-plus-video"
    made = {lb_id: lambda: _port_tower("languagebind"), hiera_id: lambda: _tiny_pair(hiera_id)[1]}
    _export_factories(monkeypatch, made)
    out = tmp_path / "towers"
    monkeypatch.setenv("MERV_TPU_TOWER_DIR", str(out))
    export_towers.main(["--out", str(out), "--towers", lb_id, hiera_id, "--source", f"languagebind={lb_ckpt}",
                        "--source", f"hiera={hiera_pth}", "--device", "cpu"])

    from safetensors.torch import load_file

    lb_file = load_file(out / f"{lb_id}.safetensors")
    assert sorted(lb_file) == sorted(k for k in lb_state if not k.endswith("position_ids"))
    assert not any(k.startswith("head.") for k in load_file(out / f"{hiera_id}.safetensors"))

    port_lb, jax_lb = made[lb_id](), _jax_tower("languagebind")
    load_pretrained_tower(port_lb)
    _assert_same_values(port_lb.vit.state_dict(),
                        state_dict_from_jax(_np_tree(jax_vision_import.load_pretrained_tower(jax_lb))))
    direct = made[lb_id]()
    direct.import_state_dict(lb_state)
    _assert_same(port_lb.vit.state_dict(), direct.vit.state_dict())

    port_h = made[hiera_id]()
    load_pretrained_tower(port_h)
    _assert_same_values(port_h.model.state_dict(),
                        state_dict_from_jax(_np_tree(jax_vision_import.load_pretrained_tower(jhiera))))


def test_export_towers_refuses_what_the_port_cannot_reach(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        export_towers.export_tower("dinov2-video-all-tokens", tmp_path, {}, online=False, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        export_towers.export_tower("languagebind-video-noclass", tmp_path, {}, online=True, device="cpu")
    with pytest.raises(FileNotFoundError, match="ROADMAP"):
        export_towers.export_tower("languagebind-video-noclass", tmp_path, {}, online=False, device="cpu")
    with pytest.raises(SystemExit, match="failed towers"):
        export_towers.main(["--out", str(tmp_path), "--towers", "siglip-vit-b16-224px-all-no-cls", "--device", "cpu"])


# ---------------------------------------------------------------------------
# preprocess
# ---------------------------------------------------------------------------


def test_preprocess_refuses_an_unknown_dataset_with_merv_tpus_message(tmp_path):
    with pytest.raises(ValueError) as want:
        jax_preprocess.preprocess(cfg=jax_preprocess.PreprocessConfig(dataset_id="no-such-set", root_dir=tmp_path))
    with pytest.raises(ValueError) as got:
        port_preprocess.preprocess(args=["--dataset_id", "no-such-set", "--root_dir", str(tmp_path)])
    assert str(got.value) == str(want.value)


def _local_llava_instruct(root):
    """llava-v1.5-instruct with every component already in place, and OCR-VQA images as PNG and GIF."""
    from PIL import Image

    base = root / "download" / "llava-v1.5-instruct"
    for comp in port_preprocess.download.DATASET_REGISTRY["llava-v1.5-instruct"]:
        target = base / comp["name"]
        if comp.get("extract"):
            target.mkdir(parents=True, exist_ok=True)
        else:
            target.parent.mkdir(parents=True, exist_ok=True)
            target.write_text("[]")
    rng = np.random.default_rng(0)
    images = base / "ocr_vqa" / "images"
    for i, suffix in enumerate((".png", ".gif", ".png")):
        Image.fromarray(rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)).save(images / f"{i}{suffix}")
    return images


def test_preprocess_converts_a_local_dataset_as_merv_tpu_does(tmp_path):
    want = _local_llava_instruct(tmp_path / "jax")
    got = _local_llava_instruct(tmp_path / "port")
    jax_preprocess.preprocess(cfg=jax_preprocess.PreprocessConfig(root_dir=tmp_path / "jax"))
    port_preprocess.preprocess(args=["--root_dir", str(tmp_path / "port")])
    assert sorted(p.name for p in got.iterdir()) == sorted(p.name for p in want.iterdir())
    assert sum(p.suffix == ".jpg" for p in got.iterdir()) == 3
    for p in want.iterdir():
        assert (got / p.name).read_bytes() == p.read_bytes(), p.name


# ---------------------------------------------------------------------------
# vidlm_prefix
# ---------------------------------------------------------------------------


def test_vidlm_prefix_main_runs_the_port_eval_command_per_mode(tmp_path, monkeypatch, capsys):
    """Each mode is one run of the port's eval_openended (here in process, on
    the tiny bench model) with merv_tpu's arguments; the line has
    scripts/bench_vidlm_prefix.py:108-121's keys."""
    ran = []

    def fake_load(src, get_model_cfg=False, allow_random_weights=False, quantize_llm=False, device=None):
        model = benchkit.make_bench_params(benchkit.build_model(2, tiny=True, device=device))
        if quantize_llm:
            quantize_tree(model.llm_backbone)
        return model, types.SimpleNamespace(num_frames=[4, 4, 4, 4])

    def in_process(args):
        ran.append(list(args))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            port_oe.evaluate(args=list(args))
        return subprocess.CompletedProcess(args, 0, out.getvalue(), "")

    (tmp_path / "eval_data").symlink_to(REPO / "eval_data")
    (tmp_path / "runs" / vidlm_prefix.RUN).mkdir(parents=True)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(vidlm_prefix, "ROOT", tmp_path)
    monkeypatch.setattr(vidlm_prefix, "_run_eval", in_process)
    monkeypatch.setattr(port_mcq, "load_vid", fake_load)
    monkeypatch.setenv("BENCH_VP_MAX_NEW", "2")
    vidlm_prefix.main(["--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    modes = list(vidlm_prefix.MODES)
    assert {"dataset", "max_new_tokens", "slots", "shared_vs_unshared", "shared_vs_group", *modes} <= set(out)
    assert out["device"] == "cpu" and out["max_new_tokens"] == 2
    for mode in modes:
        assert out[mode]["questions"] == 32 and out[mode]["questions_per_sec"] > 0 and out[mode]["passes"] == 2
        assert set(out[mode]["launches"]) >= {"small_attention_kt", "decode_attention"}
    assert out["engine_shared"]["prefix_admissions"] > 0 and out["engine_unshared"]["prefix_admissions"] == 0
    for args, mode in zip(ran, modes):
        pairs = dict(zip(args[::2], args[1::2]))
        assert pairs["--quantize_llm"] == pairs["--int8_kv"] == "true" and pairs["--serving_passes"] == "2"
        assert pairs["--device"] == "cpu" and pairs["--model_path"] == vidlm_prefix.RUN
    assert dict(zip(ran[0][::2], ran[0][1::2]))["--prefix_budget"] == "2"
    assert dict(zip(ran[2][::2], ran[2][1::2]))["--batch_size"] == "2"
