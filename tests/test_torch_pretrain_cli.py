"""The port's pretrain entry point (merv_tpu_torch.cli.pretrain) and its async
checkpoint save, against merv_tpu's (scripts/pretrain_video.py,
merv_tpu/training/checkpointing.py).

The CLI runs end to end on the CPU through its command line, on a tiny
dataset in ``tmp_path`` and a tiny model (a DINOv2-like and a SigLIP-like tower
and the tiny LLM, fp32 compute) whose weights are bridged from a merv_tpu init:
the registry factories are swapped for ones that build it. Held against
merv_tpu: config.json (its encoding of the same command line), the
checkpoint names and meta.json, and the first step's loss (merv_tpu's loss on
the same first batch with the same weights, towers cast to bf16 as both
strategies do; <= 1e-4 relative, the fp32 tolerance of tests/test_torch_training.py's
whole train steps). Then a finetune run discovers the align checkpoint, and a
third run resumes the finetune from its step-1 checkpoint: it skips the
consumed batch and ends on the straight run's weights (<= 1e-6, as
tests/test_torch_training.py holds a resume).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import merv_tpu.conf.registry as jax_draccus
import merv_tpu.training.checkpointing as jax_ckpt
import scripts.pretrain_video as ptv
import merv_tpu_torch.cli.pretrain as cli
import merv_tpu_torch.training.checkpointing as ckpt
from merv_tpu.models.backbones.llm.base_llm import tiny_llm_backbone as jax_tiny_llm
from merv_tpu.models.vidlms.merv import MERV as JaxMERV
from merv_tpu.preprocessing.datasets import AlignVideoDataset as JaxAlign
from merv_tpu.training.train_step import make_loss_fn as jax_make_loss_fn
from merv_tpu.util.batching_utils import EpochShardSampler as JaxEpochShardSampler
from merv_tpu.util.data_utils import PaddedCollatorForLanguageModeling as JaxCollator
from merv_tpu_torch.bridge import state_dict_from_jax
from merv_tpu_torch.models.backbones.llm.base_llm import tiny_llm_backbone
from merv_tpu_torch.models.materialize import get_vidlm
from test_torch_datasets import _write_dataset
from test_torch_merv import _jax_tower, _np_tree, _port_tower, _randomize_layerscale

TOWERS = ("dinov2", "siglip")
TOWER_IDS = ["dinov2-video-all-tokens", "siglip-vit-b16-224px-all-no-cls"]
MERV_KW = dict(arch_specifier="3davg+linear", feature_fusion="cross_attention_avg_lq",
               projector_token_length=4, visual_feature_length=16)
VOCAB = 320  # the ByteTokenizer's 290 ids (its pad is 289), past the tiny LLM's default 256
LOSS_REL_TOL = 1e-4
RESUME_TOL = 1e-6
CPU = "cpu"


def _jax_pair_params():
    """merv_tpu's tiny MERV and its init (LayerScale gammas randomised, as tests/test_torch_merv.py does)."""
    jm = JaxMERV("tiny-cli", [_jax_tower(n) for n in TOWERS], jax_tiny_llm(compute_dtype=jnp.float32, vocab_size=VOCAB),
                 **MERV_KW)
    return jm, _randomize_layerscale(_np_tree(jm.init(jax.random.PRNGKey(8))), np.random.RandomState(8))


@pytest.fixture
def tiny_factories(monkeypatch):
    """The CLI's registry factories swapped for ones that build the tiny
    model on the CPU with merv_tpu's weights; returns (merv_tpu model, its params)."""
    jm, params = _jax_pair_params()

    def towers(ids, strategy, num_frames, device=None, generator=None):
        assert list(ids) == TOWER_IDS and list(num_frames) == [4, 4]
        vbs = [_port_tower(n) for n in TOWERS]
        return vbs, [vb.get_video_transform() for vb in vbs]

    def llm(llm_id, llm_max_length=2048, device=None, generator=None):
        backbone = tiny_llm_backbone(compute_dtype=torch.float32, vocab_size=VOCAB, device=CPU)
        return backbone, backbone.tokenizer

    def vidlm(*args, **kw):
        model = get_vidlm(*args, **{**kw, "device": CPU, "generator": None})
        model.load_state_dict(state_dict_from_jax(params), strict=True)
        return model

    monkeypatch.setattr(cli, "get_video_backbone_and_transform", towers)
    monkeypatch.setattr(cli, "get_llm_backbone_and_tokenizer", llm)
    monkeypatch.setattr(cli, "get_vidlm", vidlm)
    monkeypatch.setattr(cli, "DATALOADER_WORKERS", 0)  # batches in this process: no worker processes in a test
    return jm, params


def _argv(root: Path, stage: str, run_id: str, *extra) -> list:
    """A command line for the tiny model: merv-full's config (an arch that takes its projectors from the align
    stage) with the tiny model's ids and sizes, 2 steps of global batch 4 (per-device 2: accumulation 2), a
    checkpoint every step."""
    return ["--model.type", "merv-full", "--model.model_id", "tiny-cli",
            "--model.video_backbone_ids", f"[{','.join(TOWER_IDS)}]", "--model.num_frames", "[4,4]",
            "--model.projector_token_length", "4", "--model.visual_feature_length", "16",
            "--model.align_max_steps", "2", "--model.align_global_batch_size", "4",
            "--model.align_per_device_batch_size", "2", "--model.align_learning_rate", "1e-3",
            "--model.finetune_max_steps", "2", "--model.finetune_global_batch_size", "4",
            "--model.finetune_per_device_batch_size", "2", "--model.finetune_learning_rate", "1e-3",
            "--dataset.dataset_root_dir", str(root), "--dataset.align_stage_components", "[align.json,media]",
            "--dataset.finetune_stage_components", "[chat.json,media]",
            "--stage", stage, "--run_id", run_id, "--run_root_dir", str(root / "runs"), "--seed", "7",
            "--save_checkpoint_after", "1", "--trackers", "[jsonl]", *extra]


PORT_ONLY = ("--device", "cpu")


def _logged(run_dir: Path, run_id: str, key: str) -> list:
    return [m[key] for m in map(json.loads, (run_dir / f"{run_id}.jsonl").read_text().splitlines())]


def _first_batch_loss(jm, params, root: Path) -> float:
    """merv_tpu's loss on the align run's first global batch: its dataset,
    collator and sampler order, its loss over the two micro-batches (mean),
    towers cast to bf16 as its strategy casts them."""
    transforms = [vb.get_video_transform() for vb in jm.video_backbones]
    ds = JaxAlign(root / "align.json", root / "media", root / "media", transforms, jm.llm_backbone.tokenizer,
                  num_frames=[4, 4])
    sampler = JaxEpochShardSampler(ds, seed=7)
    sampler.set_epoch(0)
    idx = list(sampler)[:4]
    res = [(4, tf.target_size, tf.target_size, 3) for tf in transforms]
    batch = JaxCollator(jm.llm_backbone.tokenizer.model_max_length, jm.llm_backbone.pad_token_id, res)(
        [ds[i] for i in idx])
    p = dict(params, video_backbones=jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                                            params["video_backbones"]))
    loss_fn = jax.jit(jax_make_loss_fn(jm, remat=False, video_transforms=transforms))
    losses = []
    for half in (slice(0, 2), slice(2, 4)):
        micro = {k: ([jnp.asarray(v[half]) for v in batch[k]] if k == "video_values" else jnp.asarray(batch[k][half]))
                 for k in ("input_ids", "attention_mask", "labels", "is_multimodal", "is_image", "video_values")}
        losses.append(float(loss_fn(p, micro)))
    return float(np.mean(losses))


def test_pretrain_cli_align_finetune_resume(tmp_path, tiny_factories):
    jm, params = tiny_factories
    _write_dataset(tmp_path)
    runs = tmp_path / "runs"

    # --- align: the run directory as merv_tpu lays it out ---------------------------------------------------
    align_id = "tiny-cli+x7+stage-align+x7"
    argv = _argv(tmp_path, "align", align_id)
    align = cli.pretrain(args=argv + list(PORT_ONLY))
    run_dir = runs / align_id
    theirs = jax_draccus.parse(ptv.PretrainConfig, args=argv)
    written = json.loads((run_dir / "config.json").read_text())
    assert written == json.loads(json.dumps({"model": jax_draccus.encode(theirs.model),
                                             "dataset": jax_draccus.encode(theirs.dataset)}, default=str))
    names = sorted(p.name for p in (run_dir / "checkpoints").iterdir() if p.name != "latest-checkpoint")
    losses = _logged(run_dir, align_id, "Align/Loss")
    assert _logged(run_dir, align_id, "Align/Step") == [1, 2] and all(np.isfinite(losses))
    assert [n.split("-loss=")[0] for n in names] == ["step-000001-epoch-00", "step-000002-epoch-00",
                                                     "step-000002-epoch-01"]
    assert ckpt.latest_checkpoint(run_dir).name == names[2] and ckpt._pending is None
    for name in names:
        meta = json.loads((run_dir / "checkpoints" / name / "meta.json").read_text())
        step, epoch = ckpt.parse_checkpoint_name(run_dir / "checkpoints" / name)
        assert meta == {"step": step, "epoch": epoch, "loss": meta["loss"], "module_keys": ["feature_fusion", "projectors"]}
        assert name == f"step-{step:06d}-epoch-{epoch:02d}-loss={meta['loss']:.4f}"
    assert [r["checkpoint"] for r in ckpt.ASYNC_SAVES[-2:]] == names[:2]  # the periodic saves went async
    assert (run_dir / "run-metrics.jsonl").exists()
    ref = _first_batch_loss(jm, params, tmp_path)
    assert abs(losses[0] - ref) <= LOSS_REL_TOL * abs(ref), (losses[0], ref)

    # --- finetune: the align checkpoint found beside the run ------------------------------------------------
    seen = {}
    load = cli.load_stage_weights

    def record(model, stage, run_dir, pretrained):
        load(model, stage, run_dir, pretrained)
        seen["projectors"] = {k: v.clone() for k, v in model.projectors.state_dict().items()}

    cli.load_stage_weights = record
    try:
        ft_id = "tiny-cli+x7+stage-finetune+x7"
        straight = cli.pretrain(args=_argv(tmp_path, "finetune", ft_id) + list(PORT_ONLY))
    finally:
        cli.load_stage_weights = load
    trained = ckpt.load_checkpoint(ckpt.latest_checkpoint(run_dir))["model"]["projectors"]
    assert seen["projectors"].keys() == trained.keys()
    assert all(torch.equal(seen["projectors"][k], trained[k]) for k in trained)
    ft_dir = runs / ft_id
    assert _logged(ft_dir, ft_id, "Finetune/Step") == [1, 2]
    step1 = next((ft_dir / "checkpoints").glob("step-000001-epoch-00-*"))
    assert json.loads((step1 / "meta.json").read_text())["module_keys"] == ["feature_fusion", "llm_backbone",
                                                                            "projectors"]

    # --- resume the finetune from its step-1 checkpoint: the consumed batch skipped, the same end -----------
    res_id = "tiny-cli+resumed+stage-finetune+x7"
    resumed = cli.pretrain(args=_argv(tmp_path, "finetune", res_id, "--pretrained_checkpoint",
                                      str(ckpt.latest_checkpoint(run_dir)), "--resume_from_checkpoint", str(step1))
                           + list(PORT_ONLY))
    assert resumed._resume_step == 1 and resumed.tx.count == straight.tx.count == 2
    assert _logged(runs / res_id, res_id, "Finetune/Step") == [2]
    for (n, a), b in zip(straight.vidlm.named_parameters(), resumed.vidlm.parameters()):
        torch.testing.assert_close(b, a, rtol=0, atol=RESUME_TOL, msg=n)
    assert align.vidlm.trainable_module_keys == ["projectors", "feature_fusion"]


@pytest.mark.parametrize("stage", ["align", "full-align", "second_align", "finetune", "full-finetune",
                                   "second_finetune", "bogus"])
def test_stage_recipes_match_merv_tpu(stage):
    """Each stage takes its recipe from the model config as merv_tpu's
    PretrainConfig does; an unknown stage raises in both."""
    if stage == "bogus":
        for cls in (cli.PretrainConfig, ptv.PretrainConfig):
            with pytest.raises(ValueError, match="not supported"):
                cls(stage=stage)
        return
    ours, theirs = cli.PretrainConfig(stage=stage), ptv.PretrainConfig(stage=stage)
    for name in ("epochs", "max_steps", "global_batch_size", "per_device_batch_size", "learning_rate",
                 "weight_decay", "max_grad_norm", "lr_scheduler_type", "warmup_ratio", "train_strategy"):
        assert getattr(ours, name) == getattr(theirs, name), name


@pytest.mark.parametrize("flag", ["--mesh_seq", "--mesh_pipe"])
def test_pretrain_refuses_the_parallel_options(flag):
    """Each option trains under torchrun (tests/test_torch_parallel_training.py);
    in one process an axis of 2 has no ranks to cover it, and both at once
    raise merv_tpu's ValueError."""
    with pytest.raises(ValueError, match="not divisible by fixed axes"):
        cli.pretrain(args=["--stage", "align", flag, "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="mutually exclusive"):
        cli.pretrain(args=["--stage", "align", "--mesh_seq", "2", "--mesh_pipe", "2", "--device", "cpu"])


def test_pretrain_runs_on_the_card_unless_asked(monkeypatch, tmp_path):
    """Without a GPU the entry point raises (naming device='cpu') before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.pretrain(args=["--stage", "align", "--run_root_dir", str(tmp_path / "runs")])
    assert not (tmp_path / "runs").exists()


# ---------------------------------------------------------------------------
# The async save (training/checkpointing.py)
# ---------------------------------------------------------------------------


def _tiny_model():
    model = torch.nn.Module()
    model.projectors = torch.nn.Linear(4, 3)
    model.feature_fusion = torch.nn.Linear(3, 2)
    model.llm_backbone = torch.nn.Linear(2, 2)
    return model


def _optimizer(model):
    opt = torch.optim.AdamW(model.parameters(), lr=0.1)
    sum(p.sum() for p in model.parameters()).backward()
    opt.step()
    return opt


def test_async_save_round_trip(tmp_path):
    """The async save returns before meta.json and the pointer exist; after
    the wait both do, and the checkpoint holds the state as it was at the
    call (the model is changed in place meanwhile), the optimizer's too."""
    model = _tiny_model()
    opt = _optimizer(model)
    want = {k: v.clone() for k, v in model.projectors.state_dict().items()}
    want_opt = {k: {n: v.clone() for n, v in s.items()} for k, s in opt.state_dict()["state"].items()}
    target = ckpt.save_checkpoint(tmp_path, 3, 0, 1.5, model, ["projectors", "feature_fusion"], optimizer=opt,
                                  blocking=False)
    assert not (target / "meta.json").exists() and ckpt.latest_checkpoint(tmp_path) is None
    with torch.no_grad():
        model.projectors.weight.add_(1.0)
    opt.step()
    ckpt.wait_for_checkpoints()
    assert ckpt._pending is None and ckpt.latest_checkpoint(tmp_path) == target.resolve()
    restored = ckpt.load_checkpoint(target)
    assert restored["step"] == 3 and restored["epoch"] == 0 and set(restored["model"]) == {"projectors", "feature_fusion"}
    assert all(torch.equal(restored["model"]["projectors"][k], v) for k, v in want.items())
    for k, s in want_opt.items():
        assert all(torch.equal(restored["optimizer"]["state"][k][n], v) for n, v in s.items())
    assert ckpt.ASYNC_SAVES[-1]["checkpoint"] == target.name and ckpt.ASYNC_SAVES[-1]["waited_s"] >= 0


def test_async_layout_matches_merv_tpu(tmp_path):
    """The same save in both packages, async, then waited for: the same
    directory name, the same meta.json, the same pointer."""
    jm, params = _jax_pair_params()
    ours = ckpt.save_checkpoint(tmp_path / "ours", 5, 1, 0.25, _tiny_model(), ["projectors", "feature_fusion"],
                                blocking=False)
    theirs = jax_ckpt.save_checkpoint(tmp_path / "theirs", 5, 1, 0.25, params, ["projectors", "feature_fusion"],
                                      blocking=False)
    ckpt.wait_for_checkpoints()
    jax_ckpt.wait_for_checkpoints()
    assert ours.name == theirs.name
    assert json.loads((ours / "meta.json").read_text()) == json.loads((theirs / "meta.json").read_text())
    assert ckpt.latest_checkpoint(tmp_path / "ours").name == jax_ckpt.latest_checkpoint(tmp_path / "theirs").name


def test_pointer_never_moves_backward(tmp_path):
    """A save first finishes the one in flight: an async step-1 save, an async
    step-2 save, then a blocking end-of-epoch save leave the pointer on the
    last, every directory committed, whatever waits come after."""
    model = _tiny_model()
    one = ckpt.save_checkpoint(tmp_path, 1, 0, 2.0, model, ["projectors"], blocking=False)
    two = ckpt.save_checkpoint(tmp_path, 2, 0, 1.0, model, ["projectors"], blocking=False)
    assert (one / "meta.json").exists() and not (two / "meta.json").exists()
    assert ckpt.latest_checkpoint(tmp_path) == one.resolve()
    end = ckpt.save_checkpoint(tmp_path, 2, 1, 1.0, model, ["projectors"])
    assert (two / "meta.json").exists() and ckpt.latest_checkpoint(tmp_path) == end.resolve()
    ckpt.wait_for_checkpoints()
    assert ckpt.latest_checkpoint(tmp_path) == end.resolve()


def test_latest_checkpoint_ignores_torn_dirs(tmp_path):
    """A directory without meta.json (a write that did not finish) is never
    picked, with or without the pointer, in both packages."""
    model = _tiny_model()
    good = ckpt.save_checkpoint(tmp_path, 1, 0, 2.0, model, ["projectors"])
    (tmp_path / "checkpoints" / "step-000002-epoch-00-loss=1.0000").mkdir()
    (tmp_path / "checkpoints" / "step-000003-epoch-00-loss=0.9000").mkdir()
    (tmp_path / "checkpoints" / "step-000003-epoch-00-loss=0.9000" / ckpt.CKPT_FILE).write_bytes(b"torn")
    assert ckpt.latest_checkpoint(tmp_path).name == good.name
    (tmp_path / "checkpoints" / "latest-checkpoint").unlink()
    assert ckpt.latest_checkpoint(tmp_path).name == good.name == jax_ckpt.latest_checkpoint(tmp_path).name


def test_a_failed_async_write_raises_and_commits_nothing(tmp_path, monkeypatch):
    model = _tiny_model()
    good = ckpt.save_checkpoint(tmp_path, 1, 0, 2.0, model, ["projectors"])

    def fail(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", fail)
    bad = ckpt.save_checkpoint(tmp_path, 2, 0, 1.0, model, ["projectors"], blocking=False)
    with pytest.raises(RuntimeError, match="async write"):
        ckpt.wait_for_checkpoints()
    assert not (bad / "meta.json").exists() and ckpt.latest_checkpoint(tmp_path) == good.resolve()
