"""The port's training path (merv_tpu_torch.training, util, the losses) against merv_tpu's.

Inputs and weights come from numpy seeds (the weights from a merv_tpu init,
carried over by merv_tpu_torch.bridge) and go through both packages, all in
fp32 on the CPU. Tolerances: the schedule and the optimizer <= 1e-6 (same
formulas, fp32 rounding), the losses <= 1e-5, a whole train step <= 1e-4 (as
tests/test_torch_merv.py holds the forward: towers, 2 decoder layers and the
loss accumulate rounding in another order). The collator and the samplers
must agree exactly; frozen parameters must not move by a bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merv_tpu.models.backbones.llm.transformer import LlamaDecoder as JaxDecoder
from merv_tpu.models.backbones.llm.transformer import tiny_decoder_config as jax_tiny_decoder
from merv_tpu.models.vidlms.merv import causal_lm_loss as jax_causal_lm_loss
from merv_tpu.models.vidlms.merv import chunked_causal_lm_loss as jax_chunked_loss
from merv_tpu.preprocessing.transforms import VideoTransform as JaxVideoTransform
from merv_tpu.training.optimizers import build_optimizer as jax_build_optimizer
from merv_tpu.training.optimizers import build_schedule as jax_build_schedule
from merv_tpu.training.train_step import TrainState
from merv_tpu.training.train_step import make_loss_fn as jax_make_loss_fn
from merv_tpu.training.train_step import make_train_step as jax_make_train_step
from merv_tpu.util.batching_utils import EpochShardSampler as JaxEpochShardSampler
from merv_tpu.util.batching_utils import SplitModalitySampler as JaxSplitModalitySampler
from merv_tpu.util.data_utils import PaddedCollatorForLanguageModeling as JaxCollator
from merv_tpu_torch.bridge import state_dict_from_jax
from merv_tpu_torch.device import make_generator
from merv_tpu_torch.models.backbones.llm.base_llm import tiny_llm_backbone
from merv_tpu_torch.models.backbones.llm.transformer import LlamaDecoder, tiny_decoder_config
from merv_tpu_torch.models.vidlms import MERV
from merv_tpu_torch.models.vidlms.merv import causal_lm_loss, chunked_causal_lm_loss
from merv_tpu_torch.nn.core import init_weights
from merv_tpu_torch.preprocessing.transforms import VideoTransform
from merv_tpu_torch.training import Metrics, get_train_strategy
from merv_tpu_torch.training.checkpointing import latest_checkpoint, load_checkpoint, load_stage_weights
from merv_tpu_torch.training.optimizers import build_optimizer, build_schedule
from merv_tpu_torch.training.train_step import make_loss_fn, make_train_step
from merv_tpu_torch.util.batching_utils import EpochShardSampler, SplitModalitySampler
from merv_tpu_torch.util.data_utils import PaddedCollatorForLanguageModeling
from test_torch_merv import MERV_TOWERS, _merv_pair, _port_tower

OPT_TOL = dict(atol=1e-6, rtol=1e-6)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
CPU = "cpu"


@pytest.mark.parametrize("kind", ["linear-warmup+cosine-decay", "constant"])
def test_schedule_matches_optax(kind):
    ref = jax_build_schedule(kind, 1e-3, 50, 0.1)
    sched = build_schedule(kind, 1e-3, 50, 0.1)
    got = np.array([sched(s) for s in range(50)])
    np.testing.assert_allclose(got, np.array([float(ref(s)) for s in range(50)]), **OPT_TOL)
    assert got[0] == (0.0 if kind != "constant" else 1e-3)


def test_optimizer_matches_optax():
    """5 clipped AdamW steps on the same gradients: the clip is active (norm
    above 0.5), decay skips the bias and the 1-D scale, the frozen leaf gets
    no state and does not move."""
    rng = np.random.RandomState(0)
    shapes = {"w": (6, 4), "bias": (4,), "scale": (4,), "frozen": (3, 3)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    mask = {k: k != "frozen" for k in shapes}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(5)]
    for g in grads:  # merv_tpu's step hands a masked leaf a zero gradient (optax.masked passes it through)
        g["frozen"][:] = 0.0

    sched = jax_build_schedule("linear-warmup+cosine-decay", 1e-2, 5, 0.2)
    tx = jax_build_optimizer(init, sched, 0.1, 0.5, trainable_mask=mask)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(params)

    named = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    ptx = build_optimizer(named, build_schedule("linear-warmup+cosine-decay", 1e-2, 5, 0.2), 0.1, 0.5, mask)
    assert [n for n in ptx.named_params] == ["w", "bias", "scale"]
    for step, g in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        for k, p in ptx.named_params.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = ptx.step()
        expect = np.sqrt(sum(np.square(g[k]).sum() for k in ptx.named_params))
        np.testing.assert_allclose(norm.item(), expect, **OPT_TOL)
        for k, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), **OPT_TOL, err_msg=f"{k} step {step}")
        if step == 0:  # the first update runs at lr 0
            np.testing.assert_array_equal(named["w"].detach().numpy(), init["w"])
    np.testing.assert_array_equal(named["frozen"].detach().numpy(), init["frozen"])


def _instances(rng, n, resolutions, text_only=(), max_len=40):
    out = []
    for i in range(n):
        T = int(rng.randint(5, max_len + 8))
        ids = rng.randint(3, 250, size=T).astype(np.int32)
        labels = ids.copy()
        labels[0] = -100
        vids = [None if i in text_only else rng.randint(0, 256, size=r).astype(np.uint8) for r in resolutions]
        out.append(dict(input_ids=ids, labels=labels, video_values=vids, is_image=bool(i % 3 == 0)))
    return out


@pytest.mark.parametrize("pad_to_max_length", [True, False])
def test_collator_matches_jax(pad_to_max_length):
    res = [(2, 8, 8, 3), (4, 6, 6, 3)]
    inst = _instances(np.random.RandomState(1), 5, res, text_only=(2,))
    ref = JaxCollator(40, 0, res, pad_to_max_length=pad_to_max_length)(inst)
    out = PaddedCollatorForLanguageModeling(40, 0, res, pad_to_max_length=pad_to_max_length)(inst)
    assert set(out) == set(ref)
    for key in ref:
        if key == "video_values":
            for a, b in zip(out[key], ref[key]):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
        else:
            np.testing.assert_array_equal(out[key], ref[key])
            assert out[key].dtype == ref[key].dtype, key


@pytest.mark.parametrize("epoch", [0, 3])
def test_samplers_match_jax(epoch):
    data = list(range(24))
    lengths = [(i % 3 != 0, int(n)) for i, n in enumerate(np.random.RandomState(2).randint(5, 90, 24))]
    for replicas, rank in ((1, 0), (2, 1)):
        ref = JaxSplitModalitySampler(data, lengths, global_batch_size=8, num_replicas=replicas, rank=rank, seed=5)
        got = SplitModalitySampler(data, lengths, global_batch_size=8, num_replicas=replicas, rank=rank, seed=5)
        ref.set_epoch(epoch)
        got.set_epoch(epoch)
        assert list(got) == list(ref) and len(got) == len(ref)
        ref = JaxEpochShardSampler(data[:23], num_replicas=replicas, rank=rank, seed=5)
        got = EpochShardSampler(data[:23], num_replicas=replicas, rank=rank, seed=5)
        ref.set_epoch(epoch)
        got.set_epoch(epoch)
        assert list(got) == list(ref) and len(got) == len(ref)


@pytest.mark.parametrize("block", [None, 4, 32])
def test_losses_match_jax(block):
    """causal_lm_loss (block None) and chunked_causal_lm_loss (a ragged last
    block of 13 tokens at block 4, one block at 32): value and the gradients
    with respect to the hidden states and the lm_head, <= 1e-5."""
    jdec = JaxDecoder(jax_tiny_decoder(compute_dtype=jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, jdec.init(jax.random.PRNGKey(3)))
    dec = LlamaDecoder(tiny_decoder_config(compute_dtype=torch.float32), device=CPU)
    dec.load_state_dict(state_dict_from_jax(params), strict=True)
    rng = np.random.RandomState(4)
    hidden = rng.randn(2, 13, 64).astype(np.float32)
    labels = rng.randint(0, 256, size=(2, 13)).astype(np.int32)
    labels[0, :3] = -100
    labels[1, 9:] = -100

    def jax_loss(h, head):
        p = dict(params, lm_head=head)
        if block is None:
            return jax_causal_lm_loss(jdec.lm_head_apply(p, h), jnp.asarray(labels))
        return jax_chunked_loss(jdec, p, h, jnp.asarray(labels), block=block)

    ref, (ref_dh, ref_dhead) = jax.value_and_grad(jax_loss, argnums=(0, 1))(jnp.asarray(hidden), params["lm_head"])
    h = torch.from_numpy(hidden).requires_grad_()
    dec.lm_head.weight.requires_grad_(True)
    t_labels = torch.from_numpy(labels).long()
    if block is None:
        loss = causal_lm_loss(dec.lm_head_apply(h), t_labels)
    else:
        loss = chunked_causal_lm_loss(dec, h, t_labels, block=block)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), **LOSS_TOL)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(ref_dh), **LOSS_TOL)
    np.testing.assert_allclose(dec.lm_head.weight.grad.numpy(), np.asarray(ref_dhead["kernel"]).T, **LOSS_TOL)


@pytest.mark.parametrize("channels_first_time", [False, True])
def test_device_finish_matches_jax(channels_first_time):
    x = np.random.RandomState(5).randint(0, 256, size=(2, 3, 8, 8, 3)).astype(np.uint8)
    kw = dict(target_size=8, channels_first_time=channels_first_time)
    ref = np.asarray(JaxVideoTransform(**kw).device_finish(jnp.asarray(x)))
    out = VideoTransform(**kw).device_finish(torch.from_numpy(x))
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# MERV: gradients and whole train steps against merv_tpu
# ---------------------------------------------------------------------------


def _merv_batch(rng, pm, B=4, T=8):
    """B rows of T tokens: one right-padded row, one text-only row; labels
    ignore the padding and the first token; float videos at the towers' shapes."""
    ids = rng.randint(3, 250, size=(B, T)).astype(np.int32)
    ids[:, 0] = 1
    mask = np.ones((B, T), np.int32)
    ids[1, T - 3:], mask[1, T - 3:] = 0, 0
    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    labels[:, 0] = -100
    is_mm = np.ones(B, bool)
    is_mm[2] = False
    vids = [rng.randn(B, *vb.default_video_resolution).astype(np.float32) for vb in pm.video_backbones]
    return dict(input_ids=ids, attention_mask=mask, labels=labels, is_multimodal=is_mm, video_values=vids)


def _to_torch_batch(b):
    out = {k: torch.from_numpy(v) for k, v in b.items() if k != "video_values"}
    out["input_ids"], out["labels"] = out["input_ids"].long(), out["labels"].long()
    out["video_values"] = [torch.from_numpy(v) for v in b["video_values"]]
    return out


def _to_jax_batch(b, accum):
    def prep(x):
        x = jnp.asarray(x)
        return x if accum == 1 else x.reshape(accum, x.shape[0] // accum, *x.shape[1:])

    return {k: ([prep(v) for v in b[k]] if k == "video_values" else prep(b[k])) for k in b}


def test_merv_forward_is_differentiable():
    """The loss's gradient with respect to the projectors and the fusion
    equals jax.grad of merv_tpu's MERV.forward (towers frozen)."""
    jm, pm, params = _merv_pair()
    pm.freeze_backbones("align")
    b = _merv_batch(np.random.RandomState(6), pm)
    jb = _to_jax_batch(b, 1)

    def jax_loss(trainable):
        p = dict(params, **trainable)
        return jm.forward(p, jb["input_ids"], jb["attention_mask"], jb["video_values"], labels=jb["labels"],
                          is_multimodal=jb["is_multimodal"])["loss"]

    trainable = {k: params[k] for k in ("projectors", "feature_fusion")}
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_loss))(trainable)
    tb = _to_torch_batch(b)
    out = pm.forward(tb["input_ids"], tb["attention_mask"], tb["video_values"], labels=tb["labels"],
                     is_multimodal=tb["is_multimodal"])
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), float(ref_loss), **STEP_TOL)
    ref_named = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads))
    for name, p in pm.named_parameters():
        if name.split(".")[0] in trainable:  # no .grad where the loss does not reach (the fusion's values): 0
            grad = torch.zeros_like(p) if p.grad is None else p.grad
            np.testing.assert_allclose(grad.numpy(), ref_named[name].numpy(), **STEP_TOL, err_msg=name)
        else:
            assert p.grad is None and not p.requires_grad, name


# (stage, steps, accumulation, learning rate, weight decay, clip, remat in the port)
STEP_CASES = {
    "align": ("align", 3, 2, 1e-3, 0.0, 1.0, False),
    "align_remat": ("align", 3, 2, 1e-3, 0.0, 1.0, True),
    "finetune": ("finetune", 2, 1, 2e-5, 0.1, 0.5, False),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax(case):
    """make_train_step + build_optimizer against merv_tpu's (jitted without
    shardings, one CPU device) on the same weights and batches: per-step loss and grad norm, then every
    trainable parameter (<= 1e-4); frozen parameters bit-identical; the first
    step (lr 0) leaves the trainables unchanged. The remat case checkpoints
    each decoder layer in the port (merv_tpu without), so it also holds remat
    on against remat off."""
    stage, steps, accum, lr, wd, clip, remat = STEP_CASES[case]
    jm, pm, params = _merv_pair()
    jm.freeze_backbones(stage)
    pm.freeze_backbones(stage)
    mask = jm.trainable_mask(params)
    tx = jax_build_optimizer(params, jax_build_schedule("linear-warmup+cosine-decay", lr, steps), wd, clip,
                             trainable_mask=mask)
    jstep = jax.jit(jax_make_train_step(jax_make_loss_fn(jm, remat=False), tx, grad_accumulation_steps=accum,
                                        trainable_mask=mask))
    state = TrainState(jax.tree_util.tree_map(jnp.asarray, params), tx.init(params), jnp.zeros((), jnp.int32))

    ptx = build_optimizer(dict(pm.named_parameters()), build_schedule("linear-warmup+cosine-decay", lr, steps), wd,
                          clip, trainable_mask=pm.trainable_mask())
    pstep = make_train_step(make_loss_fn(pm, remat=remat), ptx, grad_accumulation_steps=accum)
    before = {n: p.detach().clone() for n, p in pm.named_parameters()}
    trainable = pm.trainable_mask()
    assert any(trainable.values()) and not all(trainable.values())

    rng = np.random.RandomState(7)
    for step in range(steps):
        b = _merv_batch(rng, pm)
        state, ref = jstep(state, _to_jax_batch(b, accum))
        got = pstep(_to_torch_batch(b))
        assert got["step"] == int(ref["step"]) == step + 1
        np.testing.assert_allclose(got["loss"].item(), float(ref["loss"]), **STEP_TOL)
        np.testing.assert_allclose(got["grad_norm"].item(), float(ref["grad_norm"]), **STEP_TOL)
        if step == 0:
            for n, p in pm.named_parameters():
                assert torch.equal(p.detach(), before[n]), f"{n} moved at lr 0"

    ref_params = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params))
    for n, p in pm.named_parameters():
        if trainable[n]:
            np.testing.assert_allclose(p.detach().numpy(), ref_params[n].numpy(), **STEP_TOL, err_msg=n)
        else:
            assert torch.equal(p.detach(), before[n]), f"frozen {n} moved"
    moved = [n for n, p in pm.named_parameters() if trainable[n] and not torch.equal(p.detach(), before[n])]
    assert moved, "no trainable parameter moved"


# ---------------------------------------------------------------------------
# The strategy: setup, loop, checkpoints, resume (port only)
# ---------------------------------------------------------------------------


class _CaptionDataset:
    """In memory, with AlignVideoDataset's item contract: uint8 frames at each
    tower's geometry, a tokenized caption and its labels (first token ignored)."""

    def __init__(self, n, resolutions, tokenizer, seed=0):
        rng = np.random.RandomState(seed)
        words = ["red", "ball", "moves", "left", "a", "cat", "jumps", "over", "the", "box"]
        self.items = []
        for _ in range(n):
            caption = " ".join(rng.choice(words, size=rng.randint(3, 8)))
            ids = np.asarray(tokenizer(caption + tokenizer.eos_token, truncation=True).input_ids, np.int32)
            labels = ids.copy()
            labels[0] = -100
            vids = [rng.randint(0, 256, size=r).astype(np.uint8) for r in resolutions]
            self.items.append(dict(video_values=vids, input_ids=ids, labels=labels, is_image=False))

    def __getitem__(self, i):
        return self.items[i]

    def __len__(self):
        return len(self.items)


def _tiny_port_merv(seed=11):
    pm = MERV("tiny-merv", [_port_tower(n) for n in MERV_TOWERS], tiny_llm_backbone(device=CPU),
              arch_specifier="no-align+3davg+linear", feature_fusion="cross_attention_avg_lq",
              projector_token_length=4, visual_feature_length=16, text_embedding_dim=32, device=CPU)
    init_weights(pm, make_generator(torch.device(CPU), seed))
    pm.freeze_backbones("align")
    return pm


def _train(run_dir, max_steps, resume=None):
    pm = _tiny_port_merv()
    transforms = [vb.get_video_transform() for vb in pm.video_backbones]
    res = [(vb.num_frames, tf.target_size, tf.target_size, 3) for vb, tf in zip(pm.video_backbones, transforms)]
    ds = _CaptionDataset(12, res, pm.llm_backbone.tokenizer)
    collator = PaddedCollatorForLanguageModeling(24, pm.llm_backbone.pad_token_id, res)
    strategy = get_train_strategy("fsdp-shard-grad-op", pm, stage="align", epochs=1, max_steps=max_steps,
                                  global_batch_size=4, per_device_batch_size=2, learning_rate=1e-3,
                                  weight_decay=0.0, max_grad_norm=1.0, save_checkpoint_after=1, loss_chunk_size=8)
    run_dir.mkdir()
    strategy.run_setup(run_dir, n_train_examples=len(ds), video_transforms=transforms, resume_from_checkpoint=resume,
                       seed=0)
    metrics = Metrics(("jsonl",), "run", run_dir, {"lr": 1e-3}, "align", grad_accumulation_steps=2, total_steps=3)
    timings = []
    strategy.run_training(ds, collator, metrics, stage="align", seed=0, run_dir=run_dir, num_workers=0,
                          step_timings=timings)
    metrics.finalize()
    return pm, strategy, timings


def test_strategy_resume_matches_straight_run(tmp_path):
    """3 straight steps (accumulation 2, a checkpoint every step) against 2
    steps, a resume from the step-2 checkpoint and 1 more step: the same
    trainables and optimizer count; the JSONL metrics and the checkpoints
    are written; the towers are stored in bf16."""
    straight, s1, timings = _train(tmp_path / "a", 3)
    assert s1.grad_accumulation_steps == 2 and len(timings) == 3
    assert all(t["step_s"] > 0 and {"towers_s", "llm_s", "optimizer_s"} <= set(t) for t in timings)
    assert all(np.isfinite(t["loss"]) and t["grad_norm"] > 0 for t in timings)
    assert all(p.dtype == torch.bfloat16 for vb in straight.video_backbones for p in vb.parameters())
    logged = [json.loads(x) for x in (tmp_path / "a" / "run.jsonl").read_text().splitlines()]
    assert [m["Align/Step"] for m in logged] == [1, 2, 3] and all(np.isfinite(m["Align/Loss"]) for m in logged)
    step2 = next((tmp_path / "a" / "checkpoints").glob("step-000002-epoch-00-*"))
    assert load_checkpoint(step2)["step"] == 2 and load_checkpoint(latest_checkpoint(tmp_path / "a"))["step"] == 3

    resumed, s2, timings = _train(tmp_path / "b", 3, resume=step2)
    assert s2._resume_step == 2 and len(timings) == 1 and s2.tx.count == s1.tx.count == 3
    for (n, a), b in zip(straight.named_parameters(), resumed.parameters()):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6, msg=n)

    fresh = _tiny_port_merv()  # the finetune hand-off loads the align projectors by module key
    load_stage_weights(fresh, "second_align", tmp_path, pretrained_checkpoint=latest_checkpoint(tmp_path / "a"))
    for a, b in zip(straight.projectors.parameters(), fresh.projectors.parameters()):
        assert torch.equal(a, b)


def test_strategy_refuses_fp32_compute():
    """The port computes in bf16 only: asking for full-precision training raises
    rather than being ignored."""
    with pytest.raises(NotImplementedError):
        get_train_strategy("ddp", _tiny_port_merv(), stage="align", global_batch_size=4, per_device_batch_size=2,
                           enable_mixed_precision_training=False)
