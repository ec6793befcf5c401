"""Multi-rank training of the port (merv_tpu_torch/parallel/sharding.py and
pipeline.py, training/train_step.py's sharding, the strategies, the sharded
checkpoints, cli/pretrain.py's --mesh_seq / --mesh_pipe, cli/memory_proof.py)
against merv_tpu's on the same numpy-seeded inputs, fp32 on the CPU.

The placements and the micro-batch rule are compared directly; the
in-process pipeline (``VirtualMesh``) against merv_tpu's on its virtual
devices; one spawned gloo world of 4 trains one step (accumulation 2) under
fsdp-full-shard, fsdp-shard-grad-op, ddp, fsdp 2 x sp 2 and fsdp 2 x pp 2,
each held against merv_tpu's ``make_train_step`` + ``jit_train_step`` on the
same mesh shape within ``STEP_TOL`` (loss, grad norm, every updated
trainable) on a batch whose data ranks hold unequal label counts, and each
checkpoint (written from the sharded state) loaded at world 1; one spawned
world of 2 runs the pretrain CLI at --mesh_seq 2 and --mesh_pipe 2 with a
resume, against the same runs at world 1. Rank bodies are in
tests/torch_sp_workers.py (no JAX there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import merv_tpu.parallel.pipeline as JP
import merv_tpu.parallel.sharding as JS
import merv_tpu_torch.parallel.pipeline as PP
import merv_tpu_torch.parallel.sharding as PS
import torch_sp_workers
from merv_tpu.models.backbones.llm.base_llm import tiny_llm_backbone as jax_tiny_llm
from merv_tpu.models.backbones.llm.transformer import LlamaDecoder as JaxDecoder
from merv_tpu.models.backbones.llm.transformer import tiny_decoder_config as jax_tiny_decoder
from merv_tpu.models.vidlms.merv import MERV as JaxMERV
from merv_tpu.parallel import MeshConfig as JaxMeshConfig
from merv_tpu.parallel import build_mesh as jax_build_mesh
from merv_tpu.parallel.sharding import activation_mesh as jax_activation_mesh
from merv_tpu.training.optimizers import build_optimizer as jax_build_optimizer
from merv_tpu.training.optimizers import build_schedule as jax_build_schedule
from merv_tpu.training.train_step import TrainState, jit_train_step, shard_train_state
from merv_tpu.training.train_step import make_loss_fn as jax_make_loss_fn
from merv_tpu.training.train_step import make_train_step as jax_make_train_step
from merv_tpu_torch.bridge import state_dict_from_jax
from merv_tpu_torch.models.backbones.llm.base_llm import tiny_llm_backbone
from merv_tpu_torch.models.backbones.llm.transformer import LlamaDecoder, tiny_decoder_config
from merv_tpu_torch.models.vidlms import MERV
from merv_tpu_torch.nn.core import init_weights
from merv_tpu_torch.parallel import VirtualMesh, activation_mesh
from merv_tpu_torch.training import get_train_strategy
from merv_tpu_torch.training.checkpointing import latest_checkpoint, load_checkpoint
from test_torch_merv import MERV_TOWERS, _jax_tower, _np_tree, _port_tower, _randomize_layerscale
from test_torch_ring_attention import spawn_world
from test_torch_training import STEP_TOL

CPU = "cpu"
MERV_KW = dict(arch_specifier="no-align+3davg+linear", feature_fusion="cross_attention_avg_lq",
               projector_token_length=4, visual_feature_length=16, text_embedding_dim=32)


def _pair(**llm):
    """merv_tpu's tiny MERV with its init, and the port's with the same weights (fp32)."""
    jm = JaxMERV("tiny-merv", [_jax_tower(n) for n in MERV_TOWERS], jax_tiny_llm(compute_dtype=jnp.float32, **llm),
                 **MERV_KW)
    pm = MERV("tiny-merv", [_port_tower(n) for n in MERV_TOWERS],
              tiny_llm_backbone(compute_dtype=torch.float32, device=CPU, **llm), device=CPU, **MERV_KW)
    params = _randomize_layerscale(_np_tree(jm.init(jax.random.PRNGKey(8))), np.random.RandomState(8))
    pm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, pm, params


def _flat_specs(tree):
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]:
        out[JS.path_str(path)] = tuple(spec)
    return out


class _Shape:
    """A mesh as both packages' fsdp_specs read it: its axis sizes (merv_tpu's
    ``shape``; a DeviceMesh's ``mesh_dim_names`` and ``size``)."""

    def __init__(self, **shape):
        self.shape = shape
        self.mesh_dim_names = tuple(shape)

    def size(self, dim):
        return self.shape[self.mesh_dim_names[dim]]


# ---------------------------------------------------------------------------
# Placements and the micro-batch rule
# ---------------------------------------------------------------------------

MESHES = {"fsdp4": dict(fsdp=4), "fsdp2_pp2": dict(fsdp=2, pp=2), "fsdp8": dict(fsdp=8)}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("min_weight_size", [64, 2 ** 16])
def test_fsdp_specs_match_merv_tpu(mesh, min_weight_size):
    """Every parameter of the tiny MERV gets merv_tpu's spec (names through
    the bridge's layout: Linear weights transposed, layer stacks sliced)."""
    jm, pm, params = _pair()
    shape = dict(data=1, tensor=1, sp=1, **MESHES[mesh])
    want = _flat_specs(JS.fsdp_specs(params, _Shape(**shape), min_weight_size=min_weight_size))
    leaves = PS.jax_leaves(pm)
    got = PS.fsdp_specs(pm, _Shape(**shape), min_weight_size=min_weight_size)
    flat = {JS.path_str(p): np.shape(v) for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert {leaf.path for leaf in leaves.values()} == set(want)
    for name, spec in got.items():
        leaf = leaves[name]
        assert flat[leaf.path] == leaf.shape, name
        assert spec == want[leaf.path], name
    sharded = [n for n, s in got.items() if "fsdp" in s]
    assert bool(sharded) == (min_weight_size == 64)


def test_partition_rules_and_overrides_match_merv_tpu():
    """merv_tpu's tensor-parallel table as overrides, composed with the pp rule."""
    jm, pm, params = _pair()
    jrules = JS.llm_tensor_parallel_rules()
    rules = PS.PartitionRules([(pat.pattern, tuple(spec)) for pat, spec in jrules.rules])
    shape = dict(data=1, fsdp=2, tensor=2, sp=1, pp=2)
    want = _flat_specs(JS.fsdp_specs(params, _Shape(**shape), min_weight_size=64, overrides=jrules))
    leaves = PS.jax_leaves(pm)
    got = PS.fsdp_specs(pm, _Shape(**shape), min_weight_size=64, overrides=rules)
    assert all(got[n] == want[leaves[n].path] for n in got)
    assert got["llm_backbone.decoder.layers.1.attn.q_proj.weight"] == ("pp", None, "tensor")
    assert PS.path_str("llm_backbone.decoder.embed_tokens.weight") == "llm_backbone/decoder/embed_tokens/weight"
    assert rules.spec_for("llm_backbone/layers/mlp/down_proj/kernel") == (None, "tensor", None)


@pytest.mark.parametrize("shape, want", [((4096, 11008), 1), ((32064, 4096), 0), ((4096,), 0), ((3, 7), None),
                                         ((8, 8, 8), 2)])
def test_infer_fsdp_spec_and_placement(shape, want):
    """The rule's tie-break toward the trailing dim, and the port dim that a
    spec lands on for a transposed (Linear) leaf."""
    spec = PS.infer_fsdp_spec(shape, 8, min_weight_size=64)
    assert spec == tuple(JS.infer_fsdp_spec(shape, 8, min_weight_size=64))
    leaf = PS.JaxLeaf("x/kernel", shape, None, transposed=len(shape) == 2)
    dim = PS.param_placement(leaf, spec)
    assert dim == (None if want is None else (len(shape) - 1 - want if len(shape) == 2 else want))


def test_placement_deviations_list_replicated_leaves():
    """FSDP2 shards every leaf on dim 0. The leaves laid out otherwise than in
    merv_tpu are those whose spec is replicated or lands on another port dim:
    at merv_tpu's min_weight_size every leaf of the tiny MERV (all replicated
    there); at 64 the replicated small ones and the Linear weights sharded on
    their (in) dim, but not the leaves merv_tpu shards on dim 0 too."""
    jm, pm, params = _pair()
    leaves = PS.jax_leaves(pm)
    mesh = _Shape(data=1, fsdp=4, tensor=1, sp=1, pp=1)
    for min_weight_size in (2 ** 16, 64):
        specs = PS.fsdp_specs(pm, mesh, min_weight_size=min_weight_size, leaves=leaves)
        dims = {name: PS.param_placement(leaves[name], spec) for name, spec in specs.items()}
        deviating = {name for name, dim in dims.items() if dim != 0}
        if min_weight_size == 2 ** 16:
            assert deviating == {name for name, _ in pm.named_parameters()} and set(dims.values()) == {None}
        else:
            assert {name for name, dim in dims.items() if dim == 0} and {None, 1} <= set(dims.values())
            assert deviating == {name for name, dim in dims.items() if dim is None or dim > 0}


@pytest.mark.parametrize("batch", [0, 1, 2, 3, 6, 8, 12])
@pytest.mark.parametrize("pp", [2, 4])
@pytest.mark.parametrize("requested", [0, 1, 2, 3, 4])
def test_resolve_microbatches_matches_merv_tpu(batch, pp, requested):
    try:
        want = JP.resolve_microbatches(batch, pp, requested)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:40]):
            PP.resolve_microbatches(batch, pp, requested)
        return
    assert PP.resolve_microbatches(batch, pp, requested) == want


# ---------------------------------------------------------------------------
# The pipeline in one process
# ---------------------------------------------------------------------------


def _toy(seed, L, B, T, D):
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((L, D, D)) * D ** -0.5).astype(np.float32)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    cos = (rng.standard_normal((B, T, D)) * 0.1).astype(np.float32)
    return W, x, cos, np.flip(cos, -1).copy()


def _jax_toy(lp, h, cs):
    return jnp.tanh(h @ lp["w"] + cs[0]) + cs[1]


class _ToyLayer(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))


def _port_toy(layer, h, cs):
    return torch.tanh(h @ layer.w + cs[0]) + cs[1]


@pytest.mark.parametrize("pp, micro", [(2, 2), (2, 4), (4, 1), (4, 4)])
@pytest.mark.parametrize("remat", [False, True])
def test_pipeline_in_process_matches_merv_tpu(pp, micro, remat):
    """pipeline_layer_scan over VirtualStages against merv_tpu's on its
    virtual devices (data 2 x pp): output and the gradients of the layers and
    of the input."""
    W, x, cos, sin = _toy(0, L=8, B=4, T=8, D=16)
    jmesh = jax_build_mesh(JaxMeshConfig(data=8 // pp, fsdp=1, tensor=1, pipe=pp))

    def jloss(w, x):
        out = JP.pipeline_layer_scan(_jax_toy, x, (jnp.asarray(cos), jnp.asarray(sin)), {"w": w}, jmesh,
                                     microbatches=micro, remat=remat)
        return jnp.sum(out * jnp.arange(out.size, dtype=jnp.float32).reshape(out.shape) / out.size), out

    (_, jout), (jgw, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(W, x)
    layers = [_ToyLayer(w) for w in W]
    tx = torch.from_numpy(x).requires_grad_()
    out = PP.pipeline_layer_scan(_port_toy, tx, (torch.from_numpy(cos), torch.from_numpy(sin)), layers,
                                 VirtualMesh(1, pipe=pp), microbatches=micro, remat=remat)
    (out * torch.arange(out.numel(), dtype=torch.float32).reshape(out.shape) / out.numel()).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.stack([l.w.grad.numpy() for l in layers]), np.asarray(jgw), atol=1e-5, rtol=1e-5)


def test_pipeline_rejects_bad_shapes():
    W, x, cos, sin = _toy(1, L=6, B=4, T=4, D=8)
    layers = [_ToyLayer(w) for w in W]
    cs = (torch.from_numpy(cos), torch.from_numpy(sin))
    with pytest.raises(ValueError, match="not divisible by pp"):
        PP.pipeline_layer_scan(_port_toy, torch.from_numpy(x), cs, layers, VirtualMesh(1, pipe=4), microbatches=2)
    with pytest.raises(ValueError, match="not divisible by microbatches"):
        PP.pipeline_layer_scan(_port_toy, torch.from_numpy(x), cs, layers, VirtualMesh(1, pipe=2), microbatches=3)
    with pytest.raises(ValueError, match="requires a pp axis"):
        PP.pipeline_layer_scan(_port_toy, torch.from_numpy(x), cs, layers, VirtualMesh(1), microbatches=2)


@pytest.mark.parametrize("remat", [False, True])
def test_decoder_pipeline_matches_merv_tpu(remat):
    """The tiny decoder with pipeline_parallel under pp = 2 in process
    against merv_tpu's on its pp 2 mesh: logits and every parameter's
    gradient; a right-padded row; and the plain loop where the layers do not
    tile the stages."""
    jcfg = jax_tiny_decoder(compute_dtype=jnp.float32, pipeline_parallel=True, num_layers=4)
    params = jax.tree_util.tree_map(np.asarray, JaxDecoder(jcfg).init(jax.random.PRNGKey(3)))
    dec = LlamaDecoder(tiny_decoder_config(compute_dtype=torch.float32, pipeline_parallel=True, num_layers=4),
                       device=CPU)
    dec.load_state_dict(state_dict_from_jax(params))
    dec.requires_grad_(True)
    rng = np.random.RandomState(4)
    ids = rng.randint(3, 250, size=(4, 12)).astype(np.int32)
    mask = np.ones((4, 12), np.int32)
    mask[1, 9:] = 0
    jmesh = jax_build_mesh(JaxMeshConfig(data=4, fsdp=1, tensor=1, pipe=2))
    jdec = JaxDecoder(jcfg)

    def jloss(p):
        with jax_activation_mesh(jmesh):
            logits, _ = jdec(p, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask), remat=remat)
        return jnp.mean(logits ** 2), logits

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    with activation_mesh(VirtualMesh(1, pipe=2)):
        logits, _ = dec(input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask), remat=remat)
    (logits ** 2).mean().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-4, rtol=1e-4)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for n, p in dec.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), atol=1e-4, rtol=1e-4, err_msg=n)
    with torch.no_grad():  # 4 layers do not tile 3 stages: the plain loop
        plain = dec(input_ids=torch.from_numpy(ids).long())[0]
        with activation_mesh(VirtualMesh(1, pipe=3)):
            torch.testing.assert_close(dec(input_ids=torch.from_numpy(ids).long())[0], plain, rtol=0, atol=0)


def test_tensor_axis_still_raises():
    """A tensor axis beside pp runs: a decoder that is not cut to tensor
    shards (on a virtual mesh the weights stay whole) runs GPipe's stages and
    computes what the plain loop does."""
    dec = LlamaDecoder(tiny_decoder_config(compute_dtype=torch.float32, pipeline_parallel=True), device=CPU)
    init_weights(dec, torch.Generator().manual_seed(4))
    ids = torch.from_numpy(np.random.RandomState(4).randint(3, 256, (2, 4))).long()
    with torch.no_grad():
        plain = dec(input_ids=ids)[0]
        with activation_mesh(VirtualMesh(1, tensor=2, pipe=2)):
            got = dec(input_ids=ids)[0]
    assert dec.tp is None
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# One train step on a spawned gloo world of 4, five layouts
# ---------------------------------------------------------------------------

WORLD = 4
ACCUM, GLOBAL_BATCH, LR, CLIP = 2, 8, 1e-3, 0.5
# name: (strategy, fsdp, sp, pp, per-device batch, weight decay, remat)
LAYOUTS = {
    "fsdp_full_shard": ("fsdp-full-shard", 4, 1, 1, 1, 0.1, True),
    "fsdp_shard_grad_op": ("fsdp-shard-grad-op", 4, 1, 1, 1, 0.1, False),
    "ddp": ("ddp", 4, 1, 1, 1, 0.0, False),
    "fsdp2_sp2": ("fsdp-full-shard", 2, 2, 1, 2, 0.1, True),
    "fsdp2_pp2": ("fsdp-full-shard", 2, 1, 2, 2, 0.1, True),
}


def _batch(pm, seed=5, T=8):
    """8 rows whose label counts differ: right padding of 0 to 5 tokens, two text-only rows."""
    rng = np.random.RandomState(seed)
    B = GLOBAL_BATCH
    ids = rng.randint(3, 250, size=(B, T)).astype(np.int32)
    ids[:, 0] = 1
    mask = np.ones((B, T), np.int32)
    for b, pad in enumerate([0, 3, 1, 5, 0, 2, 4, 0]):
        if pad:
            ids[b, T - pad:], mask[b, T - pad:] = 0, 0
    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    labels[:, 0] = -100
    is_mm = np.ones(B, bool)
    is_mm[[2, 5]] = False
    vids = [rng.randn(B, *vb.default_video_resolution).astype(np.float32) for vb in pm.video_backbones]
    return dict(input_ids=ids, attention_mask=mask, labels=labels, is_multimodal=is_mm, video_values=vids)


def _torch_batch(b):
    out = {k: torch.from_numpy(v) for k, v in b.items() if k != "video_values"}
    out["input_ids"], out["labels"] = out["input_ids"].long(), out["labels"].long()
    out["video_values"] = [torch.from_numpy(v) for v in b["video_values"]]
    return out


def _jax_step(layout, b):
    """merv_tpu's step on a mesh of the layout's shape (4 of its virtual
    devices): loss, grad norm and the updated params."""
    strategy, fsdp, sp, pp, _, wd, _ = LAYOUTS[layout]
    jm, _, params = _pair(sequence_parallel=sp > 1, pipeline_parallel=pp > 1)
    jm.freeze_backbones("finetune")
    mask = jm.trainable_mask(params)
    tx = jax_build_optimizer(params, jax_build_schedule("constant", LR, 1), wd, CLIP, trainable_mask=mask)
    mesh = jax_build_mesh(JaxMeshConfig(data=1, fsdp=fsdp, tensor=1, seq=sp, pipe=pp), devices=jax.devices()[:WORLD])
    state = TrainState(jax.tree_util.tree_map(jnp.asarray, params), tx.init(params), jnp.zeros((), jnp.int32))
    state, specs = shard_train_state(state, mesh, strategy)
    step = jit_train_step(jax_make_train_step(jax_make_loss_fn(jm, remat=False), tx, grad_accumulation_steps=ACCUM,
                                              trainable_mask=mask), specs, mesh)

    def prep(x):
        x = jnp.asarray(x)
        return x.reshape(ACCUM, x.shape[0] // ACCUM, *x.shape[1:])

    jb = {k: ([prep(v) for v in b[k]] if k == "video_values" else prep(b[k])) for k in b}
    state, metrics = step(state, jb)
    new = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params))
    return float(metrics["loss"]), float(metrics["grad_norm"]), new, mask


@pytest.fixture(scope="module")
def train_world(tmp_path_factory):
    jm, pm, params = _pair()
    b = _batch(pm)
    root = tmp_path_factory.mktemp("train_world")
    layouts = {name: dict(strategy=s, fsdp=f, sp=sp, pp=pp, per_device=pd, wd=wd, remat=remat)
               for name, (s, f, sp, pp, pd, wd, remat) in LAYOUTS.items()}
    inp = dict(model=pm, batch=_torch_batch(b), layouts=layouts, global_batch=GLOBAL_BATCH, lr=LR, clip=CLIP,
               root=str(root))
    ranks = spawn_world(torch_sp_workers.train_world, WORLD, inp, root)
    return b, root, ranks


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_step_matches_merv_tpu(train_world, layout):
    """Loss and grad norm on every rank, and every trainable of the
    checkpoint the sharded run wrote, against merv_tpu's step on the same
    mesh shape; frozen towers not in the checkpoint; the checkpoint reloads
    at this world size bit for bit."""
    b, root, ranks = train_world
    loss, norm, new, mask = _jax_step(layout, b)
    for r in ranks:
        got = r[layout]
        assert got["accum"] == ACCUM and got["reload_equal"] and got["count"] == 1
        np.testing.assert_allclose(got["loss"], loss, **STEP_TOL)
        np.testing.assert_allclose(got["grad_norm"], norm, **STEP_TOL)
    if LAYOUTS[layout][0] != "ddp":
        assert "DTensor" in ranks[0][layout]["kinds"]
    saved = load_checkpoint(latest_checkpoint(root / layout))
    assert sorted(saved["model"]) == ["feature_fusion", "llm_backbone", "projectors"]
    n = 0
    for key, sd in saved["model"].items():
        for rest, t in sd.items():
            np.testing.assert_allclose(t.numpy(), new[f"{key}.{rest}"].numpy(), **STEP_TOL, err_msg=f"{key}.{rest}")
            n += 1
    assert n == sum(1 for k in new if k.split(".")[0] in saved["model"])


@pytest.mark.parametrize("layout", ["fsdp_full_shard", "fsdp2_sp2", "fsdp2_pp2"])
def test_samplers_split_over_the_batch_ranks_only(train_world, layout):
    """A deviation from merv_tpu (one process a rank, where one of its
    processes holds every local device): each stage's sampler takes data x
    fsdp replicas and the rank's batch coordinate, so ranks that differ only
    in sp or pp read the same examples and the batch ranks split them."""
    _, _, ranks = train_world
    by_batch = {}
    for r in ranks:
        got = r[layout]
        key = got["coords"]["data"] * 4 + got["coords"]["fsdp"]
        by_batch.setdefault(key, []).append(got["sampled"])
    assert len(by_batch) == LAYOUTS[layout][1]
    for same in by_batch.values():
        assert all(s == same[0] for s in same)
    for stage in ("align", "finetune"):
        lists = [same[0][stage] for same in by_batch.values()]
        assert not set(lists[0]) & set(lists[1]) and len(set().union(*lists)) == 2 * GLOBAL_BATCH


@pytest.mark.parametrize("layout", ["fsdp_full_shard", "fsdp2_pp2", "ddp"])
def test_sharded_checkpoint_loads_at_world_1(train_world, layout):
    """The world-4 file is the one a one-device run writes: the same keys,
    optimizer indices and moments (within STEP_TOL) as the same step at world
    1, and a one-device strategy resumes from it."""
    from merv_tpu_torch.models.backbones.video.base_video import VideoBackbone

    b, root, _ = train_world
    strategy, _, _, _, _, wd, _ = LAYOUTS[layout]

    keep = VideoBackbone.half_precision_dtype
    VideoBackbone.half_precision_dtype = property(lambda self: torch.float32)
    try:
        _, pm, _ = _pair()
        pm.freeze_backbones("finetune")
        one = get_train_strategy(strategy, pm, stage="finetune", max_steps=1, global_batch_size=GLOBAL_BATCH,
                                 per_device_batch_size=GLOBAL_BATCH // ACCUM, learning_rate=LR, weight_decay=wd,
                                 max_grad_norm=CLIP, lr_scheduler_type="constant")
        one.run_setup(root / f"{layout}_world1", n_train_examples=GLOBAL_BATCH)
        one.step_fn(_torch_batch(b))
        want = one.tx.state_dict()
        saved = load_checkpoint(latest_checkpoint(root / layout))["optimizer"]
        assert saved["count"] == want["count"] == 1
        assert saved["adamw"]["param_groups"] == want["adamw"]["param_groups"]
        assert set(saved["adamw"]["state"]) == set(want["adamw"]["state"])
        for i, st in want["adamw"]["state"].items():
            for k, v in st.items():
                np.testing.assert_allclose(saved["adamw"]["state"][i][k].numpy(), v.numpy(), **STEP_TOL)
        _, fresh, _ = _pair()
        fresh.freeze_backbones("finetune")
        resumed = get_train_strategy(strategy, fresh, stage="finetune", max_steps=1, global_batch_size=GLOBAL_BATCH,
                                     per_device_batch_size=GLOBAL_BATCH // ACCUM, learning_rate=LR, weight_decay=wd,
                                     max_grad_norm=CLIP, lr_scheduler_type="constant")
        resumed.run_setup(root / f"{layout}_resumed", n_train_examples=GLOBAL_BATCH,
                          resume_from_checkpoint=latest_checkpoint(root / layout))
        assert resumed.tx.count == 1 and resumed._resume_step == 1
        for (n, a), p in zip(pm.named_parameters(), fresh.parameters()):
            torch.testing.assert_close(p, a, **STEP_TOL, msg=n)
    finally:
        VideoBackbone.half_precision_dtype = keep


# ---------------------------------------------------------------------------
# The pretrain CLI on a spawned world of 2: --mesh_seq 2, --mesh_pipe 2, a resume
# ---------------------------------------------------------------------------

from test_torch_datasets import _write_dataset  # noqa: E402
from test_torch_pretrain_cli import TOWERS as CLI_TOWERS  # noqa: E402
from test_torch_pretrain_cli import VOCAB, _argv, _logged, tiny_factories  # noqa: E402,F401

import merv_tpu_torch.cli.pretrain as cli  # noqa: E402
import merv_tpu_torch.training.checkpointing as ckpt  # noqa: E402

ALIGN, FT, RESUMED = "tiny-cli+sp+stage-align+x7", "tiny-cli+pp+stage-finetune+x7", "tiny-cli+ppr+stage-finetune+x7"
DEFAULT = "tiny-cli+fsdp+stage-align+x7"


def _cli_runs(root, parallel: bool):
    """(label, argv, run whose step-1 checkpoint it resumes): align, finetune from
    that align run's last checkpoint, and the finetune resumed from its step 1."""
    sp, pp = (["--mesh_seq", "2"], ["--mesh_pipe", "2"]) if parallel else ([], [])
    pretrained = ["--pretrained_checkpoint", str(root / "runs" / ALIGN / "checkpoints" / "latest-checkpoint")]
    return [("align", _argv(root, "align", ALIGN, *sp), None),
            ("finetune", _argv(root, "finetune", FT, *pp, *pretrained), None),
            ("resume", _argv(root, "finetune", RESUMED, *pp, *pretrained), FT)]


def test_pretrain_cli_mesh_seq_and_mesh_pipe_match_world_1(tmp_path, tiny_factories):
    """Two ranks over gloo: align at --mesh_seq 2 (the ring in every layer),
    finetune at --mesh_pipe 2 (each rank holds one of the two layers), then
    that finetune resumed from its step-1 checkpoint, and align with neither
    flag (the default mesh, both ranks on fsdp: each loads half the batch).
    The first three at world 1 in this process: the logged losses within 1e-4, every
    checkpoint's trainables and AdamW moments within STEP_TOL, the resume
    ending where the straight run does."""
    jm, params = tiny_factories
    world = tmp_path / "world2"
    for root in (world, tmp_path / "world1"):
        _write_dataset(root)
    towers = [_port_tower(n) for n in CLI_TOWERS]
    inp = dict(towers=towers, vocab=VOCAB, state=state_dict_from_jax(params), root=str(world),
               runs=_cli_runs(world, True))
    (tmp_path / "spawn").mkdir()
    inp["runs"].append(("default", _argv(world, "align", DEFAULT), None))  # neither flag: every rank on fsdp
    ranks = spawn_world(torch_sp_workers.cli_world, 2, inp, tmp_path / "spawn")
    for label, argv, resume_of in _cli_runs(tmp_path / "world1", False):
        if resume_of is not None:
            step1 = next((tmp_path / "world1" / "runs" / resume_of / "checkpoints").glob("step-000001-*"))
            argv = argv + ["--resume_from_checkpoint", str(step1)]
        cli.pretrain(args=argv + ["--device", "cpu"])

    for r, res in enumerate(ranks):
        assert res["align"]["collectives"]["ring_shift"] > 0 and res["align"]["collectives"]["all_gather"] > 0
        assert res["finetune"]["collectives"]["broadcast"] > 0
        assert res["finetune"]["layers"] == (["DecoderLayer", "ForeignLayer"] if r == 0 else
                                             ["ForeignLayer", "DecoderLayer"])
        assert res["resume"]["resume_step"] == 1 and res["resume"]["count"] == 2
        assert res["default"]["world_size"] == 2 and res["align"]["world_size"] == res["finetune"]["world_size"] == 1
    logged = _logged(world / "runs" / DEFAULT, DEFAULT, "Align/Loss")
    assert len(logged) == 2 and all(np.isfinite(logged))  # rank 0 alone logs
    assert ckpt.latest_checkpoint(world / "runs" / DEFAULT) is not None
    for run_id, key in ((ALIGN, "Align/Loss"), (FT, "Finetune/Loss"), (RESUMED, "Finetune/Loss")):
        np.testing.assert_allclose(_logged(world / "runs" / run_id, run_id, key),
                                   _logged(tmp_path / "world1" / "runs" / run_id, run_id, key), rtol=1e-4, atol=1e-4)
        got = ckpt.load_checkpoint(ckpt.latest_checkpoint(world / "runs" / run_id))
        want = ckpt.load_checkpoint(ckpt.latest_checkpoint(tmp_path / "world1" / "runs" / run_id))
        assert got["step"] == want["step"] and sorted(got["model"]) == sorted(want["model"])
        for key_, sd in want["model"].items():
            assert sorted(got["model"][key_]) == sorted(sd)
            for name, t in sd.items():
                np.testing.assert_allclose(got["model"][key_][name].numpy(), t.numpy(), **STEP_TOL, err_msg=name)
        assert got["optimizer"]["adamw"]["param_groups"] == want["optimizer"]["adamw"]["param_groups"]
        for i, st in want["optimizer"]["adamw"]["state"].items():
            for k, v in st.items():
                np.testing.assert_allclose(got["optimizer"]["adamw"]["state"][i][k].numpy(), v.numpy(), **STEP_TOL)


# ---------------------------------------------------------------------------
# cli/memory_proof.py on the tiny model
# ---------------------------------------------------------------------------


def _tiny_proof_model(*_):
    """The tiny MERV as memory_proof's build_model gives a model: towers made in their half precision."""
    from merv_tpu_torch.conf import MERV_Base
    from merv_tpu_torch.models.backbones.video.vit import tiny_vit_config
    from test_torch_merv import TOWERS

    def tower(name):
        _, pcls, vb_id, kw, over, _ = TOWERS[name]
        return pcls(vb_id, "resize-naive", vit_config=tiny_vit_config(**over), device=CPU, param_dtype=torch.bfloat16,
                    **kw)

    vbs = [tower(n) for n in MERV_TOWERS]
    pm = MERV("tiny-merv", vbs, tiny_llm_backbone(compute_dtype=torch.float32, device=CPU), device=CPU, **MERV_KW)
    return pm, [vb.get_video_transform() for vb in vbs], MERV_Base()


def test_memory_proof_counts_the_placements_and_the_budget(monkeypatch, tmp_path):
    """The proof traces the tiny MERV's fsdp-full-shard finetune step over 4
    fake ranks: the bytes rank 0 keeps (its parameters, fp32 gradients and two
    AdamW moments of the trainables) are those FSDP2's placement gives (each
    leaf's torch.chunk over 4 on its dim 0, towers in bf16); a tiny budget
    makes it exit 1; serving and a tensor axis raise."""
    import json

    import merv_tpu_torch.cli.memory_proof as MP

    monkeypatch.setattr(MP, "build_model", _tiny_proof_model)
    argv = ["--stage", "finetune", "--devices", "4", "--pdbs", "2", "--seq-len", "8", "--loss-chunk", "4"]
    assert MP.main(argv + ["--json-out", str(tmp_path / "p.json")]) == 0
    rank0 = json.loads((tmp_path / "p.json").read_text())["stages"]["finetune"]["ranks"][0]
    pm, _, _ = _tiny_proof_model()
    pm.freeze_backbones("finetune")
    for vb in pm.video_backbones:
        vb.to(vb.half_precision_dtype)
    want = dict(params=0, grads=0, optimizer=0)
    for p in pm.parameters():
        local = p.detach().chunk(4, 0)[0].numel()
        want["params"] += local * p.element_size()
        if p.requires_grad:
            want["grads"] += local * 4
            want["optimizer"] += 2 * local * 4
    assert rank0["kept_bytes"] == want
    assert rank0["peak_gib"] > sum(want.values()) / 2 ** 30 and rank0["mesh"]["fsdp"] == 4
    assert MP.main(argv + ["--budget-gib", "1e-9"]) == 1
    # the serving stage runs (tests/test_torch_tensor_parallel.py holds its weights against merv_tpu's); a
    # tensor axis is a serving layout only, as in merv_tpu, whose training entry points all run tensor = 1
    serving = tmp_path / "serving.json"
    assert MP.main(["--stage", "serving", "--mesh-tensor", "2", "--llm-layers", "1", "--slots", "1", "--max-len", "64",
                    "--prefill-bucket", "32", "--json-out", str(serving)]) == 0
    assert json.loads(serving.read_text())["stages"]["serving"]["ranks"][0]["tensor"] == 2
    with pytest.raises(ValueError, match="--stage serving"):
        MP.main(["--mesh-tensor", "2"])
