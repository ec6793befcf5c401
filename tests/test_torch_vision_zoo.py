"""The vision side of the model zoo: every tower id, Hiera, the MAP head,
every projector and fusion, and their checkpoint import, in the port
(merv_tpu_torch) against merv_tpu, in fp32 on tiny configs.

Weights: a merv_tpu random init, carried over by merv_tpu_torch.bridge, or a
state dict in the reference's torch layout fed to both packages' importers.
Inputs: numpy seeds, fed to both. Tolerances (ROADMAP "Parity"): per module
|out - ref| <= 1e-5 * (|ref| + max(1, max |ref|)) elementwise (fp32 rounding
scales with the largest value a random-weight projector reaches, ~40 for the
fused MLP), <= 1e-4 on logits, identical greedy tokens. Tower metadata is compared for all 32 ids at full size, built
on torch's meta device (no memory).
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merv_tpu.models import ckpt_import as jax_ckpt
from merv_tpu.models.backbones.llm.base_llm import tiny_llm_backbone as jax_tiny_llm
from merv_tpu.models.backbones.video import hiera as jax_hiera
from merv_tpu.models.backbones.video import vision_import as jax_vision_import
from merv_tpu.models.backbones.video.vit import VisionTransformer as JaxViT
from merv_tpu.models.backbones.video.vit import tiny_vit_config as jax_tiny_vit
from merv_tpu.models.materialize import VIDEO_BACKBONES as JAX_VIDEO_BACKBONES
from merv_tpu.models.materialize import get_video_backbone_and_transform as jax_get_towers
from merv_tpu.models.vidlms import MERV as JaxMERV
from merv_tpu.nn import fusion as jax_fusion
from merv_tpu.nn import projectors as jax_proj
from merv_tpu_torch.bridge import module_state_dicts, state_dict_from_jax
from merv_tpu_torch.models import ckpt_import
from merv_tpu_torch.models.backbones.llm.base_llm import tiny_llm_backbone
from merv_tpu_torch.models.backbones.video import hiera
from merv_tpu_torch.models.backbones.video import vision_import
from merv_tpu_torch.models.backbones.video.vit import VisionTransformer, tiny_vit_config
from merv_tpu_torch.models.materialize import VIDEO_BACKBONES, get_video_backbone_and_transform
from merv_tpu_torch.models.vidlms import MERV
from merv_tpu_torch.nn import fusion
from merv_tpu_torch.nn import projectors as proj

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CPU = "cpu"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(module, np_tree):
    module.load_state_dict(state_dict_from_jax(np_tree), strict=True)
    return module


def _close(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(ref).max(initial=0.0))))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_same_state(got, want):
    """Two state dicts with the same keys and equal values."""
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].float().numpy(), want[k].float().numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# every tower id: registry, metadata, transforms, refusals
# ---------------------------------------------------------------------------

TRANSFORM_FIELDS = ("target_size", "resize_strategy", "shortest_edge", "interpolation", "mean", "std",
                    "channels_first_time")


def _build(get, vb_id, nf=None, **kw):
    nf = nf or (32 if "vivit" in vb_id else 16)
    try:
        (vb,), (tf,) = get([vb_id], "resize-naive", [nf], **kw)
    except NotImplementedError as e:
        return None, None, e
    return vb, tf, None


@pytest.mark.parametrize("vb_id", list(JAX_VIDEO_BACKBONES))
def test_tower_id_matches_merv_tpu(vb_id):
    """The registry entry, the refusals with merv_tpu's messages, and every
    piece of metadata of the full-size tower (torch's meta device)."""
    assert list(VIDEO_BACKBONES) == list(JAX_VIDEO_BACKBONES)
    assert VIDEO_BACKBONES[vb_id]["kwargs"] == JAX_VIDEO_BACKBONES[vb_id]["kwargs"]
    assert VIDEO_BACKBONES[vb_id]["cls"].__name__ == JAX_VIDEO_BACKBONES[vb_id]["cls"].__name__
    jvb, jtf, jerr = _build(jax_get_towers, vb_id)
    vb, tf, err = _build(get_video_backbone_and_transform, vb_id, device="meta")
    if jerr is not None:
        assert err is not None and str(err) == str(jerr)
        return
    for attr in ("embed_dim", "num_patches", "spatial_resolution", "temporal_resolution",
                 "default_video_resolution", "num_frames", "default_image_size"):
        assert getattr(vb, attr) == getattr(jvb, attr), attr
    for f in TRANSFORM_FIELDS:
        assert getattr(tf, f) == getattr(jtf, f), f
    assert all(p.device.type == "meta" for p in vb.parameters())


# ---------------------------------------------------------------------------
# forward parity, one tiny tower per variant
# ---------------------------------------------------------------------------

DINO = dict(num_cls_tokens=1, num_register_tokens=4, use_layerscale=True)
LANGBIND = dict(num_cls_tokens=1, pre_norm=True, patch_bias=False, temporal_attn=True, temporal_frames=2,
                act="quick_gelu", layer_norm_eps=1e-5)
VIVIT = dict(num_cls_tokens=1, tubelet_t=2, tubelet_frames=8, act="gelu_tanh")
SIGLIP = dict(num_cls_tokens=0, pos_embed_includes_prefix=False, act="gelu_tanh")
SIGLIP_POOLED = dict(SIGLIP, attn_pool=True, attn_pool_heads=4, attn_pool_mlp_ratio=2.0)
TINY_HIERA_KW = dict(input_size=(16, 32, 32), embed_dim=8, num_heads=1, stages=(1, 1, 1, 1))

# backbone id -> (tiny ViT overrides, frames, video shape): one real forward a family; every id's token
# logic is held at full size on the ViT's stand-in below. Hiera: its own tiny config, 2 clips of 16 frames
TINY_TOWERS = {
    "dinov2-video-all-tokens": (DINO, 4, (2, 4, 3, 32, 32)),
    "dinov2-video": (DINO, 4, (2, 4, 3, 32, 32)),
    "languagebind-video": (LANGBIND, 4, (2, 3, 4, 32, 32)),
    "vivit-google-b-all-tokens": (VIVIT, 8, (1, 8, 3, 32, 32)),
    "siglip-vit-b16-224px-all-no-cls": (SIGLIP, 4, (2, 4, 3, 32, 32)),
    "siglip-vit-b16-224px": (SIGLIP_POOLED, 4, (2, 4, 3, 32, 32)),
    "siglip-vit-so400m": (SIGLIP_POOLED, 4, (2, 4, 3, 32, 32)),
    "hiera-base-plus-video": (None, 32, (1, 32, 3, 32, 32)),
}


def _vit_stand_in_features(cfg, n, skip_last_layers=0, apply_final_norm=False, frames=1, apply_attn_pool=False):
    """What a ViT of ``cfg`` gives n frames, as seeded numbers: [n, tokens, D], or [n, D] pooled."""
    seed = 1 + skip_last_layers + 2 * apply_final_norm + 4 * apply_attn_pool + 8 * frames
    shape = (n, cfg.hidden_size) if apply_attn_pool else (n, cfg.num_prefix_tokens + cfg.num_patches, cfg.hidden_size)
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


class _PortVitStandIn(torch.nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg

    def forward(self, pixels, *, impl="auto", **kw):
        return _t(_vit_stand_in_features(self.cfg, pixels.shape[0], **kw))


# every id but Hiera's and the SigLIP ids both packages refuse
VIT_IDS = [i for i in JAX_VIDEO_BACKBONES
           if "hiera" not in i and not (i.startswith("siglip") and ("all-tokens" in i or "classemb-at-first" in i))]


@pytest.mark.parametrize("vb_id", VIT_IDS)
def test_tower_tokens_match_merv_tpu(vb_id):
    """Every ViT tower id at full width and resolution (4 frames), its ViT
    replaced in both packages by one stand-in: the tap (depth, final norm, MAP
    head, temporal windows) each asks for, and the token selection and layout
    it makes of the features."""
    jvb, _, _ = _build(jax_get_towers, vb_id, 4)
    vb, _, _ = _build(get_video_backbone_and_transform, vb_id, 4, device="meta")
    vb.vit = _PortVitStandIn(vb.vit_config)
    cfg = jvb.vit_config
    jstand = type("StandIn", (type(jvb),), {"vit": property(lambda self: (
        lambda params, pixels, **kw: jnp.asarray(_vit_stand_in_features(cfg, pixels.shape[0], **kw))))})
    jvb.__class__ = jstand
    video = np.zeros((1, *vb.default_video_resolution), np.float32)
    ref = np.asarray(jvb({}, jnp.asarray(video)))
    with torch.inference_mode():
        out = vb(_t(video)).numpy()
    assert out.shape == ref.shape
    _close(out, ref)  # averagetoken's mean over 257 tokens sums in another order


def _randomize_gammas(tree, rng):
    """LayerScale inits at 1e-5, which would hide the layers from the comparison."""
    if isinstance(tree, dict):
        return {k: (rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32) if k == "gamma"
                    else _randomize_gammas(v, rng)) for k, v in tree.items()}
    return tree


def _tiny_pair(vb_id, frames=None):
    """merv_tpu's and the port's tower of this id at a tiny config (32 px)."""
    over, nf, _ = TINY_TOWERS[vb_id]
    nf = frames or nf
    jcls, pcls = JAX_VIDEO_BACKBONES[vb_id]["cls"], VIDEO_BACKBONES[vb_id]["cls"]
    kw = dict(JAX_VIDEO_BACKBONES[vb_id]["kwargs"], num_frames=nf)
    kw["default_image_size"] = 32
    if over is None:  # Hiera
        jbb = jcls(vb_id, "resize-naive", **kw)
        jbb.hiera_config = jax_hiera.HieraConfig(compute_dtype=jnp.float32, **TINY_HIERA_KW)
        pbb = pcls(vb_id, "resize-naive", hiera_config=hiera.HieraConfig(compute_dtype=torch.float32, **TINY_HIERA_KW),
                   device=CPU, **kw)
        return jbb, pbb, pbb.model
    tiny = jax_tiny_vit(**over)
    jtiny = type(f"Tiny{jcls.__name__}", (jcls,), {"vit_config": property(lambda self: dataclasses.replace(tiny))})
    return jtiny(vb_id, "resize-naive", **kw), pcls(vb_id, "resize-naive", vit_config=tiny_vit_config(**over),
                                                     device=CPU, **kw), None


@pytest.mark.parametrize("vb_id", [i for i in TINY_TOWERS if "hiera" not in i])  # Hiera: tests/test_torch_hiera.py
def test_tiny_tower_matches_merv_tpu(vb_id):
    jbb, pbb, inner = _tiny_pair(vb_id)
    params = _randomize_gammas(_np_tree(jax.jit(jbb.init)(jax.random.PRNGKey(3))), np.random.RandomState(3))
    _load(inner if inner is not None else pbb.vit, params)
    video = np.random.RandomState(4).randn(*TINY_TOWERS[vb_id][2]).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, v: jbb(p, v))(params, jnp.asarray(video)))
    with torch.inference_mode():
        out = pbb(_t(video)).numpy()
    # merv_tpu's num_patches leaves out the cls tokens that all-token-with-cls (one a frame) and
    # classemb-at-first (one) put in front; the port keeps both as they are
    extra = video.shape[1] if "all-token-with-cls" in vb_id else 1 if "classemb-at-first" in vb_id else 0
    assert out.shape == ref.shape == (video.shape[0], pbb.num_patches + extra, pbb.embed_dim)
    _close(out, ref)


# ---------------------------------------------------------------------------
# the MAP head: timm naming
# ---------------------------------------------------------------------------

def _timm_siglip_state(cfg, rng, head=True):
    D, L, hidden = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size
    p = cfg.patch_size
    state = {"patch_embed.proj.weight": rng.randn(D, 3, p, p) * 0.05, "patch_embed.proj.bias": rng.randn(D) * 0.05,
             "pos_embed": rng.randn(1, cfg.num_patches, D) * 0.05, "norm.weight": 1 + 0.1 * rng.randn(D),
             "norm.bias": 0.1 * rng.randn(D)}
    lin = {"attn.qkv": (3 * D, D), "attn.proj": (D, D), "mlp.fc1": (hidden, D), "mlp.fc2": (D, hidden)}
    for i in range(L):
        for n in ("norm1", "norm2"):
            state[f"blocks.{i}.{n}.weight"], state[f"blocks.{i}.{n}.bias"] = 1 + 0.1 * rng.randn(D), 0.1 * rng.randn(D)
        for n, shape in lin.items():
            state[f"blocks.{i}.{n}.weight"], state[f"blocks.{i}.{n}.bias"] = rng.randn(*shape) * 0.1, rng.randn(shape[0]) * 0.05
    if head:
        ph = int(D * cfg.attn_pool_mlp_ratio)
        state["attn_pool.latent"] = rng.randn(1, 1, D)
        for n, shape in {"q": (D, D), "kv": (2 * D, D), "proj": (D, D), "mlp.fc1": (ph, D), "mlp.fc2": (D, ph)}.items():
            state[f"attn_pool.{n}.weight"], state[f"attn_pool.{n}.bias"] = rng.randn(*shape) * 0.1, rng.randn(shape[0]) * 0.05
        state["attn_pool.norm.weight"], state["attn_pool.norm.bias"] = 1 + 0.1 * rng.randn(D), 0.1 * rng.randn(D)
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in state.items()}


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh"])
def test_map_head_timm_import_matches_merv_tpu(act):
    over = dict(SIGLIP_POOLED, attn_pool_act=act)
    state = _timm_siglip_state(tiny_vit_config(**over), np.random.RandomState(8))
    jparams = jax_vision_import.import_vision_state_dict(jax_tiny_vit(**over), state)
    vit = VisionTransformer(tiny_vit_config(**over), device=CPU)
    vit.load_state_dict(vision_import.import_vision_state_dict(tiny_vit_config(**over), state), strict=True)
    _assert_same_state(vit.state_dict(), state_dict_from_jax(_np_tree(jparams)))
    px = np.random.RandomState(9).randn(3, 3, 32, 32).astype(np.float32)
    with torch.inference_mode():
        out = vit(_t(px), apply_attn_pool=True).numpy()
    ref = np.asarray(JaxViT(jax_tiny_vit(**over))(jparams, jnp.asarray(px), apply_attn_pool=True))
    assert out.shape == ref.shape == (3, 64)
    _close(out, ref)


def test_map_head_required_as_in_merv_tpu():
    state = _timm_siglip_state(tiny_vit_config(**SIGLIP_POOLED), np.random.RandomState(10), head=False)
    with pytest.raises(KeyError, match="attn_pool"):
        jax_vision_import.import_vision_state_dict(jax_tiny_vit(**SIGLIP_POOLED), state)
    with pytest.raises(KeyError, match="attn_pool"):
        vision_import.import_vision_state_dict(tiny_vit_config(**SIGLIP_POOLED), state)
    body = vision_import.import_vision_state_dict(tiny_vit_config(**SIGLIP_POOLED), state, require_attn_pool=False)
    assert not any(k.startswith("attn_pool") for k in body)
    with pytest.raises(ValueError, match="MAP head"):
        VisionTransformer(tiny_vit_config(**SIGLIP), device=CPU)(torch.zeros(1, 3, 32, 32), apply_attn_pool=True)


# ---------------------------------------------------------------------------
# projectors and fusions, each with its .pt import
# ---------------------------------------------------------------------------

def _ref_key(module, key):
    """The reference checkpoint's name of the port's parameter ``key`` (the
    inverse of merv_tpu's ckpt_import mapping, for writing test checkpoints)."""
    if isinstance(module, proj.MLPProjector):
        m = re.match(r"projector\.(\d+)\.(.*)", key)
        return f"projector.{2 * int(m.group(1))}.{m.group(2)}" if m else key
    if isinstance(module, (proj.LinearProjector, proj.Identity)):
        return key
    if key.startswith("projector."):
        return "projector." + _ref_key(module.projector, key[len("projector."):])
    if isinstance(module, proj.Convolutional3DProjector):
        return key.replace("conv.", "convolution_pooling.0.", 1)
    m = re.match(r"stage([12])_(\d+)\.(.*)", key)
    if m:
        return f"convolution_pooling.{0 if m.group(1) == '1' else 2}.b{int(m.group(2)) + 1}.{m.group(3)}"
    return key


def _ref_projector_state(module, rng):
    """Random values in the reference layout for every parameter of ``module``."""
    return {_ref_key(module, k): torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * 0.2)
            for k, v in module.state_dict().items()}


def _ref_fusion_state(module, rng):
    rand = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.2)  # noqa: E731
    if isinstance(module, fusion.CrossAttentionAdapterLearnableQuery):
        a = module.attention
        state = {"Q": rand(*module.Q.shape), "attention.in_proj_bias": rand(3 * module.embed_dim),
                 "attention.out_proj.weight": rand(*a.out_proj.weight.shape),
                 "attention.out_proj.bias": rand(module.embed_dim)}
        for n in ("q_proj", "k_proj", "v_proj"):
            state[f"attention.{n}_weight"] = rand(*getattr(a, n).weight.shape)
        if module.positional_embedding:
            state["pe"] = rand(*module.pe.shape)
        return state
    if isinstance(module, proj.LinearProjector) and module.pre_proj_layernorm:  # Sequential(LayerNorm, Linear...)
        D = module.layernorm.weight.shape[0]
        return {"0.weight": 1 + rand(D), "0.bias": rand(D), "1.projector.weight": rand(*module.projector.weight.shape),
                "1.projector.bias": rand(module.projector.weight.shape[0])}
    return _ref_projector_state(module, rng)


VD, LD = 64, 48  # vision and LLM widths of the projector cases
# name -> (merv_tpu module, port module, input shape)
PROJECTORS = {
    "linear_ln": (jax_proj.LinearProjector(VD, LD, pre_proj_layernorm=True),
                  proj.LinearProjector(VD, LD, pre_proj_layernorm=True, device=CPU), (2, 5, VD)),
    "gelu_mlp": (jax_proj.MLPProjector(VD, LD), proj.MLPProjector(VD, LD, device=CPU), (2, 5, VD)),
    "gelu_mlp_ln": (jax_proj.MLPProjector(VD, LD, pre_proj_layernorm=True),
                    proj.MLPProjector(VD, LD, pre_proj_layernorm=True, device=CPU), (2, 5, VD)),
    "deep_mlp": (jax_proj.MLPDeepProjector(VD, LD), proj.MLPDeepProjector(VD, LD, device=CPU), (2, 5, VD)),
    "fused_gelu_mlp": (jax_proj.FusedMLPProjector(VD, LD), proj.FusedMLPProjector(VD, LD, device=CPU), (2, 5, VD)),
    "none": (jax_proj.Identity(), proj.Identity(), (2, 5, VD)),
    "avg": (jax_proj.AveragePoolingProjector(VD, LD, 2, 3, "gelu-mlp"),
            proj.AveragePoolingProjector(VD, LD, 2, 3, "gelu-mlp", device=CPU), (2, 3, 25, VD)),
    "attntv": (jax_proj.AttentivePooler(VD, LD, 4, 8, 3, "fused-gelu-mlp"),
               proj.AttentivePooler(VD, LD, 4, 8, 3, "fused-gelu-mlp", device=CPU), (2, 3, 25, VD)),
    "conv": (jax_proj.ConvolutionalProjector(VD, LD, 2, 3, 3, "linear"),
             proj.ConvolutionalProjector(VD, LD, 2, 3, 3, "linear", device=CPU), (2, 3, 25, VD)),
    "3davg": (jax_proj.AveragePooling3DProjector(VD, LD, 2, 2, "none"),
              proj.AveragePooling3DProjector(VD, LD, 2, 2, "none", device=CPU), (2, 3, 25, VD)),
    "3dconv": (jax_proj.Convolutional3DProjector(VD, LD, 2, 2, "gelu-mlp"),
               proj.Convolutional3DProjector(VD, LD, 2, 2, "gelu-mlp", device=CPU), (2, 3, 25, VD)),
}


@pytest.mark.parametrize("name", list(PROJECTORS))
def test_projector_and_its_import_match_merv_tpu(name):
    jmod, pmod, shape = PROJECTORS[name]
    rng = np.random.RandomState(11)
    x = rng.randn(*shape).astype(np.float32)
    jfwd = jax.jit(lambda p, x: jmod(p, x))
    params = _np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(11)))
    _load(pmod, params)
    with torch.inference_mode():
        _close(pmod(_t(x)).numpy(), jfwd(params, jnp.asarray(x)))
    # the reference checkpoint layout through both importers
    state = _ref_projector_state(pmod, rng)
    jparams = _np_tree(jax_ckpt.convert_projector(jmod, state))
    got = ckpt_import.convert_projector(pmod, state)
    _assert_same_state(got, state_dict_from_jax(jparams))
    pmod.load_state_dict(got, strict=True)
    with torch.inference_mode():
        _close(pmod(_t(x)).numpy(), jfwd(jparams, jnp.asarray(x)))


def test_adaptive_pooling_matches_merv_tpu():
    x = np.random.RandomState(12).randn(2, 3, 7, 5, 6, 4).astype(np.float32)
    _close(proj.adaptive_avg_pool_2d(_t(x[:, 0]), (3, 4)).numpy(),
           jax_proj.adaptive_avg_pool_2d(jnp.asarray(x[:, 0]), (3, 4)))
    _close(proj.adaptive_avg_pool_3d(_t(x), (4, 2, 9)).numpy(), jax_proj.adaptive_avg_pool_3d(jnp.asarray(x), (4, 2, 9)))


E, T, C = 3, 4, 24
# name -> (merv_tpu module, port module)
FUSIONS = {
    "cross_attention_avg_lq_pe": (
        jax_fusion.CrossAttentionAdapterLearnableQuery(32, C, T, averagetoken=True, num_encoder=E,
                                                       positional_embedding=True),
        fusion.CrossAttentionAdapterLearnableQuery(32, C, T, averagetoken=True, num_encoder=E,
                                                   positional_embedding=True, device=CPU)),
    "cross_attention_lq_pe": (  # pe is kept but not read without the average, as in merv_tpu
        jax_fusion.CrossAttentionAdapterLearnableQuery(32, C, T, num_encoder=E, positional_embedding=True),
        fusion.CrossAttentionAdapterLearnableQuery(32, C, T, num_encoder=E, positional_embedding=True, device=CPU)),
    "scalar": (jax_fusion.ScalarAdapter(E), fusion.ScalarAdapter(E, device=CPU)),
    "concat_channel": (jax_proj.LinearProjector(E * C, C), proj.LinearProjector(E * C, C, device=CPU)),
    "concat_channel_ln": (jax_proj.LinearProjector(E * C, C, pre_proj_layernorm=True),
                          proj.LinearProjector(E * C, C, pre_proj_layernorm=True, device=CPU)),
}


@pytest.mark.parametrize("name", list(FUSIONS))
def test_fusion_and_its_import_match_merv_tpu(name):
    jmod, pmod = FUSIONS[name]
    rng = np.random.RandomState(13)
    V = [rng.randn(2, T, C).astype(np.float32) for _ in range(E)]

    def run(jp):
        if name.startswith("concat"):
            cat = np.concatenate(V, axis=-1)
            with torch.inference_mode():
                return [pmod(_t(cat)).numpy()], [np.asarray(jmod(jp, jnp.asarray(cat)))]
        with torch.inference_mode():
            out = pmod([_t(v) for v in V])
        ref = jmod(jp, [jnp.asarray(v) for v in V])
        return [o.numpy() for o in out], [np.asarray(r) for r in ref]

    params = _np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(13)))
    _load(pmod, params)
    for got, want in zip(*run(params)):
        _close(got, want)
    state = _ref_fusion_state(pmod, rng)
    jparams = _np_tree(jax_ckpt.convert_fusion(jmod, state))
    got_state = ckpt_import.convert_fusion(pmod, state)
    _assert_same_state(got_state, state_dict_from_jax(jparams))
    pmod.load_state_dict(got_state, strict=True)
    for got, want in zip(*run(jparams)):
        _close(got, want)


# ---------------------------------------------------------------------------
# MERV: every arch_specifier and fusion through project_and_fuse, with the .pt import
# ---------------------------------------------------------------------------

def _merv(port, towers, arch, fusion_type, vfl, ptl=4):
    """merv_tpu's MERV (``port`` False) or the port's over tiny towers {id: frames}."""
    vbs = [_tiny_pair(i, nf)[1 if port else 0] for i, nf in towers.items()]
    kw = dict(arch_specifier=arch, feature_fusion=fusion_type, projector_token_length=ptl, visual_feature_length=vfl,
              text_embedding_dim=32)
    if port:
        return MERV("tiny-merv", vbs, tiny_llm_backbone(compute_dtype=torch.float32, device=CPU), device=CPU, **kw)
    return JaxMERV("tiny-merv", vbs, jax_tiny_llm(compute_dtype=jnp.float32), **kw)


def _merv_pair(towers, arch, fusion_type, vfl, ptl=4):
    return _merv(False, towers, arch, fusion_type, vfl, ptl), _merv(True, towers, arch, fusion_type, vfl, ptl)


def _ref_merv_checkpoint(pm, rng):
    """A reference-layout {"model": {"projectors", "feature_fusion"}} of random values for ``pm``."""
    model = {"projectors": {f"{i}.{k}": v for i, p in enumerate(pm.projectors)
                            for k, v in _ref_projector_state(p, rng).items()}}
    if pm.feature_fusion is not None:
        model["feature_fusion"] = _ref_fusion_state(pm.feature_fusion, rng)
    return {"model": model}


# {tower id: frames}: 8 x 16 tokens and Hiera's one clip, 8 x 1 tokens: 8 x 4 after pooling
RESAMPLED = {"dinov2-video-all-tokens": 8, "hiera-base-plus-video": 16}
POOLED = {"dinov2-video": 8, "siglip-vit-b16-224px": 8}  # one token a frame
# (towers, arch_specifier, fusion, visual_feature_length)
ARCH_CASES = [
    (RESAMPLED, "no-align+avg+gelu-mlp", "cross_attention_avg_lq", 32),
    (RESAMPLED, "attntv+fused-gelu-mlp", "cross_attention_avg_lq_pe", 32),
    (RESAMPLED, "conv+linear", "concat", 32),
    (RESAMPLED, "3davg+none", "scalar", 32),
    (RESAMPLED, "3davg+frame2+gelu-mlp", "concat_channel", 16),
    (RESAMPLED, "no-align+3dconv+frame2+linear", "concat_channel_ln", 16),
    (RESAMPLED, "3dconv+fused-gelu-mlp", "cross_attention_lq", 32),
    (RESAMPLED, "avg+linear", "first", 32),
    (RESAMPLED, "attntv+linear", None, 32),
    (POOLED, "linear", "cross_attention_avg_lq_pe", 8),
    (POOLED, "gelu-mlp", "concat", 8),
    (POOLED, "fused-gelu-mlp", "scalar", 8),
    ({"dinov2-video": 8}, "none", "concat_channel_ln", 8),
]


@pytest.mark.parametrize("case", ARCH_CASES, ids=lambda c: f"{c[1]}-{c[2]}")
def test_project_and_fuse_matches_merv_tpu(case, tmp_path):
    """merv_tpu's init bridged, then a reference .pt through both importers:
    project_and_fuse within 1e-5 on the same tower features both times."""
    towers, arch, fusion_type, vfl = case
    jm, pm = _merv_pair(towers, arch, fusion_type, vfl)
    assert pm.visual_feature_length == jm.visual_feature_length == vfl
    assert pm.tokens_resampled == jm.tokens_resampled
    assert [type(p).__name__ for p in pm.projectors] == [type(p).__name__ for p in jm.projectors]
    assert type(pm.feature_fusion).__name__ == type(jm.feature_fusion).__name__
    rng = np.random.RandomState(14)
    feats = [rng.randn(2, vb.num_patches, vb.embed_dim).astype(np.float32) for vb in pm.video_backbones]
    jfuse = jax.jit(jm.project_and_fuse)

    def check(jparams):
        ref, ref_mix = jfuse(jparams, [jnp.asarray(f) for f in feats])
        with torch.inference_mode():
            out, mix = pm.project_and_fuse([_t(f) for f in feats])
        assert out.shape == (2, vfl * (len(towers) if fusion_type == "concat" else 1), pm.llm_backbone.embed_dim)
        _close(out.numpy(), np.asarray(ref))
        assert (mix is None) == (ref_mix is None)
        if mix is not None:
            _close(mix.numpy(), np.asarray(ref_mix))

    params = _np_tree(jax.jit(jm.init_projector_params)())
    for key, sd in module_state_dicts(params).items():
        if getattr(pm, key) is not None:
            getattr(pm, key).load_state_dict(sd, strict=True)
    check(params)

    path = tmp_path / "latest-checkpoint.pt"
    torch.save(_ref_merv_checkpoint(pm, rng), path)
    jparams = _np_tree(jax_ckpt.import_merv_checkpoint(jm, str(path)))
    got = ckpt_import.import_merv_checkpoint(pm, str(path))
    for key, sd in module_state_dicts(jparams).items():
        _assert_same_state(got[key], sd)
        if getattr(pm, key) is not None:
            getattr(pm, key).load_state_dict(got[key], strict=True)
    check(jparams)


def test_query_mlp_is_built_and_refused_as_in_merv_tpu():
    jm, pm = _merv_pair(POOLED, "gelu-mlp", "query_mlp", 8)
    assert isinstance(pm.feature_fusion, proj.MLPProjector)
    params = _np_tree(jax.jit(jm.init_projector_params)())
    pm.feature_fusion.load_state_dict(module_state_dicts(params)["feature_fusion"], strict=True)
    state = _ref_projector_state(pm.feature_fusion, np.random.RandomState(15))
    _assert_same_state(ckpt_import.convert_fusion(pm.feature_fusion, state),
                       state_dict_from_jax(_np_tree(jax_ckpt.convert_fusion(jm.feature_fusion, state))))
    feats = [np.zeros((1, vb.num_patches, vb.embed_dim), np.float32) for vb in pm.video_backbones]
    with pytest.raises(NotImplementedError) as want:
        jm.project_and_fuse(params, [jnp.asarray(f) for f in feats])
    with pytest.raises(NotImplementedError) as got:
        pm.project_and_fuse([_t(f) for f in feats])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch,vfl,msg", [("3davg+linear", 24, "not consistent"), ("avg+bogus", 32, "not supported")])
def test_arch_consistency_rules_as_in_merv_tpu(arch, vfl, msg):
    for port in (False, True):
        with pytest.raises((AssertionError, ValueError), match=msg):
            _merv(port, RESAMPLED, arch, None, vfl)


def test_identity_projectors_over_several_towers_fail_as_in_merv_tpu():
    """``none`` with no resampler over two towers: merv_tpu's consistency check reads an
    ``output_token_length`` that its Identity lacks; the port's Identity lacks it too."""
    for port in (False, True):
        with pytest.raises(AttributeError, match="output_token_length"):
            _merv(port, POOLED, "none", "concat", 8)


@pytest.mark.parametrize("label", ["Z1", "Z2"])
def test_zoo_requests_are_models_both_packages_build(label):
    """chip_smoke.py's phase-4h combinations at full size: merv_tpu's MERV accepts
    each as written (its constructor allocates nothing), and the port's, on the
    meta device, builds the same projectors, fusion and visual length."""
    import chip_smoke
    from merv_tpu.models.materialize import get_llm_backbone_and_tokenizer as jax_get_llm
    from merv_tpu.models.materialize import get_vidlm as jax_get_vidlm
    from merv_tpu_torch.models.materialize import get_llm_backbone_and_tokenizer, get_vidlm

    m = dict(chip_smoke.ZOO_REQUESTS)[label]
    args = (m["video_backbone_ids"], m["image_resize_strategy"], m["num_frames"])
    kw = dict(projector_token_length=m["projector_token_length"], visual_feature_length=m["visual_feature_length"])
    jm = jax_get_vidlm(m["model_id"], m["arch_specifier"], m["feature_fusion"], jax_get_towers(*args)[0],
                       jax_get_llm(m["llm_backbone_id"], m["llm_max_length"], inference_mode=True)[0], **kw)
    meta = torch.device("meta")
    pm = get_vidlm(m["model_id"], m["arch_specifier"], m["feature_fusion"],
                   get_video_backbone_and_transform(*args, device=meta)[0],
                   get_llm_backbone_and_tokenizer(m["llm_backbone_id"], m["llm_max_length"], inference_mode=True,
                                                  device=meta)[0], device=meta, **kw)
    assert [type(p).__name__ for p in pm.projectors] == [type(p).__name__ for p in jm.projectors]
    assert type(pm.feature_fusion).__name__ == type(jm.feature_fusion).__name__
    assert pm.visual_feature_length == jm.visual_feature_length == 1024
