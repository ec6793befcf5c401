"""Hiera in the port (merv_tpu_torch) against merv_tpu: the token unroll and
reroll, the layer plans, the original repository's .pth through both
importers, and a tiny MERV with a Hiera tower and the attntv projector end to
end. fp32, tiny configs, numpy-seeded inputs; tolerances as
tests/test_torch_vision_zoo.py states them (its helpers build the tiny pairs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merv_tpu.models.backbones.video import hiera as jax_hiera
from merv_tpu.models.backbones.video import vision_import as jax_vision_import
from merv_tpu_torch.bridge import state_dict_from_jax
from merv_tpu_torch.models.backbones.video import hiera
from merv_tpu_torch.models.backbones.video import vision_import
from test_torch_vision_zoo import LOGIT_TOL, _assert_same_state, _close, _merv_pair, _np_tree, _randomize_gammas, _t, _tiny_pair


@pytest.mark.parametrize("size,schedule", [((2, 8, 8), [[1, 2, 2]] * 3), ((4, 8, 8), [[2, 2, 2], [1, 2, 2]]),
                                           ((8, 16, 16), [[1, 2, 2]] * 3)])
def test_hiera_unroll_and_reroll_match_merv_tpu(size, schedule):
    x = np.random.RandomState(5).randn(2, int(np.prod(size)), 5).astype(np.float32)
    un = np.asarray(jax_hiera._unroll(jnp.asarray(x), size, schedule))
    np.testing.assert_array_equal(hiera._unroll(_t(x), size, schedule).numpy(), un)
    for k in range(len(schedule) + 1):
        np.testing.assert_array_equal(hiera._reroll(_t(un), size, schedule[k:]).numpy(),
                                      np.asarray(jax_hiera._reroll(jnp.asarray(un), size, schedule[k:])))
    np.testing.assert_array_equal(hiera._reroll(_t(un), size, schedule).numpy(), x.reshape(2, *size, 5))


@pytest.mark.parametrize("arch", list(jax_hiera.HIERA_CONFIGS))
def test_hiera_layer_plan_matches_merv_tpu(arch):
    assert hiera.HIERA_CONFIGS[arch].layer_plan() == jax_hiera.HIERA_CONFIGS[arch].layer_plan()
    assert hiera.HIERA_VIDEO_BACKBONES == jax_hiera.HIERA_VIDEO_BACKBONES


def _hiera_pth_state(cfg, rng):
    """A state dict in the original Hiera repository's layout, with a classifier head."""
    t, h, w = cfg.tokens_shape
    state = {"patch_embed.proj.weight": rng.randn(cfg.embed_dim, 3, *cfg.patch_kernel) * 0.05,
             "patch_embed.proj.bias": rng.randn(cfg.embed_dim) * 0.05,
             "pos_embed_spatial": rng.randn(1, h * w, cfg.embed_dim) * 0.05,
             "pos_embed_temporal": rng.randn(1, t, cfg.embed_dim) * 0.05,
             "head.projection.weight": rng.randn(10, cfg.final_dim), "head.projection.bias": rng.randn(10)}
    for i, lp in enumerate(cfg.layer_plan()):
        d_in, d_out = lp["dim_in"], lp["dim_out"]
        hidden = int(d_out * cfg.mlp_ratio)
        shapes = {"norm1": (d_in,), "attn.qkv": (3 * d_out, d_in), "attn.proj": (d_out, d_out), "norm2": (d_out,),
                  "mlp.fc1": (hidden, d_out), "mlp.fc2": (d_out, hidden)}
        if d_in != d_out:
            shapes["proj"] = (d_out, d_in)
        for n, shape in shapes.items():
            state[f"blocks.{i}.{n}.weight"] = (1 + 0.1 * rng.randn(*shape)) if n.startswith("norm") \
                else rng.randn(*shape) * 0.1
            state[f"blocks.{i}.{n}.bias"] = rng.randn(shape[0]) * 0.05
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in state.items()}


def _hiera_params(jbb, seed):
    """merv_tpu's params for a tiny Hiera, imported from a seeded original-layout
    state dict (merv_tpu's own random init costs seconds of compilation here)."""
    return _np_tree(jbb.load_state_dict(_hiera_pth_state(jbb.hiera_config, np.random.RandomState(seed)),
                                        param_dtype=jnp.float32))


def test_hiera_pth_import_matches_merv_tpu(tmp_path):
    """A .pth in the original repository's layout (nested under model_state, as
    the released files are) through both packages' extract + import; the
    forward on 32 frames (two clips of 16), and the bridge carries merv_tpu's
    tree onto the same state."""
    jbb, pbb, _ = _tiny_pair("hiera-base-plus-video")
    path = tmp_path / "hiera_base_plus_16x224.pth"
    torch.save({"model_state": _hiera_pth_state(pbb.hiera_config, np.random.RandomState(6))}, path)
    jparams = jbb.load_state_dict(jax_vision_import.extract_hiera_state(str(path), False), param_dtype=jnp.float32)
    state = vision_import.extract_hiera_state(str(path), False)
    assert not any(k.startswith("head.") for k in state)
    pbb.import_state_dict(state, param_dtype=torch.float32)
    _assert_same_state(pbb.model.state_dict(), state_dict_from_jax(_np_tree(jparams)))
    video = np.random.RandomState(7).randn(1, 32, 3, 32, 32).astype(np.float32)
    with torch.inference_mode():
        out = pbb(_t(video)).numpy()
    _close(out, jax.jit(lambda p, v: jbb(p, v))(jparams, jnp.asarray(video)))


def test_hiera_download_is_not_ported(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        vision_import.extract_hiera_state(None, False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        vision_import.extract_hiera_state(None, True)


def test_tiny_merv_with_hiera_and_attntv_matches_merv_tpu():
    """Hiera (2 clips) and DINOv2 -> attntv + gelu-mlp -> cross_attention_avg_lq_pe ->
    tiny Llama: logits within 1e-4 and identical greedy tokens."""
    towers = {"hiera-base-plus-video": 32, "dinov2-video-all-tokens": 16}  # 16 frames x 4 tokens after pooling
    jm, pm = _merv_pair(towers, "attntv+gelu-mlp", "cross_attention_avg_lq_pe", 64)
    hiera_vb, dino_vb = jm.video_backbones
    params = _np_tree(jax.jit(jm.init_projector_params)())
    params["llm_backbone"] = _np_tree(jax.jit(jm.llm_backbone.init)(jax.random.PRNGKey(16)))
    params["video_backbones"] = {"0": _hiera_params(hiera_vb, 16), "1": _randomize_gammas(
        _np_tree(jax.jit(dino_vb.init)(jax.random.PRNGKey(17))), np.random.RandomState(17))}
    pm.load_state_dict(state_dict_from_jax(params), strict=True)
    rng = np.random.RandomState(17)
    ids = rng.randint(3, 250, size=(2, 8)).astype(np.int32)
    ids[:, 0] = 1
    mask = np.ones((2, 8), np.int32)
    mask[1, 5:] = 0
    vids = [rng.randn(2, *vb.default_video_resolution).astype(np.float32) for vb in pm.video_backbones]
    ref = jax.jit(jm.forward)(params, jnp.asarray(ids), jnp.asarray(mask), [jnp.asarray(v) for v in vids])
    t_ids, t_mask, t_vids = _t(ids).long(), _t(mask), [_t(v) for v in vids]
    with torch.inference_mode():
        out = pm.forward(t_ids, t_mask, t_vids)
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(ref["logits"]), **LOGIT_TOL)
    _close(out["mixer"].numpy(), np.asarray(ref["mixer"]))
    ref_tokens = jm.generate_ids(params, jnp.asarray(ids), jnp.asarray(mask), [jnp.asarray(v) for v in vids],
                                 max_new_tokens=6)
    tokens = pm.generate_ids(t_ids, t_mask, t_vids, max_new_tokens=6)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
