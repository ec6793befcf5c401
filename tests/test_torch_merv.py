"""The port's modules (merv_tpu_torch) against merv_tpu's, in fp32 on tiny configs.

Weights: a merv_tpu random init, converted leaf by leaf with np.asarray and
carried over by merv_tpu_torch.bridge. Inputs: numpy seeds, fed to both.
Tolerance: <= 1e-4 (absolute and relative), as tests/test_crossstack_parity.py
holds logits; greedy tokens must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merv_tpu.models.backbones.llm.base_llm import tiny_llm_backbone as jax_tiny_llm
from merv_tpu.models.backbones.llm.prompting import PurePromptBuilder as JaxPurePromptBuilder
from merv_tpu.models.backbones.llm.tokenization import ByteTokenizer as JaxByteTokenizer
from merv_tpu.models.backbones.llm.transformer import LlamaDecoder as JaxDecoder
from merv_tpu.models.backbones.llm.transformer import tiny_decoder_config as jax_tiny_decoder
from merv_tpu.models.backbones.video import (
    DinoV2VideoBackbone as JaxDino,
    LangBindVideoBackbone as JaxLangBind,
    SiglipVideoBackbone as JaxSiglip,
    ViVITVideoBackbone as JaxViVIT,
)
from merv_tpu.models.backbones.video.vit import VisionTransformer as JaxViT
from merv_tpu.models.backbones.video.vit import tiny_vit_config as jax_tiny_vit
from merv_tpu.models.generation import GenerationConfig as JaxGenConfig
from merv_tpu.models.generation import _ban_eos_below_min_length as jax_ban_eos
from merv_tpu.models.generation import _filter_logits as jax_filter_logits
from merv_tpu.models.generation import generate as jax_generate
from merv_tpu.models.vidlms import MERV as JaxMERV
from merv_tpu.nn.fusion import CrossAttentionAdapterLearnableQuery as JaxFusion
from merv_tpu.nn.projectors import AveragePooling3DProjector as JaxPool3D
from merv_tpu.preprocessing.transforms import VideoTransform as JaxVideoTransform
from merv_tpu_torch.bridge import state_dict_from_jax
from merv_tpu_torch.models.backbones.llm.base_llm import tiny_llm_backbone
from merv_tpu_torch.models.backbones.llm.prompting import PurePromptBuilder
from merv_tpu_torch.models.backbones.llm.tokenization import ByteTokenizer
from merv_tpu_torch.models.backbones.llm.transformer import LlamaDecoder, tiny_decoder_config
from merv_tpu_torch.models.backbones.video import (
    DinoV2VideoBackbone,
    LangBindVideoBackbone,
    SiglipVideoBackbone,
    ViVITVideoBackbone,
)
from merv_tpu_torch.models.backbones.video.vit import VisionTransformer, tiny_vit_config
from merv_tpu_torch.models.generation import GenerationConfig, _ban_eos_below_min_length, _filter_logits, generate
from merv_tpu_torch.models.vidlms import MERV
from merv_tpu_torch.nn.fusion import CrossAttentionAdapterLearnableQuery
from merv_tpu_torch.nn.projectors import AveragePooling3DProjector
from merv_tpu_torch.preprocessing.transforms import VideoTransform

TOL = dict(atol=1e-4, rtol=1e-4)
CPU = "cpu"

# tower name -> (JAX class, port class, backbone id, kwargs, tiny ViT overrides, video shape)
TOWERS = {
    "dinov2": (JaxDino, DinoV2VideoBackbone, "dinov2-video-all-tokens", dict(default_image_size=32, num_frames=4),
               dict(num_cls_tokens=1, num_register_tokens=4, use_layerscale=True), (2, 4, 3, 32, 32)),
    # 15x15 patches + 5 prefix tokens = 230, head dim 64: the small_attention_kt dispatch
    "dinov2_kt": (JaxDino, DinoV2VideoBackbone, "dinov2-video-all-tokens", dict(default_image_size=120, num_frames=2),
                  dict(image_size=120, hidden_size=128, intermediate_size=256, num_heads=2, num_layers=2,
                       num_cls_tokens=1, num_register_tokens=4, use_layerscale=True), (1, 2, 3, 120, 120)),
    "siglip": (JaxSiglip, SiglipVideoBackbone, "siglip-vit-b16-224px-all-no-cls",
               dict(default_image_size=32, num_frames=4),
               dict(num_cls_tokens=0, pos_embed_includes_prefix=False, act="gelu_tanh"), (2, 4, 3, 32, 32)),
    # 4 frames in temporal windows of 2: two windows
    "languagebind": (JaxLangBind, LangBindVideoBackbone, "languagebind-video-noclass",
                     dict(default_image_size=32, num_frames=4),
                     dict(num_cls_tokens=1, pre_norm=True, patch_bias=False, temporal_attn=True, temporal_frames=2,
                          act="quick_gelu", layer_norm_eps=1e-5), (2, 3, 4, 32, 32)),
    "vivit": (JaxViVIT, ViVITVideoBackbone, "vivit-google-b-all-no-cls-16frames",
              dict(default_image_size=32, num_frames=8),
              dict(num_cls_tokens=1, tubelet_t=2, tubelet_frames=8, act="gelu_tanh"), (1, 8, 3, 32, 32)),
    # 32 tubelet slices of 8x8 patches + cls = 2049 tokens: the flash dispatch
    "vivit_flash": (JaxViVIT, ViVITVideoBackbone, "vivit-google-b-all-no-cls-16frames",
                    dict(default_image_size=32, num_frames=64),
                    dict(patch_size=4, hidden_size=64, intermediate_size=64, num_heads=1, num_layers=1,
                         num_cls_tokens=1, tubelet_t=2, tubelet_frames=64, act="gelu_tanh"), (1, 64, 3, 32, 32)),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize_layerscale(tree, rng):
    """LayerScale inits at 1e-5, which would hide the layers from the comparison."""
    if isinstance(tree, dict):
        return {k: (rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32) if k == "gamma"
                    else _randomize_layerscale(v, rng)) for k, v in tree.items()}
    return tree


def _jax_tower(name):
    jcls, _, vb_id, kw, over, _ = TOWERS[name]
    tiny = jax_tiny_vit(**over)
    cls = type(f"Tiny{jcls.__name__}", (jcls,), {"vit_config": property(lambda self: dataclasses.replace(tiny))})
    return cls(vb_id, "resize-naive", **kw)


def _port_tower(name):
    _, pcls, vb_id, kw, over, _ = TOWERS[name]
    return pcls(vb_id, "resize-naive", vit_config=tiny_vit_config(**over), device=CPU, **kw)


def _load(module, np_tree):
    module.load_state_dict(state_dict_from_jax(np_tree), strict=True)
    return module


def test_bridge_carries_a_jax_init():
    cfg = dict(num_cls_tokens=1, num_register_tokens=4, use_layerscale=True, temporal_attn=True, pre_norm=True)
    params = _np_tree(JaxViT(jax_tiny_vit(**cfg)).init(jax.random.PRNGKey(1)))
    vit = _load(VisionTransformer(tiny_vit_config(**cfg), device=CPU), params)
    layer1 = params["layers"]
    np.testing.assert_array_equal(vit.layers[1].attn.q_proj.weight.numpy(), layer1["attn"]["q_proj"]["kernel"][1].T)
    np.testing.assert_array_equal(vit.layers[2].t_norm.weight.numpy(), layer1["t_norm"]["scale"][2])
    np.testing.assert_array_equal(vit.layers[0].ls2.gamma.numpy(), layer1["ls2"]["gamma"][0])
    np.testing.assert_array_equal(vit.patch_embed.weight.numpy(), params["patch_embed"]["kernel"].T)
    np.testing.assert_array_equal(vit.register_tokens.numpy(), params["register_tokens"])

    dparams = _np_tree(JaxDecoder(jax_tiny_decoder()).init(jax.random.PRNGKey(2)))
    dec = _load(LlamaDecoder(tiny_decoder_config(), device=CPU), dparams)
    np.testing.assert_array_equal(dec.layers[1].mlp.down_proj.weight.numpy(),
                                  dparams["layers"]["mlp"]["down_proj"]["kernel"][1].T)
    np.testing.assert_array_equal(dec.embed_tokens.weight.numpy(), dparams["embed_tokens"]["embedding"])
    np.testing.assert_array_equal(dec.lm_head.weight.numpy(), dparams["lm_head"]["kernel"].T)


@pytest.mark.parametrize("name", list(TOWERS))
def test_tower_matches_jax(name):
    jbb, pbb = _jax_tower(name), _port_tower(name)
    params = _randomize_layerscale(_np_tree(jbb.init(jax.random.PRNGKey(3))), np.random.RandomState(3))
    _load(pbb.vit, params)
    video = np.random.RandomState(4).randn(*TOWERS[name][5]).astype(np.float32)
    ref = np.asarray(jbb(params, jnp.asarray(video)))
    with torch.inference_mode():
        out = pbb(torch.from_numpy(video)).numpy()
    assert out.shape == ref.shape == (video.shape[0], pbb.num_patches, pbb.embed_dim)
    np.testing.assert_allclose(out, ref, **TOL)


def test_projector_and_fusion_match_jax():
    rng = np.random.RandomState(5)
    proj = JaxPool3D(32, 48, output_frames=2, output_size=2, mlp_type="linear")
    pparams = _np_tree(proj.init(jax.random.PRNGKey(5)))
    x = rng.randn(2, 4, 9, 32).astype(np.float32)  # [B, F, 3x3, C] -> pooled 2 x 2x2
    port_proj = _load(AveragePooling3DProjector(32, 48, 2, 2, "linear", device=CPU), pparams)
    with torch.inference_mode():
        out = port_proj(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(proj(pparams, jnp.asarray(x))), **TOL)

    fusion = JaxFusion(embed_dim=32, llm_dim=48, token_length=8, averagetoken=True, num_encoder=3)
    fparams = _np_tree(fusion.init(jax.random.PRNGKey(6)))
    V = [rng.randn(2, 8, 48).astype(np.float32) for _ in range(3)]
    port_fusion = _load(
        CrossAttentionAdapterLearnableQuery(embed_dim=32, llm_dim=48, token_length=8, averagetoken=True,
                                            num_encoder=3, device=CPU), fparams)
    ref_fused, ref_w = fusion(fparams, [jnp.asarray(v) for v in V])
    with torch.inference_mode():
        fused, w = port_fusion([torch.from_numpy(v) for v in V])
    np.testing.assert_allclose(fused.numpy(), np.asarray(ref_fused), **TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), **TOL)


def _prompt_batch(rng, B=2, T=8, pad_row=1, n_pad=3):
    ids = rng.randint(3, 250, size=(B, T)).astype(np.int32)
    ids[:, 0] = 1
    mask = np.ones((B, T), np.int32)
    mask[pad_row, T - n_pad:] = 0
    ids[pad_row, T - n_pad:] = 0
    return ids, mask


def test_decoder_matches_jax():
    """Tiny GQA decoder (4 heads over 2 kv heads): no-cache logits and greedy
    cache-prefill + decode tokens on a right-padded batch."""
    jdec = JaxDecoder(jax_tiny_decoder(compute_dtype=jnp.float32))
    params = _np_tree(jdec.init(jax.random.PRNGKey(7)))
    dec = _load(LlamaDecoder(tiny_decoder_config(compute_dtype=torch.float32), device=CPU), params)
    ids, mask = _prompt_batch(np.random.RandomState(7), T=12)
    ref_logits, _ = jdec(params, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    with torch.inference_mode():
        logits, _ = dec(input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)

    ref_tokens = jax_generate(jdec, params, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                              config=JaxGenConfig(max_new_tokens=6))
    tokens = generate(dec, input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask),
                      config=GenerationConfig(max_new_tokens=6))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))


MERV_TOWERS = ("languagebind", "dinov2", "vivit", "siglip")


def _merv_pair():
    kw = dict(arch_specifier="no-align+3davg+linear", feature_fusion="cross_attention_avg_lq",
              projector_token_length=4, visual_feature_length=16, text_embedding_dim=32)
    jm = JaxMERV("tiny-merv", [_jax_tower(n) for n in MERV_TOWERS], jax_tiny_llm(compute_dtype=jnp.float32), **kw)
    pm = MERV("tiny-merv", [_port_tower(n) for n in MERV_TOWERS],
              tiny_llm_backbone(compute_dtype=torch.float32, device=CPU), device=CPU, **kw)
    params = _randomize_layerscale(_np_tree(jm.init(jax.random.PRNGKey(8))), np.random.RandomState(8))
    pm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, pm, params


def test_tiny_merv_matches_jax():
    """Four tiny towers -> 3davg+linear -> cross_attention_avg_lq -> tiny Llama:
    logits within 1e-4 and identical greedy tokens for 8 new tokens, on a batch
    with one right-padded row and one text-only row."""
    jm, pm, params = _merv_pair()
    rng = np.random.RandomState(9)
    ids, mask = _prompt_batch(rng)
    is_mm = np.array([True, False])
    vids = [rng.randn(2, *vb.default_video_resolution).astype(np.float32) for vb in pm.video_backbones]

    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    labels[:, 0] = -100
    ref = jm.forward(params, jnp.asarray(ids), jnp.asarray(mask), [jnp.asarray(v) for v in vids],
                     labels=jnp.asarray(labels), is_multimodal=jnp.asarray(is_mm))
    t_ids, t_mask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    t_vids, t_mm = [torch.from_numpy(v) for v in vids], torch.from_numpy(is_mm)
    out = pm.forward(t_ids, t_mask, t_vids, labels=torch.from_numpy(labels).long(), is_multimodal=t_mm)
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(ref["logits"]), **TOL)
    np.testing.assert_allclose(out["mixer"].numpy(), np.asarray(ref["mixer"]), **TOL)
    np.testing.assert_array_equal(out["labels"].numpy(), np.asarray(ref["labels"]))
    np.testing.assert_allclose(out["loss"].item(), float(ref["loss"]), **TOL)

    ref_tokens = jm.generate_ids(params, jnp.asarray(ids), jnp.asarray(mask), [jnp.asarray(v) for v in vids],
                                 is_multimodal=jnp.asarray(is_mm), max_new_tokens=8)
    tokens = pm.generate_ids(t_ids, t_mask, t_vids, is_multimodal=t_mm, max_new_tokens=8)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))


# the per-tower transforms of the main path (LanguageBind's shortest-edge crop, DINOv2/SigLIP's
# naive bicubic resize, ViViT's 256-edge crop) plus letterbox, downsampling and upsampling
TRANSFORMS = {
    "naive_bicubic": dict(target_size=32, resize_strategy="resize-naive", interpolation="bicubic"),
    "crop_bilinear_cthw": dict(target_size=32, resize_strategy="resize-crop", shortest_edge=32,
                               interpolation="bilinear", channels_first_time=True),
    "crop_256_style": dict(target_size=32, resize_strategy="resize-crop", shortest_edge=36, interpolation="bilinear"),
    "letterbox": dict(target_size=32, resize_strategy="letterbox", interpolation="bicubic"),
    "naive_upsample": dict(target_size=64, resize_strategy="resize-naive", interpolation="bicubic"),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_video_transform_matches_jax(name):
    """uint8 video -> normalized frames; antialiased interpolate vs jax.image.resize."""
    video = np.random.RandomState(10).randint(0, 256, size=(4, 40, 50, 3)).astype(np.uint8)
    kw = TRANSFORMS[name]
    ref = np.asarray(JaxVideoTransform(**kw)(jnp.asarray(video)))
    out = VideoTransform(**kw)(torch.from_numpy(video)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize(
    "cfg", [dict(temperature=0.7, top_k=5), dict(top_p=0.8), dict(temperature=1.3, top_k=20, top_p=0.5)]
)
def test_sampling_filters_match_jax(cfg):
    logits = np.random.RandomState(11).randn(3, 64).astype(np.float32) * 3
    ref = np.asarray(jax_filter_logits(jnp.asarray(logits), JaxGenConfig(do_sample=True, **cfg)))
    out = _filter_logits(torch.from_numpy(logits), GenerationConfig(do_sample=True, **cfg)).numpy()
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    np.testing.assert_allclose(out[~np.isinf(out)], ref[~np.isinf(ref)], **TOL)
    cur_len = np.array([1, 4, 9])
    ref = np.asarray(jax_ban_eos(jnp.asarray(logits), jnp.asarray(cur_len), JaxGenConfig(min_length=5)))
    out = _ban_eos_below_min_length(torch.from_numpy(logits), torch.from_numpy(cur_len), GenerationConfig(min_length=5))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_prompt_and_tokenizer_match_jax():
    jb, pb = JaxPurePromptBuilder("merv"), PurePromptBuilder("merv")
    for builder in (jb, pb):
        builder.add_turn("human", "<image>\nWhat happens?")
        builder.add_turn("gpt", "")
    assert pb.get_prompt() == jb.get_prompt()
    assert pb.get_potential_prompt("And then?") == jb.get_potential_prompt("And then?")
    text = pb.get_potential_prompt("Is it A, B or \u00e9?")
    assert ByteTokenizer()(text).input_ids == JaxByteTokenizer()(text).input_ids
    ids = ByteTokenizer().encode(text)
    assert ByteTokenizer().decode(ids) == JaxByteTokenizer().decode(ids)
