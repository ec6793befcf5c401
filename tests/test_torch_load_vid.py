"""Loading a trained MERV in the port (merv_tpu_torch) against merv_tpu, on tiny models.

Every reader is held against merv_tpu's reader on the same file: the
safetensors reader, tower and LLM weight import, the Orbax checkpoint reader
(without JAX), the reference-format ``.pt`` import. The end-to-end test has
merv_tpu write a run directory with the whole tree (config.json, a checkpoint
of projectors, fusion and LLM, and tower files in $MERV_TPU_TOWER_DIR), loads
it with both packages' ``load_vid`` and asks both the same question about
``assets/video_demo.mp4``: identical greedy tokens, prefill logits within
1e-4 (absolute and relative, as tests/test_crossstack_parity.py holds logits).
Weights are compared exactly (after the same rounding on both sides).
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import merv_tpu.models.load_vid as jax_load_vid_mod
import merv_tpu.preprocessing.video_io as jax_io
import merv_tpu_torch.models.load_vid as port_load_vid_mod
import merv_tpu_torch.preprocessing.video_io as port_io
from merv_tpu.models.backbones.llm.base_llm import LLMBackbone as JaxLLMBackbone
from merv_tpu.models.backbones.llm.base_llm import LLMSpec as JaxLLMSpec
from merv_tpu.models.backbones.llm.hf_import import export_llama_state_dict as jax_export_llama
from merv_tpu.models.backbones.llm.hf_import import load_safetensors_dir as jax_load_safetensors_dir
from merv_tpu.models.backbones.llm.prompting import PurePromptBuilder as JaxPurePromptBuilder
from merv_tpu.models.backbones.llm.tokenization import ByteTokenizer as JaxByteTokenizer
from merv_tpu.models.backbones.llm.tokenization import load_tokenizer as jax_load_tokenizer
from merv_tpu.models.backbones.llm.transformer import tiny_decoder_config as jax_tiny_decoder
from merv_tpu.models.backbones.video import (
    DinoV2VideoBackbone as JaxDino,
    LangBindVideoBackbone as JaxLangBind,
    SiglipVideoBackbone as JaxSiglip,
    ViVITVideoBackbone as JaxViVIT,
)
from merv_tpu.models.backbones.video.vision_import import import_vision_state_dict as jax_import_vision
from merv_tpu.models.backbones.video.vision_import import load_pretrained_tower as jax_load_pretrained_tower
from merv_tpu.models.backbones.video.vit import tiny_vit_config as jax_tiny_vit
from merv_tpu.models.ckpt_import import import_merv_checkpoint as jax_import_merv_checkpoint
from merv_tpu.models.vidlms import MERV as JaxMERV
from merv_tpu.training.checkpointing import load_checkpoint as jax_load_checkpoint
from merv_tpu.training.checkpointing import save_checkpoint as jax_save_checkpoint
from merv_tpu_torch import load_vid
from merv_tpu_torch.bridge import module_state_dicts, state_dict_from_jax
from merv_tpu_torch.models.backbones.llm.base_llm import LLMBackbone, LLMSpec
from merv_tpu_torch.models.backbones.llm.hf_import import load_safetensors_dir
from merv_tpu_torch.models.backbones.llm.prompting import PurePromptBuilder
from merv_tpu_torch.models.backbones.llm.tokenization import ByteTokenizer, load_tokenizer
from merv_tpu_torch.models.backbones.llm.transformer import tiny_decoder_config
from merv_tpu_torch.models.backbones.video import (
    DinoV2VideoBackbone,
    LangBindVideoBackbone,
    SiglipVideoBackbone,
    ViVITVideoBackbone,
)
from merv_tpu_torch.models.backbones.video.vision_import import import_vision_state_dict, load_pretrained_tower
from merv_tpu_torch.models.backbones.video.vit import tiny_vit_config
from merv_tpu_torch.models.ckpt_import import import_merv_checkpoint
from merv_tpu_torch.models.generation import prefill
from merv_tpu_torch.models.vidlms import MERV
from merv_tpu_torch.training.checkpointing import latest_checkpoint, load_checkpoint, read_orbax_tree
from merv_tpu_torch.util.safetensors_io import load_file

REPO = Path(__file__).resolve().parent.parent
DEMO = REPO / "assets" / "video_demo.mp4"
CPU = "cpu"
TOL = dict(atol=1e-4, rtol=1e-4)
D = 64  # tiny tower width (tiny_vit_config)

# tower -> (JAX class, port class, backbone id, kwargs, tiny ViT overrides); merv-full's order
TOWERS = {
    "languagebind": (JaxLangBind, LangBindVideoBackbone, "languagebind-video-noclass",
                     dict(default_image_size=32, num_frames=4),
                     dict(num_cls_tokens=1, pre_norm=True, patch_bias=False, temporal_attn=True, temporal_frames=2,
                          act="quick_gelu", layer_norm_eps=1e-5)),
    "dinov2": (JaxDino, DinoV2VideoBackbone, "dinov2-video-all-tokens", dict(default_image_size=32, num_frames=4),
               dict(num_cls_tokens=1, num_register_tokens=4, use_layerscale=True)),
    "vivit": (JaxViVIT, ViVITVideoBackbone, "vivit-google-b-all-no-cls-16frames",
              dict(default_image_size=32, num_frames=8),
              dict(num_cls_tokens=1, tubelet_t=2, tubelet_frames=8, act="gelu_tanh")),
    "siglip": (JaxSiglip, SiglipVideoBackbone, "siglip-vit-b16-224px-all-no-cls",
               dict(default_image_size=32, num_frames=4),
               dict(num_cls_tokens=0, pos_embed_includes_prefix=False, act="gelu_tanh")),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_state_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# safetensors and the tokenizer
# ---------------------------------------------------------------------------


def test_safetensors_reader_matches_the_library(tmp_path):
    from safetensors.numpy import load_file as np_load_file
    from safetensors.torch import load_file as torch_load_file
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"f32": torch.randn(3, 5, generator=g), "bf16": torch.randn(4, 2, generator=g).bfloat16(),
               "i64": torch.arange(-3, 9).reshape(3, 4), "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 3)}
    save_file(tensors, tmp_path / "t.safetensors", metadata={"format": "pt"})
    got = load_file(tmp_path / "t.safetensors")
    _assert_state_dicts_equal(got, torch_load_file(tmp_path / "t.safetensors"))
    ref_np = np_load_file(str(tmp_path / "t.safetensors"))  # ml_dtypes (through jax) gives numpy a bf16
    for k, v in ref_np.items():
        np.testing.assert_array_equal(got[k].float().numpy(), v.astype(np.float32) if k == "bf16" else v)


def test_offline_tokenizer_choice_matches_jax(tmp_path):
    path = str(tmp_path / "no-tokenizer-here")
    assert isinstance(load_tokenizer(path), ByteTokenizer)
    assert isinstance(jax_load_tokenizer(path), JaxByteTokenizer)
    assert load_tokenizer(path).padding_side == "right"


def test_tokenizer_without_transformers_is_the_byte_tokenizer(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)  # `import transformers` now raises
    assert isinstance(load_tokenizer("meta-llama/Llama-2-7b-hf"), ByteTokenizer)


@pytest.mark.parametrize("where", ["HF_HUB_CACHE", "HF_HOME", "XDG_CACHE_HOME", "absent"])
def test_tokenizer_is_tried_only_where_its_files_could_be(tmp_path, monkeypatch, where):
    """``transformers`` is imported and ``AutoTokenizer`` tried only where the
    tokenizer's files could be found: a snapshot directory in one of the
    Hugging Face caches; with none, the byte tokenizer at once."""
    import types

    from merv_tpu_torch.models.backbones.llm import tokenization as T

    for name in ("HF_HUB_CACHE", "HUGGINGFACE_HUB_CACHE", "TRANSFORMERS_CACHE", "HF_HOME", "MERV_TPU_ONLINE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    hub = {"HF_HUB_CACHE": tmp_path / "c", "HF_HOME": tmp_path / "h" / "hub",
           "XDG_CACHE_HOME": tmp_path / "xdg" / "huggingface" / "hub"}.get(where)
    if hub is not None:
        (hub / "models--org--tok").mkdir(parents=True)
        if where != "XDG_CACHE_HOME":
            monkeypatch.setenv(where, str(hub if where == "HF_HUB_CACHE" else hub.parent))
    tried = []

    def from_pretrained(*a, **k):
        tried.append(a[0])
        raise OSError("no tokenizer files")

    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace(
        AutoTokenizer=types.SimpleNamespace(from_pretrained=from_pretrained)))
    assert isinstance(T.load_tokenizer("org/tok"), ByteTokenizer)
    assert tried == ([] if where == "absent" else ["org/tok"])


# ---------------------------------------------------------------------------
# tower weights: torch-named state dicts in the three namings
# ---------------------------------------------------------------------------


def _hf_state(name):
    """A tiny transformers model's state dict, as tests/test_vit.py builds them."""
    if name == "siglip":
        from transformers import SiglipVisionConfig, SiglipVisionModel

        torch.manual_seed(0)
        return SiglipVisionModel(SiglipVisionConfig(
            hidden_size=D, intermediate_size=128, num_hidden_layers=3, num_attention_heads=4, image_size=32,
            patch_size=8)).state_dict()
    if name == "dinov2":
        from transformers import Dinov2WithRegistersConfig, Dinov2WithRegistersModel

        torch.manual_seed(1)
        model = Dinov2WithRegistersModel(Dinov2WithRegistersConfig(
            hidden_size=D, intermediate_size=128, num_hidden_layers=3, num_attention_heads=4, image_size=32,
            patch_size=8, num_register_tokens=4, layerscale_value=1.0, mlp_ratio=2))
        state = model.state_dict()
        for k in state:  # LayerScale at 1.0 everywhere would hide a swap of ls1 and ls2
            if k.endswith("lambda1"):
                state[k] = torch.rand(D, generator=torch.Generator().manual_seed(len(k))) + 0.5
        return state
    if name == "vivit":
        from transformers import VivitConfig, VivitModel

        torch.manual_seed(2)
        return VivitModel(VivitConfig(
            hidden_size=D, intermediate_size=128, num_hidden_layers=3, num_attention_heads=4, image_size=32,
            num_frames=8, tubelet_size=[2, 8, 8]), add_pooling_layer=False).state_dict()
    raise KeyError(name)


def _random_state(shapes, seed):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for k, s in shapes.items()}


def _languagebind_state(seed=3, layers=3, frames=2):
    """Random arrays under the hf_clip names LanguageBind's video tower has."""
    shapes = {"vision_model.embeddings.class_embedding": (D,),
              "vision_model.embeddings.patch_embedding.weight": (D, 3, 8, 8),
              "vision_model.embeddings.position_embedding.weight": (17, D),
              "vision_model.embeddings.position_ids": (1, 17)}
    for n in ("pre_layrnorm", "post_layernorm"):
        shapes.update({f"vision_model.{n}.weight": (D,), f"vision_model.{n}.bias": (D,)})
    for i in range(layers):
        pre = f"vision_model.encoder.layers.{i}"
        for n in ("layer_norm1", "layer_norm2", "temporal_layer_norm1"):
            shapes.update({f"{pre}.{n}.weight": (D,), f"{pre}.{n}.bias": (D,)})
        for a in ("self_attn", "temporal_attn"):
            for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
                shapes.update({f"{pre}.{a}.{p}.weight": (D, D), f"{pre}.{a}.{p}.bias": (D,)})
        shapes.update({f"{pre}.mlp.fc1.weight": (128, D), f"{pre}.mlp.fc1.bias": (128,),
                       f"{pre}.mlp.fc2.weight": (D, 128), f"{pre}.mlp.fc2.bias": (D,),
                       f"{pre}.temporal_embedding": (1, frames, D)})
    return _random_state(shapes, seed)


def _timm_state(seed, grid, cls_row, layers=3):
    """Random arrays under timm's names (DINOv2-reg): fused qkv, a ``grid`` x ``grid``
    position table (resampled to the config's 4 x 4), with or without a cls row."""
    shapes = {"patch_embed.proj.weight": (D, 3, 8, 8), "patch_embed.proj.bias": (D,),
              "pos_embed": (1, int(cls_row) + grid * grid, D), "cls_token": (1, 1, D), "reg_token": (1, 4, D),
              "norm.weight": (D,), "norm.bias": (D,)}
    for i in range(layers):
        pre = f"blocks.{i}"
        shapes.update({f"{pre}.norm1.weight": (D,), f"{pre}.norm1.bias": (D,), f"{pre}.norm2.weight": (D,),
                       f"{pre}.norm2.bias": (D,), f"{pre}.attn.qkv.weight": (3 * D, D), f"{pre}.attn.qkv.bias": (3 * D,),
                       f"{pre}.attn.proj.weight": (D, D), f"{pre}.attn.proj.bias": (D,),
                       f"{pre}.mlp.fc1.weight": (128, D), f"{pre}.mlp.fc1.bias": (128,),
                       f"{pre}.mlp.fc2.weight": (D, 128), f"{pre}.mlp.fc2.bias": (D,),
                       f"{pre}.ls1.gamma": (D,), f"{pre}.ls2.gamma": (D,)})
    return _random_state(shapes, seed)


def _tower_state(name):
    if name == "languagebind":
        return _languagebind_state()
    if name == "timm_dinov2_resampled":
        return _timm_state(4, grid=6, cls_row=True)
    if name == "timm_dinov2_no_cls_row":
        return _timm_state(5, grid=4, cls_row=False)
    return _hf_state(name)


def _tower_cfgs(name):
    over = TOWERS["dinov2" if name.startswith("timm") else name][4]
    return jax_tiny_vit(**over), tiny_vit_config(**over)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "name", ["siglip", "dinov2", "vivit", "languagebind", "timm_dinov2_resampled", "timm_dinov2_no_cls_row"])
def test_tower_import_matches_jax(name, dtype):
    """siglip and languagebind: hf_clip; dinov2 and vivit (Conv3d): hf_vit; timm: fused qkv."""
    state = _tower_state(name)
    jcfg, pcfg = _tower_cfgs(name)
    want = state_dict_from_jax(_np_tree(jax_import_vision(jcfg, state, param_dtype=getattr(jnp, dtype))))
    got = import_vision_state_dict(pcfg, state, param_dtype=getattr(torch, dtype))
    _assert_state_dicts_equal(got, want)


def _jax_tower(name, half=None):
    jcls, _, vb_id, kw, over = TOWERS[name]
    tiny = jax_tiny_vit(**over)
    attrs = {"vit_config": property(lambda self: dataclasses.replace(tiny))}
    if half is not None:
        attrs["half_precision_dtype"] = property(lambda self: half)
    return type(f"Tiny{jcls.__name__}", (jcls,), attrs)(vb_id, "resize-naive", **kw)


def _port_tower(name, half=None, device=CPU):
    _, pcls, vb_id, kw, over = TOWERS[name]
    cls = pcls if half is None else type(f"Tiny{pcls.__name__}", (pcls,),
                                         {"half_precision_dtype": property(lambda self: half)})
    return cls(vb_id, "resize-naive", vit_config=tiny_vit_config(**over), device=device, **kw)


def _write_tower_dir(tower_dir, names):
    from safetensors.torch import save_file

    tower_dir.mkdir(parents=True, exist_ok=True)
    for name in names:
        state = {k: v.contiguous() for k, v in _tower_state(name).items()}
        save_file(state, tower_dir / f"{TOWERS[name][2]}.safetensors")


@pytest.mark.parametrize("name", list(TOWERS))
def test_tower_dir_route_matches_jax(name, tmp_path, monkeypatch):
    """$MERV_TPU_TOWER_DIR/{identifier}.safetensors through both packages' resolvers."""
    monkeypatch.setenv("MERV_TPU_TOWER_DIR", str(tmp_path))
    _write_tower_dir(tmp_path, [name])
    want = state_dict_from_jax(_np_tree(jax_load_pretrained_tower(_jax_tower(name))))  # bf16, merv_tpu's default
    tower = _port_tower(name)
    load_pretrained_tower(tower)
    got = tower.vit.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:  # the port's tiny tower stores fp32: the bf16-rounded values, widened
        assert torch.equal(got[k], want[k].float()), k


def test_tower_dir_route_raises_without_a_file(tmp_path, monkeypatch):
    monkeypatch.setenv("MERV_TPU_TOWER_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="scripts/export_towers.py"):
        load_pretrained_tower(_port_tower("siglip"))


# ---------------------------------------------------------------------------
# LLM weights: $MERV_TPU_LLM_DIR
# ---------------------------------------------------------------------------


def _jax_llm(half=jnp.bfloat16, inference_mode=True):
    spec = JaxLLMSpec("tiny", "__offline__/tiny", jax_tiny_decoder(compute_dtype=jnp.float32), JaxPurePromptBuilder,
                      half_precision_dtype=half, has_bos=True, pad_token_id=0, eos_token_id=2)
    return JaxLLMBackbone("tiny-pure", llm_max_length=512, inference_mode=inference_mode, spec=spec)


def _port_llm(half=torch.bfloat16, inference_mode=True, device=CPU):
    spec = LLMSpec("tiny", "__offline__/tiny", tiny_decoder_config(compute_dtype=torch.float32), PurePromptBuilder,
                   half_precision_dtype=half, has_bos=True, pad_token_id=0, eos_token_id=2)
    return LLMBackbone("tiny-pure", llm_max_length=512, inference_mode=inference_mode, spec=spec, device=device)


def _write_llm_dir(llm_dir, rows_cut=0):
    """An HF-named safetensors dir, in two shards, from a tiny merv_tpu init
    (``rows_cut`` vocabulary rows dropped: the importers pad them with the mean row)."""
    from safetensors.numpy import save_file

    llm = _jax_llm(inference_mode=False)
    state = jax_export_llama(llm.decoder_config, _np_tree(llm.init(jax.random.PRNGKey(11))))
    if rows_cut:
        for k in ("model.embed_tokens.weight", "lm_head.weight"):
            state[k] = state[k][:-rows_cut]
    keys = sorted(state)
    llm_dir.mkdir(parents=True, exist_ok=True)
    for i, part in enumerate((keys[::2], keys[1::2])):
        save_file({k: np.ascontiguousarray(state[k]) for k in part}, str(llm_dir / f"model-{i + 1:05d}-of-00002.safetensors"))
    (llm_dir / "model.safetensors.index.json").write_text(json.dumps({"weight_map": {k: "?" for k in keys}}))


@pytest.mark.parametrize("rows_cut", [0, 3])
def test_llm_dir_import_matches_jax(rows_cut, tmp_path):
    _write_llm_dir(tmp_path, rows_cut)
    jllm = _jax_llm(inference_mode=False)
    ref_state = jax_load_safetensors_dir(tmp_path)
    state = load_safetensors_dir(tmp_path)
    assert sorted(state) == sorted(ref_state)
    for dtype in ("float32", "bfloat16"):
        want = state_dict_from_jax(_np_tree(jllm.load_state_dict(ref_state, param_dtype=getattr(jnp, dtype))))
        llm = _port_llm(half=getattr(torch, dtype))  # stored in the import dtype: nothing rounds twice
        llm.import_state_dict(state, param_dtype=getattr(torch, dtype))
        _assert_state_dicts_equal(llm.decoder.state_dict(), want)


# ---------------------------------------------------------------------------
# checkpoints: merv_tpu's Orbax layout and the reference .pt layout
# ---------------------------------------------------------------------------

KW = dict(arch_specifier="3davg+linear", feature_fusion="cross_attention_avg_lq", projector_token_length=4,
          visual_feature_length=16, text_embedding_dim=32)


def _jax_merv(half=jnp.bfloat16):
    return JaxMERV("tiny-merv", [_jax_tower(n) for n in TOWERS], _jax_llm(half), **KW)


def _port_merv(half=torch.bfloat16):
    return MERV("tiny-merv", [_port_tower(n) for n in TOWERS], _port_llm(half), device=CPU, **KW)


def _trainables(jm, seed=12):
    """fp32 projectors and fusion, every leaf random (the init's zero biases
    would hide a misplaced one), and the LLM's init in bf16."""
    params = _np_tree(jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for k in ("projectors", "feature_fusion"):
        params[k] = jax.tree_util.tree_map(lambda x: rng.normal(0, 0.05, np.shape(x)).astype(np.float32), params[k])
    params["llm_backbone"] = jax.tree_util.tree_map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)),
                                                    params["llm_backbone"])
    return {k: params[k] for k in ("projectors", "feature_fusion", "llm_backbone")}


def test_orbax_checkpoint_reads_without_jax_as_merv_tpu_reads_it(tmp_path):
    """fp32 projectors and fusion, a bf16 LLM, through the latest-checkpoint symlink."""
    params = _trainables(_jax_merv())
    jax_save_checkpoint(tmp_path, 7, 3, 1.25, params, list(params), opt_state={"count": jnp.int32(3)})
    path = latest_checkpoint(tmp_path)
    assert path.name.startswith("step-000007-epoch-03")
    ref = jax_load_checkpoint(path)
    got = load_checkpoint(tmp_path / "checkpoints" / "latest-checkpoint")
    assert (got["step"], got["epoch"]) == (ref["step"], ref["epoch"]) == (7, 3)
    assert "optimizer" in ref and "optimizer" not in got  # optax's state is not read
    want = module_state_dicts(_np_tree(ref["model"]))
    assert sorted(got["model"]) == sorted(want) == ["feature_fusion", "llm_backbone", "projectors"]
    for key in want:
        _assert_state_dicts_equal(got["model"][key], want[key])
    assert got["model"]["llm_backbone"]["decoder.embed_tokens.weight"].dtype == torch.bfloat16
    assert got["model"]["projectors"]["0.projector.projector.weight"].dtype == torch.float32
    _port_merv().load_state_dict({f"{k}.{n}": t for k, sd in got["model"].items() for n, t in sd.items()},
                                 strict=False)


@pytest.mark.parametrize("layout", ["ocdbt_zarr", "file_zarr", "ocdbt_zarr3"])
def test_orbax_layouts_read_as_orbax_restores_them(layout, tmp_path):
    import orbax.checkpoint as ocp

    tree = {"model": {"projectors": {"0": {"kernel": jnp.arange(12.0).reshape(3, 4)}},
                      "llm_backbone": {"w": jnp.linspace(-1, 1, 6, dtype=jnp.bfloat16).reshape(2, 3)}},
            "optimizer": {"count": jnp.int32(5), "empty": {}}}
    handler = {"ocdbt_zarr": ocp.PyTreeCheckpointHandler(),
               "file_zarr": ocp.PyTreeCheckpointHandler(use_ocdbt=False),
               "ocdbt_zarr3": ocp.PyTreeCheckpointHandler(use_zarr3=True)}[layout]
    ckptr = ocp.Checkpointer(handler)
    ckptr.save((tmp_path / "ckpt").resolve(), tree)
    ref = _np_tree(ckptr.restore((tmp_path / "ckpt").resolve()))
    got = read_orbax_tree(tmp_path / "ckpt")
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_orbax_reader_needs_tensorstore(tmp_path, monkeypatch):
    jax_save_checkpoint(tmp_path, 1, 0, 0.5, {"projectors": {"0": {"b": jnp.ones(2)}}}, ["projectors"])
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        load_checkpoint(latest_checkpoint(tmp_path))


def _reference_pt(params, legacy=False, in_proj_bias=True, llm=False):
    """The released reference layout: torch module state dicts (MHA's packed in_proj_bias)."""
    sd = state_dict_from_jax({k: params[k] for k in ("projectors", "feature_fusion")})
    model = {"projectors": {}, "feature_fusion": {}}
    for k, t in sd.items():
        if k.startswith("projectors."):
            model["projectors"][k.removeprefix("projectors.")] = t
        elif k.startswith("feature_fusion."):
            name = k.removeprefix("feature_fusion.")
            for p in ("q_proj", "k_proj", "v_proj"):
                name = name.replace(f"attention.{p}.weight", f"attention.{p}_weight")
            if not name.endswith(("q_proj.bias", "k_proj.bias", "v_proj.bias")):
                model["feature_fusion"][name] = t
    if in_proj_bias:
        model["feature_fusion"]["attention.in_proj_bias"] = torch.cat(
            [sd[f"feature_fusion.attention.{p}.bias"] for p in ("q_proj", "k_proj", "v_proj")])
    if llm:  # HF names under the reference's `llm.` wrapper, in bf16
        jllm = _jax_llm(inference_mode=False)
        hf = jax_export_llama(jllm.decoder_config, jax.tree_util.tree_map(np.float32, params["llm_backbone"]))
        model["llm_backbone"] = {f"llm.{k}": torch.from_numpy(np.array(v)).bfloat16() for k, v in hf.items()}
    if legacy:  # one encoder's projector key, and the fusion as `adapter`
        model["projector"] = {k.removeprefix("0."): v for k, v in model.pop("projectors").items()
                              if k.startswith("0.")}
        model["adapter"] = model.pop("feature_fusion")
    return {"model": model, "optimizer": {}}


@pytest.mark.parametrize("case", ["current", "no_in_proj_bias", "with_llm", "legacy_keys"])
def test_reference_pt_import_matches_jax(case, tmp_path):
    legacy = case == "legacy_keys"
    if legacy:  # the legacy layout has one encoder
        jm = JaxMERV("tiny-merv", [_jax_tower("siglip")], _jax_llm(), **KW)
        pm = MERV("tiny-merv", [_port_tower("siglip")], _port_llm(), device=CPU, **KW)
    else:
        jm, pm = _jax_merv(), _port_merv()
    params = _trainables(jm)
    ckpt = _reference_pt(params, legacy=legacy, in_proj_bias=case != "no_in_proj_bias", llm=case == "with_llm")
    torch.save(ckpt, tmp_path / "latest-checkpoint.pt")
    ref = _np_tree(jax_import_merv_checkpoint(jm, str(tmp_path / "latest-checkpoint.pt")))
    got = import_merv_checkpoint(pm, tmp_path / "latest-checkpoint.pt")
    want = state_dict_from_jax(ref)
    flat = {f"{k}.{n}": t for k, sd in got.items() for n, t in sd.items()}
    _assert_state_dicts_equal(flat, want)
    if case == "no_in_proj_bias":
        assert not got["feature_fusion"]["attention.q_proj.bias"].any()


# ---------------------------------------------------------------------------
# end to end: a run directory with the whole tree, both load_vids, one question
# ---------------------------------------------------------------------------

RUN_CONFIG = {
    "model_id": "merv-full", "arch_specifier": "3davg+linear", "feature_fusion": "cross_attention_avg_lq",
    "video_backbone_ids": [TOWERS[n][2] for n in TOWERS], "llm_backbone_id": "llama2-7b-pure",
    "image_resize_strategy": "resize-naive", "llm_max_length": 512, "num_frames": [4, 4, 8, 4],
    "projector_token_length": 4, "visual_feature_length": 16, "type": "merv-full",
}


@pytest.fixture
def run_dir(tmp_path, monkeypatch):
    """merv_tpu writes config.json, an Orbax checkpoint of projectors, fusion and
    a bf16 LLM, and the towers' torch-named files; both packages' load_vid
    modules get the tiny backbones (fp32 as their half precision)."""
    run = tmp_path / "run"
    (run / "checkpoints").mkdir(parents=True)
    (run / "config.json").write_text(json.dumps({"model": RUN_CONFIG}))
    jax_save_checkpoint(run, 1, 0, 0.5, _trainables(_jax_merv(jnp.float32)),
                        ["projectors", "feature_fusion", "llm_backbone"])
    _write_tower_dir(tmp_path / "towers", list(TOWERS))
    monkeypatch.setenv("MERV_TPU_TOWER_DIR", str(tmp_path / "towers"))
    monkeypatch.delenv("MERV_TPU_LLM_DIR", raising=False)

    monkeypatch.setattr(jax_load_vid_mod, "get_video_backbone_and_transform",
                        lambda *a, **k: ([_jax_tower(n, jnp.float32) for n in TOWERS], []))
    monkeypatch.setattr(jax_load_vid_mod, "get_llm_backbone_and_tokenizer",
                        lambda *a, **k: (_jax_llm(jnp.float32), None))
    monkeypatch.setattr(jax_load_vid_mod, "get_vidlm",
                        lambda model_id, arch, fusion, vbs, llm, **k: JaxMERV(
                            model_id, vbs, llm, arch_specifier=arch, feature_fusion=fusion,
                            projector_token_length=k["projector_token_length"],
                            visual_feature_length=k["visual_feature_length"], text_embedding_dim=32))
    monkeypatch.setattr(port_load_vid_mod, "get_video_backbone_and_transform",
                        lambda *a, device=None, **k: ([_port_tower(n, torch.float32, device) for n in TOWERS], []))
    monkeypatch.setattr(port_load_vid_mod, "get_llm_backbone_and_tokenizer",
                        lambda *a, device=None, **k: (_port_llm(torch.float32, device=device), None))
    monkeypatch.setattr(port_load_vid_mod, "get_vidlm",
                        lambda model_id, arch, fusion, vbs, llm, device=None, **k: MERV(
                            model_id, vbs, llm, arch_specifier=arch, feature_fusion=fusion,
                            projector_token_length=k["projector_token_length"],
                            visual_feature_length=k["visual_feature_length"], text_embedding_dim=32, device=device))
    # one decode backend on both sides
    try:
        port_io.open_video(str(DEMO), backend="cv2").close()
    except Exception as e:
        pytest.skip(f"cv2 cannot open the demo video here: {e}")
    monkeypatch.setattr(jax_io, "_BACKENDS", ("cv2",))
    monkeypatch.setattr(port_io, "BACKENDS", {"cv2": port_io.Cv2VideoReader})
    return run


def test_load_vid_answers_as_merv_tpu_does(run_dir):
    jm, jparams = jax_load_vid_mod.load_vid(str(run_dir))
    pm, cfg = load_vid(run_dir, get_model_cfg=True, device=CPU)
    assert cfg.num_frames == RUN_CONFIG["num_frames"] and cfg.model_id == "merv-full"

    # every weight as merv_tpu assembled it, in its dtype and its default (packed) serving layout
    _assert_state_dicts_equal(pm.state_dict(), state_dict_from_jax(_np_tree(jparams)))
    assert {p.device.type for p in pm.parameters()} == {"cpu"}
    assert "qkv_proj" in pm.llm_backbone.decoder.layers[0].attn._modules

    # the question, on the demo video
    prompt = pm.llm_backbone.prompt_builder_fn("merv").get_potential_prompt("What is happening in this video?")
    nf = cfg.num_frames
    ids, mask, vids, is_mm = pm._prepare_batch_inputs([DEMO], [prompt], nf)
    jids, jmask, jvids, jis_mm = jm._prepare_batch_inputs([DEMO], [prompt], nf)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    for v, jv in zip(vids, jvids):
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)

    tokens = pm.generate_ids(ids, mask, vids, is_multimodal=is_mm, max_new_tokens=16)
    ref_tokens = jm.generate_ids(jparams, jids, jmask, jvids, is_multimodal=jis_mm, max_new_tokens=16)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
    assert pm.generate(DEMO, prompt, num_frames=nf, max_new_tokens=16) == \
        jm.generate(jparams, DEMO, prompt, num_frames=nf, max_new_tokens=16)

    embeds, emask = pm.build_inputs_embeds(ids, mask, vids, is_mm)
    logits, _, n_valid = prefill(pm.llm_backbone.decoder, embeds, emask.long(), embeds.shape[1] + 16)
    ref = jm.forward(jparams, jids, jmask, jvids, is_multimodal=jis_mm)
    last = int(np.asarray(ref["attention_mask"]).sum()) - 1
    assert int(n_valid[0]) - 1 == last
    np.testing.assert_allclose(logits[0].numpy(), np.asarray(ref["logits"])[0, last], **TOL)


def test_load_vid_quantize_llm_answers_as_merv_tpu_does(run_dir):
    """``quantize_llm=True`` in both packages: every weight equal (the LLM's
    packed int8 values and scales carried over by the bridge), and with an int8
    KV cache the same greedy tokens on the demo question, both in the default
    (packed) int8 serving layout; unpacked, each Linear's bytes are the
    packed ones' columns."""
    jm, jparams = jax_load_vid_mod.load_vid(str(run_dir), quantize_llm=True)
    pm, cfg = load_vid(run_dir, get_model_cfg=True, quantize_llm=True, device=CPU)
    _assert_state_dicts_equal(pm.state_dict(), state_dict_from_jax(_np_tree(jparams)))
    assert pm.llm_backbone.decoder.layers[0].attn.qkv_proj.weight_q.dtype == torch.int8
    _, junpacked = jax_load_vid_mod.load_vid(str(run_dir), pack_llm=False, quantize_llm=True)
    unpacked = load_vid(run_dir, quantize_llm=True, pack_llm=False, device=CPU)
    _assert_state_dicts_equal(unpacked.state_dict(), state_dict_from_jax(_np_tree(junpacked)))
    qkv = pm.llm_backbone.decoder.layers[1].attn.qkv_proj.weight_q
    parts = unpacked.llm_backbone.decoder.layers[1].attn
    assert torch.equal(qkv, torch.cat([parts.q_proj.weight_q, parts.k_proj.weight_q, parts.v_proj.weight_q]))
    prompt = pm.llm_backbone.prompt_builder_fn("merv").get_potential_prompt("What is happening in this video?")
    nf = cfg.num_frames
    assert pm.generate(DEMO, prompt, num_frames=nf, max_new_tokens=16, kv_cache_dtype="int8") == \
        jm.generate(jparams, DEMO, prompt, num_frames=nf, max_new_tokens=16, kv_cache_dtype="int8")


def test_load_vid_errors(run_dir):
    next((Path(run_dir).parent / "towers").glob("dinov2*")).unlink()
    with pytest.raises(RuntimeError, match="dinov2-video-all-tokens"):
        jax_load_vid_mod.load_vid(str(run_dir))
    with pytest.raises(RuntimeError, match="dinov2-video-all-tokens"):
        load_vid(run_dir, device=CPU)
    with pytest.raises(ValueError, match="local run directory"):
        load_vid("merv-full", device=CPU)
