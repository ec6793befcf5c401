"""Every LLM family merv_tpu registers, in the port (merv_tpu_torch) against merv_tpu, on tiny decoders.

Each of the eleven ``llm_backbone_id``s gets a tiny decoder that keeps its
family's quirks: the GQA group (1 for Llama-2 / Vicuna 7B and 13B, 4 for
Llama-3 / 3.1, 7 for Qwen-2.5-7B, 8 for Qwen-2.5-3B), Qwen's q/k/v biases and
rms eps, Qwen-3B's tied head, the rope theta; the ids that share a tiny
decoder share one merv_tpu random init (computed once). Weights: merv_tpu's
init carried over by merv_tpu_torch.bridge; inputs from numpy seeds.

Limits: fp32 logits within 1e-4 (absolute and relative, as
tests/test_crossstack_parity.py holds them) and identical greedy tokens
through the cache and the decode step; the packed serving layout within 1e-5
of the unpacked one in fp32 (tests/test_llm.py holds merv_tpu's packing so:
a wide and a narrow GEMM sum in different orders); the port's fp16- or
bf16-stored inference mode (bf16 compute) against merv_tpu's
``inference_mode=True`` within ``BF16_LOGITS`` below; and storage rounded once
to bf16 against the per-call cast, bit for bit.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import merv_tpu.models.load_vid as jax_load_vid_mod
import merv_tpu_torch.models.load_vid as port_load_vid_mod
from merv_tpu.models.backbones.llm.base_llm import LLM_SPECS as JAX_LLM_SPECS
from merv_tpu.models.backbones.llm.base_llm import LLMBackbone as JaxLLMBackbone
from merv_tpu.models.backbones.llm.base_llm import LLMSpec as JaxLLMSpec
from merv_tpu.models.backbones.llm.base_llm import tiny_llm_backbone as jax_tiny_llm
from merv_tpu.models.backbones.llm.hf_import import export_llama_state_dict as jax_export_llama
from merv_tpu.models.backbones.llm.hf_import import import_llama_state_dict as jax_import_llama
from merv_tpu.models.backbones.llm.prompting import Qwen2PromptBuilder as JaxQwen2PromptBuilder
from merv_tpu.models.backbones.llm.transformer import LlamaDecoder as JaxDecoder
from merv_tpu.models.backbones.llm.transformer import pack_serving_params as jax_pack_serving_params
from merv_tpu.models.backbones.llm.transformer import tiny_decoder_config as jax_tiny_decoder
from merv_tpu.models.generation import GenerationConfig as JaxGenConfig
from merv_tpu.models.generation import generate as jax_generate
from merv_tpu.models.vidlms import MERV as JaxMERV
from merv_tpu_torch.bridge import state_dict_from_jax
from merv_tpu_torch.conf import ModelConfig, ModelRegistry
from merv_tpu_torch import load_vid
from merv_tpu_torch.models.backbones.llm.base_llm import LLM_SPECS, LLMBackbone, LLMSpec, tiny_llm_backbone
from merv_tpu_torch.models.backbones.llm.hf_import import import_llama_state_dict
from merv_tpu_torch.models.backbones.llm.prompting import Qwen2PromptBuilder
from merv_tpu_torch.models.backbones.llm.transformer import (
    LlamaDecoder,
    pack_serving_params,
    round_to_compute_dtype,
    tiny_decoder_config,
)
from merv_tpu_torch.models.generation import GenerationConfig, generate, prefill
from merv_tpu_torch.models.materialize import get_llm_backbone_and_tokenizer
from merv_tpu_torch.models.vidlms import MERV
from test_torch_generation_shared import MERV_KW, TOWERS, _videos
from test_torch_load_vid import _assert_state_dicts_equal, _jax_tower, _port_tower, _trainables, _write_tower_dir
from test_torch_load_vid import KW as LOAD_KW
from test_torch_load_vid import TOWERS as LOAD_TOWERS

IDS = list(JAX_LLM_SPECS)
TOL = dict(atol=1e-4, rtol=1e-4)
PACKED_TOL = dict(atol=1e-5, rtol=1e-5)
# bf16 compute in both packages on the same half-precision weights: the same
# roundings in the same places, but each library's GEMMs sum in their own
# order before rounding to bf16, so logits may differ by a few bf16 ulps of
# their scale, compounded over two layers: |diff| <= 2**-5 * max|ref|
BF16_LOGITS = 2 ** -5
CPU = torch.device("cpu")
VOCAB = 320


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tiny_family(llm_id: str) -> dict:
    """The tiny decoder of ``llm_id``'s family: its GQA group, bias, tied head,
    rope theta and rms eps at two layers and narrow widths."""
    c = LLM_SPECS[llm_id].decoder_config
    group = c.num_heads // c.num_kv_heads
    kv = 2 if group <= 4 else 1
    return dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=96, num_layers=2, num_heads=group * kv,
                num_kv_heads=kv, head_dim=16, max_position_embeddings=512, rope_theta=c.rope_theta,
                rms_norm_eps=c.rms_norm_eps, attention_bias=c.attention_bias,
                tie_word_embeddings=c.tie_word_embeddings)


@functools.lru_cache(maxsize=None)
def _init(key: tuple):
    """merv_tpu's init of one tiny family decoder (fp32), as numpy leaves."""
    cfg = jax_tiny_decoder(compute_dtype=jnp.float32, **dict(key))
    return _np_tree(JaxDecoder(cfg).init(jax.random.PRNGKey(len(key) + int(dict(key)["num_heads"]))))


def _decoders(llm_id: str, packed: bool = False, compute=("float32", "float32")):
    """(merv_tpu decoder, its params, the port's decoder on the same weights);
    ``packed``: both in the serving layout (merv_tpu's tree packed, carried by
    the bridge into a packed port decoder)."""
    fam = tiny_family(llm_id)
    params = _init(tuple(sorted(fam.items())))
    jdec = JaxDecoder(jax_tiny_decoder(compute_dtype=getattr(jnp, compute[0]), **fam))
    dec = LlamaDecoder(tiny_decoder_config(compute_dtype=getattr(torch, compute[1]), **fam), device=CPU)
    if packed:
        params = _np_tree(jax_pack_serving_params(params))
        pack_serving_params(dec)
    dec.load_state_dict(state_dict_from_jax(params), strict=True)
    return jdec, params, dec


def _prompt(seed=0, B=2, T=9):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, VOCAB, size=(B, T))
    mask = np.ones((B, T), np.int64)
    mask[1, T - 3:] = 0
    return ids, mask


# ---------------------------------------------------------------------------
# registration: specs, configs, tokenizer quirks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("llm_id", IDS)
def test_spec_matches_merv_tpu(llm_id):
    """The spec (family, hub path, full-size decoder config, prompt builder,
    half precision, BOS, pad / eos / stop ids) and what the backbone and its
    ByteTokenizer make of it, as merv_tpu has them; the id resolves through
    materialize (built on the meta device)."""
    want, got = JAX_LLM_SPECS[llm_id], LLM_SPECS[llm_id]
    for f in ("llm_family", "hf_hub_path", "has_bos", "pad_token_id", "eos_token_id", "stop_token_id"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.prompt_builder_cls.__name__ == want.prompt_builder_cls.__name__
    assert str(got.half_precision_dtype).split(".")[-1] == jnp.dtype(want.half_precision_dtype).name
    jc, pc = dataclasses.asdict(want.decoder_config), dataclasses.asdict(got.decoder_config)
    assert {k: v for k, v in jc.items() if k in pc and "dtype" not in k} == \
        {k: v for k, v in pc.items() if "dtype" not in k}
    jllm = JaxLLMBackbone(llm_id, inference_mode=True)
    llm, tok = get_llm_backbone_and_tokenizer(llm_id, inference_mode=True, device="meta")
    assert llm.decoder.layers[0].attn.q_proj.weight.dtype == got.half_precision_dtype
    for attr in ("bos_token_length", "pad_token_id", "eos_token_id", "stop_token_id", "embed_dim"):
        assert getattr(llm, attr) == getattr(jllm, attr), attr
    jtok = jllm.tokenizer
    for attr in ("pad_token", "pad_token_id", "bos_token", "bos_token_id", "eos_token_id", "add_bos_token"):
        assert getattr(tok, attr) == getattr(jtok, attr), attr
    prompt = llm.prompt_builder_fn("merv").get_potential_prompt("What is happening?")
    assert prompt == jllm.prompt_builder_fn("merv").get_potential_prompt("What is happening?")
    assert tok(prompt).input_ids == jtok(prompt).input_ids
    assert (tok(prompt).input_ids[0] == tok.bos_token_id) == want.has_bos


@pytest.mark.parametrize("model_id", [m.model_id for m in ModelRegistry])
def test_model_config_matches_merv_tpu(model_id):
    """Each of merv_tpu's seven registered model configs, under its id, with its values; its LLM resolves."""
    from merv_tpu.conf.models import ModelConfig as JaxModelConfig

    got = dataclasses.asdict(ModelConfig.get_choice_class(model_id)())
    assert got == dataclasses.asdict(JaxModelConfig.get_choice_class(model_id)())
    assert got["llm_backbone_id"] in LLM_SPECS


# ---------------------------------------------------------------------------
# the decoder: logits, greedy tokens, the packed layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("llm_id", IDS)
def test_family_logits_and_greedy_tokens_match_merv_tpu(llm_id):
    """fp32: the no-cache forward's logits on a right-padded batch within
    1e-4; ``generate`` through the cache and the T=1 step gives merv_tpu's
    greedy tokens, and stops where merv_tpu stops when one of them is the
    stop id."""
    jdec, params, dec = _decoders(llm_id)
    ids, mask = _prompt(seed=1)
    want, _ = jdec(params, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    got, _ = dec(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    cfg = dict(max_new_tokens=6, eos_token_id=-1, pad_token_id=0)
    ref = np.asarray(jax_generate(jdec, params, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                                  config=JaxGenConfig(**cfg)))
    out = generate(dec, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                   config=GenerationConfig(**cfg))
    np.testing.assert_array_equal(out.numpy(), ref)
    cfg["eos_token_id"] = int(ref[0, 2])  # a stop id met mid-answer: both pad after it
    ref = np.asarray(jax_generate(jdec, params, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                                  config=JaxGenConfig(**cfg)))
    out = generate(dec, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                   config=GenerationConfig(**cfg))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (out[0, 3:] == 0).all()


@pytest.mark.parametrize("llm_id", IDS)
def test_packed_layout_matches_unpacked_and_merv_tpu(llm_id):
    """``pack_serving_params`` on the port's decoder holds what the bridge
    carries from merv_tpu's packed tree, byte for byte; its logits are within
    1e-5 of the unpacked decoder's (fp32) and within 1e-4 of merv_tpu's packed
    tree's; its greedy tokens through the cache are merv_tpu's."""
    jdec, pparams, pdec = _decoders(llm_id, packed=True)
    _, params, dec = _decoders(llm_id)
    own = pack_serving_params(_decoders(llm_id)[2]).state_dict()
    _assert_state_dicts_equal(own, pdec.state_dict())
    a = pdec.layers[0].attn
    assert set(a._modules) == {"qkv_proj", "o_proj"} and set(pdec.layers[0].mlp._modules) == {"gate_up_proj",
                                                                                              "down_proj"}
    assert (a.qkv_proj.bias is not None) == LLM_SPECS[llm_id].decoder_config.attention_bias
    ids, mask = _prompt(seed=2)
    t_ids, t_mask = torch.from_numpy(ids), torch.from_numpy(mask)
    unpacked, _ = dec(input_ids=t_ids, attention_mask=t_mask)
    packed, _ = pdec(input_ids=t_ids, attention_mask=t_mask)
    np.testing.assert_allclose(packed.numpy(), unpacked.numpy(), **PACKED_TOL)
    want, _ = jdec(pparams, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    np.testing.assert_allclose(packed.numpy(), np.asarray(want), **TOL)
    cfg = dict(max_new_tokens=6, eos_token_id=-1)
    ref = jax_generate(jdec, pparams, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                       config=JaxGenConfig(**cfg))
    np.testing.assert_array_equal(generate(pdec, input_ids=t_ids, attention_mask=t_mask,
                                           config=GenerationConfig(**cfg)).numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="pack the float weights"):
        from merv_tpu_torch.nn.quantization import quantize_tree

        pack_serving_params(quantize_tree(_decoders(llm_id)[2]))


def _step_logits(dec, ids, mask):
    """The prefill's last-position logits and one T=1 step's, on a fresh cache."""
    T = ids.shape[1]
    with torch.inference_mode():
        logits, cache, n_valid = prefill(dec, dec.embed_input_ids(ids), mask, T + 4)
        nxt = logits.argmax(-1)
        step, _ = dec(input_ids=nxt[:, None], positions=n_valid[:, None], kv_cache=cache,
                      attention_mask=torch.cat([mask.bool(), torch.ones((ids.shape[0], 4), dtype=torch.bool)], 1))
    return logits, step[:, 0]


@pytest.mark.parametrize("llm_id", IDS)
def test_half_storage_computes_in_bf16_as_merv_tpu(llm_id):
    """Inference mode: weights stored in the family's half precision (fp16 for
    Qwen-2.5), compute in bf16. The port's decoder on those weights, cast at
    every use, and the same decoder rounded once to bf16
    (``round_to_compute_dtype``, what ``load_vid`` does) give bit-identical
    prefill and step logits; both are within ``BF16_LOGITS`` of merv_tpu's
    ``inference_mode=True`` on the same half-precision tree."""
    half = LLM_SPECS[llm_id].half_precision_dtype
    jhalf = JAX_LLM_SPECS[llm_id].half_precision_dtype
    jdec, params, _ = _decoders(llm_id, compute=("bfloat16", "bfloat16"))
    hparams = jax.tree_util.tree_map(lambda x: np.asarray(jnp.asarray(x, jhalf)), params)
    fam = tiny_family(llm_id)
    stored = LlamaDecoder(tiny_decoder_config(param_dtype=half, **fam), device=CPU)
    stored.load_state_dict(state_dict_from_jax(hparams), strict=True)
    assert stored.layers[0].attn.q_proj.weight.dtype == half
    rounded = LlamaDecoder(tiny_decoder_config(param_dtype=half, **fam), device=CPU)
    rounded.load_state_dict(state_dict_from_jax(hparams), strict=True)
    round_to_compute_dtype(rounded)
    assert {p.dtype for p in rounded.parameters()} == {torch.bfloat16}
    ids, mask = _prompt(seed=3, T=7)
    t_ids, t_mask = torch.from_numpy(ids), torch.from_numpy(mask)
    a, b = _step_logits(stored, t_ids, t_mask), _step_logits(rounded, t_ids, t_mask)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    want, _ = jdec(hparams, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    got, _ = rounded(input_ids=t_ids, attention_mask=t_mask)
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(got.float().numpy() - want).max() <= BF16_LOGITS * np.abs(want).max()


# ---------------------------------------------------------------------------
# weight import: Llama-3's vocabulary padding, Qwen's biases, the tied head
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("llm_id", IDS)
def test_hf_import_matches_merv_tpu(llm_id):
    """An HF state dict of the family's tiny decoder with 64 vocabulary rows
    fewer than the config (as Llama-3's 128,256 rows against its 128,320):
    both importers pad with the mean row, carry Qwen's q/k/v biases and write
    no ``lm_head`` for a tied head; the port's state dict equals merv_tpu's tree."""
    fam = tiny_family(llm_id)
    jcfg = jax_tiny_decoder(compute_dtype=jnp.float32, **fam)
    state = jax_export_llama(jcfg, _init(tuple(sorted(fam.items()))))
    for k in ("model.embed_tokens.weight", "lm_head.weight"):
        if k in state:
            state[k] = state[k][:-64]
    assert ("lm_head.weight" in state) != fam["tie_word_embeddings"]
    assert ("model.layers.0.self_attn.q_proj.bias" in state) == fam["attention_bias"]
    want = state_dict_from_jax(_np_tree(jax_import_llama(jcfg, state)))
    got = import_llama_state_dict(tiny_decoder_config(**fam), state)
    _assert_state_dicts_equal(got, want)
    LlamaDecoder(tiny_decoder_config(**fam), device=CPU).load_state_dict(got, strict=True)


# ---------------------------------------------------------------------------
# load_vid: cast -> pack -> quantize on a family's run directory
# ---------------------------------------------------------------------------

RUN_CONFIG = {"model_id": "merv-full", "arch_specifier": "3davg+linear", "feature_fusion": "cross_attention_avg_lq",
              "video_backbone_ids": [v[2] for v in LOAD_TOWERS.values()], "image_resize_strategy": "resize-naive",
              "llm_max_length": 512, "num_frames": [4, 4, 8, 4], "projector_token_length": 4,
              "visual_feature_length": 16}


def _family_backbones(llm_id):
    """merv_tpu's and the port's tiny LLM backbone of ``llm_id``'s family: its
    spec (prompt builder, BOS, half precision) on the tiny decoder, bf16 compute."""
    fam, js, ps = tiny_family(llm_id), JAX_LLM_SPECS[llm_id], LLM_SPECS[llm_id]
    jspec = JaxLLMSpec("tiny", "__offline__/tiny", jax_tiny_decoder(**fam), js.prompt_builder_cls,
                       half_precision_dtype=js.half_precision_dtype, has_bos=js.has_bos, pad_token_id=0,
                       eos_token_id=2)
    pspec = LLMSpec("tiny", "__offline__/tiny", tiny_decoder_config(**fam), ps.prompt_builder_cls,
                    half_precision_dtype=ps.half_precision_dtype, has_bos=ps.has_bos, pad_token_id=0, eos_token_id=2)
    return (lambda: JaxLLMBackbone(llm_id, llm_max_length=512, inference_mode=True, spec=jspec),
            lambda device=CPU: LLMBackbone(llm_id, llm_max_length=512, inference_mode=True, spec=pspec,
                                           device=device))


@pytest.mark.parametrize("llm_id", ["qwen2.5-3b-instruct"])
def test_load_vid_packs_and_quantizes_as_merv_tpu(llm_id, tmp_path, monkeypatch):
    """A run directory whose model dict names ``llm_id`` (the family with the
    most quirks: fp16 storage, no BOS, q/k/v biases, GQA 8 and a tied head,
    whose embedding stays unquantized and serves as the head): ``load_vid``
    with ``pack_llm=True`` (the default) and ``quantize_llm=True`` holds
    merv_tpu's tree byte for byte (int8 values and scales from the fp16
    weights, packed), every other LLM leaf rounded once to bf16; the answer
    on one question with an int8 cache is merv_tpu's."""
    from merv_tpu.models.vidlms import MERV as JMERV
    from merv_tpu.training.checkpointing import save_checkpoint as jax_save_checkpoint

    jllm, pllm = _family_backbones(llm_id)
    run = tmp_path / "run"
    (run / "checkpoints").mkdir(parents=True)
    (run / "config.json").write_text(json.dumps({"model": dict(RUN_CONFIG, llm_backbone_id=llm_id)}))
    jm0 = JMERV("tiny-merv", [_jax_tower(n, jnp.float32) for n in LOAD_TOWERS], jllm(), **LOAD_KW)
    jax_save_checkpoint(run, 1, 0, 0.5, _trainables(jm0), ["projectors", "feature_fusion", "llm_backbone"])
    _write_tower_dir(tmp_path / "towers", list(LOAD_TOWERS))
    monkeypatch.setenv("MERV_TPU_TOWER_DIR", str(tmp_path / "towers"))
    monkeypatch.delenv("MERV_TPU_LLM_DIR", raising=False)
    monkeypatch.setattr(jax_load_vid_mod, "get_video_backbone_and_transform",
                        lambda *a, **k: ([_jax_tower(n, jnp.float32) for n in LOAD_TOWERS], []))
    monkeypatch.setattr(jax_load_vid_mod, "get_llm_backbone_and_tokenizer", lambda ident, *a, **k: (jllm(), None))
    monkeypatch.setattr(jax_load_vid_mod, "get_vidlm", lambda model_id, arch, fusion, vbs, llm, **k: JMERV(
        model_id, vbs, llm, arch_specifier=arch, feature_fusion=fusion, text_embedding_dim=32, **k))
    monkeypatch.setattr(port_load_vid_mod, "get_video_backbone_and_transform",
                        lambda *a, device=None, **k: ([_port_tower(n, torch.float32, device) for n in LOAD_TOWERS],
                                                      []))
    monkeypatch.setattr(port_load_vid_mod, "get_llm_backbone_and_tokenizer",
                        lambda ident, *a, device=None, **k: (pllm(device), None))
    monkeypatch.setattr(port_load_vid_mod, "get_vidlm", lambda model_id, arch, fusion, vbs, llm, device=None, **k: MERV(
        model_id, vbs, llm, arch_specifier=arch, feature_fusion=fusion, text_embedding_dim=32, device=device, **k))

    jm, jparams = jax_load_vid_mod.load_vid(str(run), quantize_llm=True)
    pm = load_vid(run, quantize_llm=True, device=CPU)
    want = state_dict_from_jax(_np_tree(jparams))
    got = pm.state_dict()
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        if name.startswith("llm_backbone.") and w.is_floating_point() and not name.endswith(".scale"):
            assert w.dtype == torch.float16 and g.dtype == torch.bfloat16, name
            w = w.to(torch.bfloat16)  # merv_tpu casts its fp16 leaf to bf16 at every use; the port once
        assert g.dtype == w.dtype and torch.equal(g, w), name
    dec = pm.llm_backbone.decoder
    assert dec.layers[0].attn.qkv_proj.weight_q.dtype == torch.int8 and dec.layers[0].attn.qkv_proj.bias is not None
    assert ("lm_head" in dec._modules) != LLM_SPECS[llm_id].decoder_config.tie_word_embeddings
    prompt = pm.llm_backbone.prompt_builder_fn("merv").get_potential_prompt("What is in the video?")
    video = _videos(1, seed=4)[0]
    kw = dict(num_frames=RUN_CONFIG["num_frames"], max_new_tokens=6, kv_cache_dtype="int8")
    assert pm.generate(video, prompt, **kw) == jm.generate(jparams, video, prompt, **kw)


# ---------------------------------------------------------------------------
# MERV with a Qwen-like LLM: no BOS, a tied head, GQA 7
# ---------------------------------------------------------------------------

QWEN_LIKE = dict(vocab_size=VOCAB, hidden_size=128, intermediate_size=128, num_heads=7, num_kv_heads=1, head_dim=64,
                 attention_bias=True, tie_word_embeddings=True, rms_norm_eps=1e-6, rope_theta=1e6)
QWEN_PROMPTS = ["What is in this video?", "a?", "Describe the motion in detail please."]


@pytest.fixture(scope="module")
def qwen_pair():
    """merv_tpu's and the port's tiny MERV on the same weights, with a no-BOS,
    tied, GQA-7 LLM, Qwen-2's prompt builder and the tiny towers."""
    from merv_tpu.models.backbones.video.vit import tiny_vit_config as jax_tiny_vit
    from merv_tpu_torch.models.backbones.video.vit import tiny_vit_config

    jtowers, ptowers = [], []
    for jcls, pcls, vb_id, kw, over in TOWERS.values():
        tiny = jax_tiny_vit(**over)
        cls = type(f"Tiny{jcls.__name__}", (jcls,), {"vit_config": property(lambda self, t=tiny: dataclasses.replace(t))})
        jtowers.append(cls(vb_id, "resize-naive", **kw))
        ptowers.append(pcls(vb_id, "resize-naive", vit_config=tiny_vit_config(**over), device=CPU, **kw))
    jllm = jax_tiny_llm(prompt_builder_cls=JaxQwen2PromptBuilder, has_bos=False, compute_dtype=jnp.float32,
                        **QWEN_LIKE)
    pllm = tiny_llm_backbone(prompt_builder_cls=Qwen2PromptBuilder, has_bos=False, compute_dtype=torch.float32,
                             device=CPU, **QWEN_LIKE)
    jm = JaxMERV("tiny-merv", jtowers, jllm, **MERV_KW)
    pm = MERV("tiny-merv", ptowers, pllm, device=CPU, **MERV_KW)
    params = _np_tree(jm.init(jax.random.PRNGKey(9)))
    pm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, pm.eval()


def _qwen_prompts(pm):
    out = []
    for q in QWEN_PROMPTS:
        b = pm.llm_backbone.prompt_builder_fn("merv")
        b.add_turn("human", q)
        out.append(b.get_prompt())
    return out


def test_merv_without_bos_matches_merv_tpu(qwen_pair):
    """No BOS: the visual tokens go first, in the forward's splice, in
    ``generate``, the shared-prefix path (a prefix of the visual tokens only)
    and ``score_options``; each as merv_tpu gives it (strings, picks, logits
    within 1e-4)."""
    jm, params, pm = qwen_pair
    prompts = _qwen_prompts(pm)
    videos = _videos(3, seed=5)
    ids, mask, vids, is_mm = pm._prepare_batch_inputs(videos[:1], prompts[:1])
    assert int(ids[0, 0]) != pm.llm_backbone.tokenizer.bos_token_id or pm.llm_backbone.tokenizer.bos_token is None
    with torch.inference_mode():
        embeds, _ = pm.build_inputs_embeds(ids, mask, vids, is_mm)
        visual, _ = pm.project_and_fuse(pm.encode_videos(vids))
    torch.testing.assert_close(embeds[:, : visual.shape[1]], visual.to(embeds.dtype))
    jids, jmask, jvids, jmm = jm._prepare_batch_inputs(videos[:1], prompts[:1])
    out = jm.forward(params, jids, jmask, jvids, is_multimodal=jmm)
    np.testing.assert_allclose(pm.forward(ids, mask, vids, is_multimodal=is_mm)["logits"].detach().numpy(),
                               np.asarray(out["logits"]), **TOL)

    kw = dict(max_new_tokens=6)
    assert pm.generate(videos[0], prompts[0], **kw) == jm.generate(params, videos[0], prompts[0], **kw)
    prefix = pm.build_video_prefix(videos[1])
    assert prefix.bos_ids == () and prefix.cache.length == pm.visual_feature_length
    shared = pm.generate_batch_shared(videos[1], prompts, **kw)
    assert shared == jm.generate_batch_shared(params, videos[1], prompts, **kw)
    assert shared == pm.generate_batch([videos[1]] * 3, prompts, **kw)
    options = [["A", "B", "C"], ["A", "B"], ["Yes", "No"]]
    assert pm.score_options(videos, prompts, options) == jm.score_options(params, videos, prompts, options)
