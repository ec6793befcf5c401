"""The rest of generation in the port (merv_tpu_torch) against merv_tpu, in fp32 on tiny configs.

Shared-prefix generation (``prefill_prefix`` / ``generate_with_prefix``), the
batch entry points of MERV (``generate_batch``, ``build_video_prefix``,
``generate_batch_shared``, ``score_options``) and their errors, and the decode
step that a CUDA graph captures on the card: here it runs in the Python loop,
with every host read patched to raise. Weights: a merv_tpu random init carried
over by merv_tpu_torch.bridge; inputs from numpy seeds. Tolerance: 1e-4
(absolute and relative) on caches and logits, as tests/test_crossstack_parity.py
holds logits; tokens, strings and picks must be identical. The tiny LLM has
head dim 64, so its prefills take the flash plan (K2's plain version on the
CPU) as the full model's do on the card, and 320 ids, so the option letters'
ids (259 up) are inside its head.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import merv_tpu_torch.models.generation as G
import merv_tpu_torch.ops.attention as A
from merv_tpu.models.backbones.llm.base_llm import tiny_llm_backbone as jax_tiny_llm
from merv_tpu.models.backbones.llm.tokenization import ByteTokenizer as JaxByteTokenizer
from merv_tpu.models.backbones.llm.transformer import LlamaDecoder as JaxDecoder
from merv_tpu.models.backbones.llm.transformer import tiny_decoder_config as jax_tiny_decoder
from merv_tpu.models.backbones.video import DinoV2VideoBackbone as JaxDino
from merv_tpu.models.backbones.video import SiglipVideoBackbone as JaxSiglip
from merv_tpu.models.backbones.video.vit import tiny_vit_config as jax_tiny_vit
from merv_tpu.models.generation import GenerationConfig as JaxGenConfig
from merv_tpu.models.generation import VideoPrefix as JaxVideoPrefix
from merv_tpu.models.generation import generate as jax_generate
from merv_tpu.models.generation import generate_with_prefix as jax_generate_with_prefix
from merv_tpu.models.generation import prefill_prefix as jax_prefill_prefix
from merv_tpu.models.vidlms import MERV as JaxMERV
from merv_tpu_torch.bridge import state_dict_from_jax
from merv_tpu_torch.models.backbones.llm.base_llm import tiny_llm_backbone
from merv_tpu_torch.models.backbones.llm.tokenization import ByteTokenizer
from merv_tpu_torch.models.backbones.llm.transformer import LlamaDecoder, tiny_decoder_config
from merv_tpu_torch.models.backbones.video import DinoV2VideoBackbone, SiglipVideoBackbone
from merv_tpu_torch.models.backbones.video.vit import tiny_vit_config
from merv_tpu_torch.models.generation import (
    DecodeRunner,
    GenerationConfig,
    VideoPrefix,
    _sample_token,
    decode_runner,
    generate,
    generate_with_prefix,
    prefill,
    prefill_prefix,
)
from merv_tpu_torch.models.vidlms import MERV

TOL = dict(atol=1e-4, rtol=1e-4)
CPU = "cpu"
LLM = dict(vocab_size=320, hidden_size=128, intermediate_size=128, num_heads=2, num_kv_heads=1, head_dim=64)
# tower -> (JAX class, port class, backbone id, kwargs, tiny ViT overrides)
TOWERS = {
    "dinov2": (JaxDino, DinoV2VideoBackbone, "dinov2-video-all-tokens", dict(default_image_size=32, num_frames=4),
               dict(num_cls_tokens=1, num_register_tokens=4, use_layerscale=True)),
    "siglip": (JaxSiglip, SiglipVideoBackbone, "siglip-vit-b16-224px-all-no-cls",
               dict(default_image_size=32, num_frames=4),
               dict(num_cls_tokens=0, pos_embed_includes_prefix=False, act="gelu_tanh")),
}
MERV_KW = dict(arch_specifier="no-align+3davg+linear", feature_fusion="cross_attention_avg_lq",
               projector_token_length=4, visual_feature_length=16, text_embedding_dim=32)
PROMPTS = ["In: what is in this video?\nOut: ", "In: a?\nOut: ", "In: describe the motion in detail please.\nOut: "]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def merv_pair():
    """(merv_tpu MERV, its params, the port's MERV with the same weights): two
    tiny towers, 3davg+linear, cross-attention fusion, the tiny LLM above."""
    jtowers, ptowers = [], []
    for jcls, pcls, vb_id, kw, over in TOWERS.values():
        tiny = jax_tiny_vit(**over)
        cls = type(f"Tiny{jcls.__name__}", (jcls,), {"vit_config": property(lambda self, t=tiny: dataclasses.replace(t))})
        jtowers.append(cls(vb_id, "resize-naive", **kw))
        ptowers.append(pcls(vb_id, "resize-naive", vit_config=tiny_vit_config(**over), device=CPU, **kw))
    jm = JaxMERV("tiny-merv", jtowers, jax_tiny_llm(compute_dtype=jnp.float32, **LLM), **MERV_KW)
    pm = MERV("tiny-merv", ptowers, tiny_llm_backbone(compute_dtype=torch.float32, device=CPU, **LLM), device=CPU,
              **MERV_KW)
    params = _np_tree(jm.init(jax.random.PRNGKey(8)))
    pm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, pm.eval()


@pytest.fixture(scope="module")
def pair():
    return merv_pair()


def _videos(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=(8, 40, 48, 3)).astype(np.uint8) for _ in range(n)]


def _decoders(seed=7):
    jdec = JaxDecoder(jax_tiny_decoder(compute_dtype=jnp.float32, **LLM))
    params = _np_tree(jdec.init(jax.random.PRNGKey(seed)))
    dec = LlamaDecoder(tiny_decoder_config(compute_dtype=torch.float32, **LLM), device=CPU)
    dec.load_state_dict(state_dict_from_jax(params), strict=True)
    return jdec, params, dec


def _prefix_and_suffixes(rng, P=6, lengths=(7, 4, 7)):
    """A pad-free prefix, right-padded suffixes, and the spliced right-padded sequences."""
    prefix = rng.randint(3, LLM["vocab_size"], size=(1, P))
    sufs = [rng.randint(3, LLM["vocab_size"], size=(n,)) for n in lengths]
    B, Tmax = len(sufs), max(lengths)
    suffix_ids, sm = np.zeros((B, Tmax), np.int64), np.zeros((B, Tmax), np.int64)
    ids, mask = np.zeros((B, P + Tmax), np.int64), np.zeros((B, P + Tmax), np.int64)
    for b, s in enumerate(sufs):
        suffix_ids[b, : len(s)], sm[b, : len(s)] = s, 1
        ids[b, :P], ids[b, P : P + len(s)], mask[b, : P + len(s)] = prefix[0], s, 1
    return prefix, suffix_ids, sm, ids, mask


def test_generate_with_prefix_matches_jax_and_full():
    """A cached prefix's continuations: token-identical to merv_tpu's
    generate_with_prefix and to the port's own generate on [prefix | suffix]
    (mixed suffix lengths); the prefix cache within 1e-4 of merv_tpu's."""
    jdec, params, dec = _decoders()
    prefix, suffix_ids, sm, ids, mask = _prefix_and_suffixes(np.random.RandomState(7))
    cfg, jcfg = GenerationConfig(max_new_tokens=8, eos_token_id=-1), JaxGenConfig(max_new_tokens=8, eos_token_id=-1)

    jcache = jax_prefill_prefix(jdec, params, inputs_embeds=jdec.embed_input_ids(params, jnp.asarray(prefix)))
    ref = jax_generate_with_prefix(jdec, params, jcache, suffix_ids=jnp.asarray(suffix_ids),
                                   suffix_mask=jnp.asarray(sm), config=jcfg)
    with torch.inference_mode():
        cache = prefill_prefix(dec, inputs_embeds=dec.embed_input_ids(torch.from_numpy(prefix)))
    assert cache.k.shape[3] == prefix.shape[1] and cache.length == prefix.shape[1]
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), **TOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), **TOL)
    out = generate_with_prefix(dec, cache, suffix_ids=torch.from_numpy(suffix_ids), suffix_mask=torch.from_numpy(sm),
                               config=cfg)
    full = generate(dec, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask), config=cfg)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out.numpy(), full.numpy())
    # the caller's prefix cache is untouched: a second batch on it gives the same tokens
    again = generate_with_prefix(dec, cache, suffix_ids=torch.from_numpy(suffix_ids),
                                 suffix_mask=torch.from_numpy(sm), config=cfg)
    np.testing.assert_array_equal(again.numpy(), out.numpy())


def test_build_video_prefix_matches_jax(pair):
    """Towers + fusion + the [BOS | visual] prefill: cache rows within 1e-4, same BOS ids."""
    jm, params, pm = pair
    video = _videos(1)[0]
    ref = jm.build_video_prefix(params, video)
    got = pm.build_video_prefix(video)
    assert got.bos_ids == ref.bos_ids == (1,) and got.kv_cache_dtype is None
    assert got.cache.k.shape == ref.cache.k.shape and got.cache.length == ref.cache.k.shape[3]
    np.testing.assert_allclose(got.cache.k.numpy(), np.asarray(ref.cache.k), **TOL)
    np.testing.assert_allclose(got.cache.v.numpy(), np.asarray(ref.cache.v), **TOL)


def test_generate_batch_matches_jax(pair):
    """A video row and a text-only row, padded to a batch of 3: merv_tpu's
    strings; the pad row changes nothing."""
    jm, params, pm = pair
    videos = [_videos(1)[0], None]
    prompts = PROMPTS[:2]
    ref = jm.generate_batch(params, videos, prompts, max_new_tokens=6, pad_to_batch=3)
    got = pm.generate_batch(videos, prompts, max_new_tokens=6, pad_to_batch=3)
    assert got == ref and len(got) == 2
    assert pm.generate_batch(videos, prompts, max_new_tokens=6) == got


def test_generate_batch_shared_matches_full_and_jax(pair):
    """One video, three questions: the shared prefix gives generate_batch's
    strings and merv_tpu's generate_batch_shared's; a prefix built once serves
    a padded partial batch."""
    jm, params, pm = pair
    video = _videos(1, seed=1)[0]
    full = pm.generate_batch([video] * 3, PROMPTS, max_new_tokens=6)
    shared = pm.generate_batch_shared(video, PROMPTS, max_new_tokens=6)
    assert shared == full
    assert shared == jm.generate_batch_shared(params, video, PROMPTS, max_new_tokens=6)
    prefix = pm.build_video_prefix(video)
    assert pm.generate_batch_shared(video, PROMPTS[:1], max_new_tokens=6, pad_to_batch=2,
                                    prefix_cache=prefix) == full[:1]


def test_score_options_matches_jax(pair):
    """Likelihood readout: the same picks as merv_tpu, from last-position
    logits within 1e-4 of merv_tpu's forward."""
    jm, params, pm = pair
    videos = _videos(3, seed=2)
    options = [["A", "B", "C"], ["A", "B", "C", "D", "E"], ["A", "B"]]
    ref = jm.score_options(params, videos, PROMPTS, options, pad_to_batch=4)
    assert pm.score_options(videos, PROMPTS, options, pad_to_batch=4) == ref

    ids, mask, vids, is_mm = pm._prepare_batch_inputs(videos, PROMPTS, pad_to_batch=4)
    jids, jmask, jvids, jmm = jm._prepare_batch_inputs(videos, PROMPTS, pad_to_batch=4)
    with torch.inference_mode():
        embeds, emask = pm.build_inputs_embeds(ids, mask, vids, is_mm)
        last = emask.long().sum(1) - 1
        logits, _ = pm.llm_backbone.decoder(inputs_embeds=embeds, attention_mask=emask, logits_indices=last)
    out = jm.forward(params, jids, jmask, jvids, is_multimodal=jmm)
    jlast = np.asarray(out["attention_mask"]).sum(1) - 1
    np.testing.assert_array_equal(last.numpy(), jlast)
    want = np.asarray(out["logits"])[np.arange(4), jlast]
    np.testing.assert_allclose(logits[:, 0].numpy(), want, **TOL)


class _OddBos:
    """Mixed into both packages' ByteTokenizer: a prompt starting with "#" gets
    BOS id 5, so two prompts can disagree on BOS."""

    def encode(self, text, add_special_tokens=True):
        ids = super().encode(text, add_special_tokens)
        if add_special_tokens and text.startswith("#"):
            ids[0] = 5
        return ids


def _shared_error_case(case, jm, params, pm, video):
    """The call of ``case`` in each package: (merv_tpu call, port call)."""
    if case == "bos_disagree":
        prompts = ["In: a?\nOut: ", "#In: b?\nOut: "]
        return (lambda: jm.generate_batch_shared(params, video, prompts, max_new_tokens=2),
                lambda: pm.generate_batch_shared(video, prompts, max_new_tokens=2))
    if case == "empty_suffix":
        prompts = ["In: a?\nOut: ", ""]
        return (lambda: jm.generate_batch_shared(params, video, prompts, max_new_tokens=2),
                lambda: pm.generate_batch_shared(video, prompts, max_new_tokens=2))
    jprefix, prefix = jm.build_video_prefix(params, video), pm.build_video_prefix(video)
    if case == "prefix_other_bos":
        jprefix, prefix = jprefix._replace(bos_ids=(5,)), prefix._replace(bos_ids=(5,))
    else:  # prefix_other_kv_dtype
        jprefix, prefix = jprefix._replace(kv_cache_dtype="int8"), prefix._replace(kv_cache_dtype="int8")
    assert isinstance(jprefix, JaxVideoPrefix) and isinstance(prefix, VideoPrefix)
    return (lambda: jm.generate_batch_shared(params, video, PROMPTS[:1], max_new_tokens=2, prefix_cache=jprefix),
            lambda: pm.generate_batch_shared(video, PROMPTS[:1], max_new_tokens=2, prefix_cache=prefix))


@pytest.mark.parametrize("case, match", [
    ("bos_disagree", "disagree on BOS"), ("empty_suffix", "empty after BOS"),
    ("prefix_other_bos", "bos_ids"), ("prefix_other_kv_dtype", "kv_cache_dtype"),
])
def test_shared_prefix_errors_match_jax(pair, case, match):
    jm, params, pm = pair
    jtok, ptok = jm.llm_backbone._tokenizer, pm.llm_backbone._tokenizer
    jm.llm_backbone._tokenizer = type("OddBos", (_OddBos, JaxByteTokenizer), {})()
    pm.llm_backbone._tokenizer = type("OddBos", (_OddBos, ByteTokenizer), {})()
    try:
        jcall, pcall = _shared_error_case(case, jm, params, pm, _videos(1, seed=3)[0])
        with pytest.raises(ValueError, match=match):
            jcall()
        with pytest.raises(ValueError, match=match):
            pcall()
    finally:
        jm.llm_backbone._tokenizer, pm.llm_backbone._tokenizer = jtok, ptok


def test_int8_kv_prefix_and_batches_match_jax(pair):
    """``kv_cache_dtype="int8"``: ``build_video_prefix``'s int8 cache (scales
    within 1e-4, values within one step of merv_tpu's), and ``generate_batch``
    and ``generate_batch_shared`` on it with merv_tpu's tokens; a prefix of
    the other dtype is refused with merv_tpu's message."""
    jm, params, pm = pair
    video = _videos(1, seed=4)[0]
    ref = jm.build_video_prefix(params, video, kv_cache_dtype="int8")
    got = pm.build_video_prefix(video, kv_cache_dtype="int8")
    assert got.kv_cache_dtype == "int8" and got.cache.k.dtype == torch.int8 and got.bos_ids == ref.bos_ids
    np.testing.assert_allclose(got.cache.k_scale.numpy(), np.asarray(ref.cache.k_scale), **TOL)
    assert (np.abs(got.cache.v.numpy().astype(int) - np.asarray(ref.cache.v).astype(int)) <= 1).all()
    want = jm.generate_batch(params, [video, video], PROMPTS[:2], max_new_tokens=6, kv_cache_dtype="int8")
    assert pm.generate_batch([video, video], PROMPTS[:2], max_new_tokens=6, kv_cache_dtype="int8") == want
    assert pm.generate_batch_shared(video, PROMPTS[:2], max_new_tokens=6, prefix_cache=got,
                                    kv_cache_dtype="int8") == \
        jm.generate_batch_shared(params, video, PROMPTS[:2], max_new_tokens=6, prefix_cache=ref, kv_cache_dtype="int8")
    with pytest.raises(ValueError, match="was built with kv_cache_dtype='int8' but this request asks for None"):
        pm.generate_batch_shared(video, PROMPTS[:1], max_new_tokens=2, prefix_cache=got)


def test_mesh_is_refused(pair):
    """Every mesh axis serves: an sp mesh (tests/test_torch_sp_serving.py), a
    tensor axis (a model whose decoder is not cut, as on a virtual mesh,
    computes with whole weights; a cut one: tests/test_torch_tensor_parallel.py)
    and a pipeline axis, on merv_tpu's plain cached loop over whole weights:
    the same picks and tokens as no mesh, bit for bit."""
    from merv_tpu_torch.parallel import VirtualMesh

    _, _, pm = pair
    videos = _videos(2)
    picks = pm.score_options(videos, PROMPTS[:2], [["A", "B"], ["A", "B", "C"]])
    tokens = pm.generate_batch(videos, PROMPTS[:2], max_new_tokens=4)
    for mesh in (VirtualMesh(2, tensor=2), VirtualMesh(1, pipe=2)):
        assert pm.score_options(videos, PROMPTS[:2], [["A", "B"], ["A", "B", "C"]], mesh=mesh) == picks
        assert pm.generate_batch(videos, PROMPTS[:2], max_new_tokens=4, mesh=mesh) == tokens


# ---------------------------------------------------------------------------
# the decode step the card captures as a CUDA graph
# ---------------------------------------------------------------------------

HOST_READS = ("item", "tolist", "__bool__", "__int__", "__float__", "__index__")
STEP_CONFIGS = {
    "greedy": GenerationConfig(max_new_tokens=6),
    "sampled": GenerationConfig(max_new_tokens=6, do_sample=True, temperature=0.7, top_k=20, top_p=0.9,
                                min_length=40),
    "int8_kv": GenerationConfig(max_new_tokens=6, kv_cache_dtype="int8"),
}


@pytest.mark.parametrize("name", list(STEP_CONFIGS))
def test_decode_step_reads_nothing_back(name, monkeypatch):
    """The step a CUDA graph captures must not read a tensor back to the host
    (which a capture refuses): run it with Tensor.item / tolist / __bool__ /
    __int__ / __float__ / __index__ raising, so such a read fails here and not
    first on the card."""
    _, _, dec = _decoders()
    cfg = STEP_CONFIGS[name]
    _, _, _, ids, mask = _prefix_and_suffixes(np.random.RandomState(4))
    B, T = ids.shape
    runner = DecodeRunner(dec, B, T + cfg.max_new_tokens, cfg, torch.device(CPU))
    g = torch.Generator().manual_seed(3)
    with torch.inference_mode():
        logits, _, n_valid = prefill(dec, dec.embed_input_ids(torch.from_numpy(ids)), torch.from_numpy(mask),
                                     T + cfg.max_new_tokens, cache=runner.cache)
        first = _sample_token(logits, cfg, g)
        cache_mask = torch.cat([torch.from_numpy(mask).bool(), torch.ones((B, cfg.max_new_tokens), dtype=torch.bool)], 1)
        runner.load(first, n_valid, cache_mask, T, g)

        def refuse(*args, **kwargs):
            raise AssertionError("the decode step read a tensor back to the host")

        for attr in HOST_READS:
            monkeypatch.setattr(torch.Tensor, attr, refuse)
        with pytest.raises(AssertionError):
            bool(torch.ones(()))  # the patch is in force
        for _ in range(cfg.max_new_tokens - 1):
            step_logits = runner.step(dec)
        monkeypatch.undo()
    assert step_logits.shape == (B, LLM["vocab_size"]) and torch.isfinite(step_logits).any(-1).all()
    assert int(runner.length) == T + cfg.max_new_tokens - 1 and int(runner.column[0]) == cfg.max_new_tokens
    assert torch.equal(runner.pos, n_valid + cfg.max_new_tokens - 1)


def test_sampling_draws_as_torch_multinomial():
    """The step's sampler is torch.multinomial's one-sample path: the same draws from the same generator."""
    probs_logits = torch.from_numpy(np.random.RandomState(5).randn(4, 50).astype(np.float32))
    cfg = GenerationConfig(do_sample=True, temperature=0.8, top_p=0.95)
    got = _sample_token(probs_logits, cfg, torch.Generator().manual_seed(11))
    probs = torch.softmax(G._filter_logits(probs_logits, cfg), dim=-1)
    want = torch.multinomial(probs, 1, generator=torch.Generator().manual_seed(11))[:, 0]
    assert torch.equal(got, want)


@pytest.mark.parametrize("rows", ["one_row_stops", "every_row_stops"])
def test_chunked_early_exit_matches_decode_scan(rows, monkeypatch):
    """EOS early in a batch: the port reads ``done`` once per chunk of steps
    and stops when every row is done; merv_tpu's generate runs its
    ``_decode_scan`` over every step. The tokens must be the same."""
    monkeypatch.setattr(G, "DECODE_SYNC_EVERY", 3)
    jdec, params, dec = _decoders(seed=9)
    _, _, _, ids, mask = _prefix_and_suffixes(np.random.RandomState(8), lengths=(5, 3))
    if rows == "every_row_stops":
        ids, mask = ids[:1], mask[:1]
    probe = generate(dec, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                     config=GenerationConfig(max_new_tokens=20, eos_token_id=-1))
    eos = int(probe[0, 3])  # row 0 emits it at step 3 at the latest
    cfg, jcfg = GenerationConfig(max_new_tokens=20, eos_token_id=eos), JaxGenConfig(max_new_tokens=20, eos_token_id=eos)
    timings = {}
    got = generate(dec, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask), config=cfg,
                   timings=timings)
    ref = jax_generate(jdec, params, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask), config=jcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got[0] == eos).any() and (got[0, int((got[0] == eos).nonzero()[0]) + 1:] == cfg.pad_token_id).all()
    if rows == "every_row_stops":
        assert timings["decode_steps"] < cfg.max_new_tokens - 1  # the loop stopped early


def test_decode_runners_are_reused_and_bounded():
    """One runner per (batch, cache length, config): reused while alive, at most
    MAX_DECODE_RUNNERS kept per decoder; a reused runner gives the same tokens."""
    _, _, dec = _decoders()
    _, _, _, ids, mask = _prefix_and_suffixes(np.random.RandomState(6))
    run = lambda n: generate(dec, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),  # noqa: E731
                             config=GenerationConfig(max_new_tokens=n, eos_token_id=-1))
    first = run(5)
    runner, made = decode_runner(dec, ids.shape[0], ids.shape[1] + 5, GenerationConfig(max_new_tokens=5, eos_token_id=-1),
                                 torch.device(CPU))
    assert not made
    assert torch.equal(run(5), first)
    for n in (6, 7, 8):
        run(n)
    assert len(dec._decode_runners) == G.MAX_DECODE_RUNNERS
    assert runner.cache is None  # evicted and released


# ---------------------------------------------------------------------------
# ROADMAP §C: every query row of the prefills that reach K2 sees a valid key
# ---------------------------------------------------------------------------


def test_no_query_row_left_without_a_valid_key(pair, monkeypatch):
    """K2 writes 0 on a query row with no valid key, where merv_tpu's
    attention_reference averages V. The entry points that reach K2 with a key
    mask or a ``q_offset`` (the suffix prefill of generate_batch_shared, the
    padded batch of generate_batch with a text-only row, score_options'
    no-cache forward) never give it such a row: every row sees key 0 (BOS, or
    the prefix)."""
    _, _, pm = pair
    calls = []
    flash = A.flash_attention_forward

    def checked(q, k, v, *, causal, kv_mask=None, scale=None, q_offset=None, return_lse=False):
        Tq, Tk = q.shape[2], k.shape[2]
        offset = Tk - Tq if q_offset is None else q_offset
        seen = A._visible(q.shape[0], Tq, Tk, causal, kv_mask, offset, q.device).any(-1)
        calls.append(bool(seen.all()))
        return flash(q, k, v, causal=causal, kv_mask=kv_mask, scale=scale, q_offset=q_offset, return_lse=return_lse)

    monkeypatch.setattr(A, "flash_attention_forward", checked)
    video = _videos(1, seed=4)[0]
    for run in (lambda: pm.generate_batch_shared(video, PROMPTS, max_new_tokens=3, pad_to_batch=4),
                lambda: pm.generate_batch([video, None], PROMPTS[:2], max_new_tokens=3, pad_to_batch=3),
                lambda: pm.score_options([video, None], PROMPTS[:2], [["A", "B"]] * 2, pad_to_batch=3)):
        calls.clear()
        run()
        assert calls and all(calls), calls
