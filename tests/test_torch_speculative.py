"""Prompt-lookup speculative decoding in the port against merv_tpu, in fp32 on tiny configs.

``generate_speculative`` must be greedy-identical to merv_tpu's and to the
port's ``generate`` (padded and repetitive prompts too); the drafter
(``_ngram_propose``, batched over rows), its host mirror
(``_ngram_propose_host``) and the acceptance simulator (``_sim_spec_steps``)
must give merv_tpu's answers on seeded histories; ``_spec_accept`` must pass
merv_tpu's statistical check of its marginals; and ``MERV.generate`` with
``speculative_gamma`` must give the plain path's and merv_tpu's text. Weights:
a merv_tpu random init carried over by merv_tpu_torch.bridge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import merv_tpu.serving.engine as jax_engine_mod
import merv_tpu_torch.serving.engine as E
from merv_tpu.models.generation import GenerationConfig as JaxGenConfig
from merv_tpu.models.generation import _ngram_propose as jax_ngram_propose
from merv_tpu.models.generation import generate_speculative as jax_generate_speculative
from merv_tpu_torch.models.generation import GenerationConfig, _ngram_propose, _spec_accept, generate, \
    generate_speculative
from test_torch_generation_shared import LLM, _decoders, _videos, merv_pair

V = LLM["vocab_size"]


@pytest.fixture(scope="module")
def decoders():
    return _decoders(seed=5)


def _ids(seed, n):
    return np.random.RandomState(seed).randint(4, 40, (1, n))


@pytest.mark.parametrize("gamma,ngram", [(1, 1), (2, 2), (4, 2), (6, 3)])
def test_speculative_matches_generate_and_merv_tpu(gamma, ngram, decoders):
    jdec, params, dec = decoders
    cfg, jcfg = GenerationConfig(max_new_tokens=12, eos_token_id=1), JaxGenConfig(max_new_tokens=12, eos_token_id=1)
    for seed, n in [(0, 7), (2, 15)]:
        ids = _ids(seed, n)
        got = generate_speculative(dec, input_ids=torch.as_tensor(ids), config=cfg, gamma=gamma, ngram=ngram)
        assert torch.equal(got, generate(dec, input_ids=torch.as_tensor(ids), config=cfg)), seed
        want = jax_generate_speculative(jdec, params, input_ids=jnp.asarray(ids, jnp.int32), config=jcfg, gamma=gamma,
                                        ngram=ngram)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_speculative_padded_and_repetitive_prompts(decoders):
    """A right-padded prompt (pads out of the cache mask and the draft corpus)
    and a repetitive one (drafts accept: fewer verify steps than tokens)."""
    jdec, params, dec = decoders
    cfg, jcfg = GenerationConfig(max_new_tokens=32, eos_token_id=1), JaxGenConfig(max_new_tokens=32, eos_token_id=1)
    padded, mask = np.zeros((1, 12), np.int64), np.zeros((1, 12), np.int64)
    padded[0, :7], mask[0, :7] = _ids(3, 7)[0], 1
    repetitive = np.array([[5, 6, 7, 8] * 5])
    for ids, m in [(padded, mask), (repetitive, None)]:
        tm = None if m is None else torch.as_tensor(m)
        timings = {}
        got = generate_speculative(dec, input_ids=torch.as_tensor(ids), attention_mask=tm, config=cfg, gamma=4,
                                   timings=timings)
        assert torch.equal(got, generate(dec, input_ids=torch.as_tensor(ids), attention_mask=tm, config=cfg))
        want = jax_generate_speculative(jdec, params, input_ids=jnp.asarray(ids, jnp.int32),
                                        attention_mask=None if m is None else jnp.asarray(m, jnp.int32), config=jcfg,
                                        gamma=4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if m is None:
            assert timings["decode_steps"] < cfg.max_new_tokens - 1  # drafts were accepted


def test_speculative_rejects_a_batch(decoders):
    _, _, dec = decoders
    with pytest.raises(ValueError, match="B=1"):
        generate_speculative(dec, input_ids=torch.ones((2, 4), dtype=torch.long),
                             config=GenerationConfig(max_new_tokens=4))


def _histories(seed, B=5, Hc=40):
    """Seeded histories from a small alphabet (so n-grams repeat), with their lengths (1 up)."""
    rng = np.random.RandomState(seed)
    hist = rng.randint(3, 8, (B, Hc))
    hist_len = np.array([1, 2, 9, 25, Hc - 12][:B])
    for b, n in enumerate(hist_len):
        hist[b, n:] = 0
    return hist, hist_len


@pytest.mark.parametrize("gamma,ngram", [(1, 1), (3, 2), (4, 3)])
def test_ngram_propose_matches_merv_tpu(gamma, ngram):
    for seed in range(3):
        hist, hist_len = _histories(seed)
        got = _ngram_propose(torch.as_tensor(hist), torch.as_tensor(hist_len), gamma, ngram, 0)
        want = jax.vmap(lambda h, n: jax_ngram_propose(h, n, gamma, ngram, 0))(
            jnp.asarray(hist, jnp.int32), jnp.asarray(hist_len, jnp.int32))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # the host mirror agrees row by row
        for b in range(len(hist)):
            h = hist[b, : hist_len[b]].tolist()
            assert E._ngram_propose_host(h, gamma, ngram, 0) == jax_engine_mod._ngram_propose_host(h, gamma, ngram, 0)


def test_sim_spec_steps_matches_merv_tpu():
    rng = np.random.RandomState(4)
    streams = [[3, 7, 5, 9] * 16, list(range(10, 74)), rng.randint(3, 9, 80).tolist(), rng.randint(3, 5, 50).tolist()]
    for h in streams:
        for gamma, ngram, start in [(2, 2, 8), (4, 2, 5), (8, 3, 12)]:
            assert E._sim_spec_steps(h, start, gamma, ngram, 0) == \
                jax_engine_mod._sim_spec_steps(h, start, gamma, ngram, 0)
    steps, emitted = E._sim_spec_steps([3, 7, 5, 9] * 16, 8, 4, 2, 0)
    assert emitted / steps > 3.0


def test_spec_accept_marginals():
    """merv_tpu's check (tests/test_speculative.py::test_spec_accept_marginals):
    rejection sampling against a delta proposal reproduces the target
    distribution at every position, whatever the draft."""
    Vt, gamma, N = 6, 2, 40000
    rng = np.random.RandomState(0)
    p = rng.dirichlet(np.ones(Vt), size=gamma + 1)
    probs = torch.as_tensor(np.broadcast_to(p, (N, gamma + 1, Vt)).copy(), dtype=torch.float32)
    draft = torch.as_tensor(np.broadcast_to([int(p[0].argmax()), int(p[1].argmin())], (N, gamma)).copy())
    toks, emit_n = _spec_accept(probs, draft, torch.Generator().manual_seed(1), pad_id=-1)
    toks, emit_n = toks.numpy(), emit_n.numpy()
    freq0 = np.bincount(toks[:, 0], minlength=Vt) / N
    np.testing.assert_allclose(freq0, p[0], atol=0.015)
    m1 = emit_n >= 2
    assert 0.2 < m1.mean() < 1.0
    freq1 = np.bincount(toks[m1, 1], minlength=Vt) / m1.sum()
    np.testing.assert_allclose(freq1, p[1], atol=0.02)
    np.testing.assert_allclose(m1.mean(), p[0].max(), atol=0.015)


def test_vidlm_speculative_matches_plain_and_merv_tpu():
    """MERV.generate with speculative_gamma: the plain path's text and
    merv_tpu's speculative text, on a video and on a text-only prompt."""
    jm, params, pm = merv_pair()
    video = _videos(1, seed=7)[0]
    for vid, prompt in [(video, "In: describe what is happening in the video?\nOut: "),
                        (None, "In: a text only question?\nOut: ")]:
        plain = pm.generate(vid, prompt, max_new_tokens=6)
        spec = pm.generate(vid, prompt, max_new_tokens=6, speculative_gamma=3)
        assert spec == plain == jm.generate(params, vid, prompt, max_new_tokens=6, speculative_gamma=3)
    assert pm.generate_batch([video], ["In: a?\nOut: "], max_new_tokens=5, speculative_gamma=2) == \
        pm.generate_batch([video], ["In: a?\nOut: "], max_new_tokens=5)
