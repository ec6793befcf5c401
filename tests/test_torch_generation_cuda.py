"""Decode as one CUDA graph, on the card.

These tests need a CUDA device and skip elsewhere (a CUDA graph has no CPU
mode). The file imports neither JAX nor merv_tpu:

    python -m pytest tests/test_torch_generation_cuda.py --noconftest -m cuda

A tiny bf16 decoder with head dim 64 (so its prefills run the flash kernel)
on random weights from a seeded generator: the captured step's tokens must
equal the eager loop's over the same step function from the same state, for
greedy and sampled decoding; shared-prefix generation must give generate's
tokens; a capture that fails must raise, not fall back to the eager loop.
"""

import pytest
import torch

import merv_tpu_torch.models.generation as G
from merv_tpu_torch.models.backbones.llm.transformer import LlamaDecoder, tiny_decoder_config
from merv_tpu_torch.nn.core import init_weights

LLM = dict(vocab_size=320, hidden_size=128, intermediate_size=256, num_heads=2, num_kv_heads=1, head_dim=64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _decoder(dev):
    dec = LlamaDecoder(tiny_decoder_config(param_dtype=torch.bfloat16, **LLM), device=dev)
    init_weights(dec, torch.Generator(device=dev).manual_seed(0))
    return dec


def _batch(dev, P=24, lengths=(20, 9, 15)):
    g = torch.Generator(device="cpu").manual_seed(1)
    prefix = torch.randint(3, LLM["vocab_size"], (1, P), generator=g)
    B, Tmax = len(lengths), max(lengths)
    suffix_ids, suffix_mask = torch.zeros((B, Tmax), dtype=torch.long), torch.zeros((B, Tmax), dtype=torch.long)
    ids, mask = torch.zeros((B, P + Tmax), dtype=torch.long), torch.zeros((B, P + Tmax), dtype=torch.long)
    for b, n in enumerate(lengths):
        s = torch.randint(3, LLM["vocab_size"], (n,), generator=g)
        suffix_ids[b, :n], suffix_mask[b, :n] = s, 1
        ids[b, :P], ids[b, P : P + n], mask[b, : P + n] = prefix[0], s, 1
    return [t.to(dev) for t in (prefix, suffix_ids, suffix_mask, ids, mask)]


@pytest.mark.cuda
@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
def test_decode_graph_matches_eager_loop(cuda, sample):
    dec = _decoder(cuda)
    *_, ids, mask = _batch(cuda)
    cfg = G.GenerationConfig(max_new_tokens=24, eos_token_id=-1, do_sample=sample, temperature=1.0, top_p=0.9)
    timings = {}
    out = G.generate(dec, input_ids=ids, attention_mask=mask, config=cfg,
                     generator=torch.Generator(device=cuda).manual_seed(5), timings=timings)
    assert timings["decode_capture_s"] > 0 and timings["decode_steps"] == cfg.max_new_tokens - 1
    runner, made = G.decode_runner(dec, ids.shape[0], ids.shape[1] + cfg.max_new_tokens, cfg, ids.device)
    assert not made and runner.graph is not None
    # the same request, its decode run eagerly over the runner's step function
    with torch.inference_mode():
        gen = torch.Generator(device=cuda).manual_seed(5)
        logits, _, n_valid = G.prefill(dec, dec.embed_input_ids(ids), mask, runner.cache_mask.shape[1],
                                       cache=runner.cache)
        first = G._sample_token(G._ban_eos_below_min_length(logits, n_valid, cfg), cfg, gen)
        cache_mask = torch.cat([mask.bool(), torch.ones((ids.shape[0], cfg.max_new_tokens), dtype=torch.bool,
                                                         device=cuda)], dim=1)
        runner.load(first, n_valid, cache_mask, ids.shape[1], gen)
        for _ in range(cfg.max_new_tokens - 1):
            runner.step(dec)
    assert torch.equal(runner.out, out)


@pytest.mark.cuda
def test_generate_with_prefix_matches_generate_on_the_card(cuda):
    dec = _decoder(cuda)
    prefix, suffix_ids, suffix_mask, ids, mask = _batch(cuda)
    cfg = G.GenerationConfig(max_new_tokens=16, eos_token_id=-1)
    with torch.inference_mode():
        cache = G.prefill_prefix(dec, inputs_embeds=dec.embed_input_ids(prefix))
    shared = G.generate_with_prefix(dec, cache, suffix_ids=suffix_ids, suffix_mask=suffix_mask, config=cfg)
    full = G.generate(dec, input_ids=ids, attention_mask=mask, config=cfg)
    assert torch.equal(shared, full)


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda, monkeypatch):
    """A step that reads a tensor back to the host cannot be captured: generate
    raises, and nothing runs the eager loop instead."""
    dec = _decoder(cuda)
    *_, ids, mask = _batch(cuda)
    step = G.DecodeRunner.step

    def reads_back(self, decoder):
        out = step(self, decoder)
        bool(self.done.all())
        return out

    monkeypatch.setattr(G.DecodeRunner, "step", reads_back)
    with pytest.raises(RuntimeError):
        G.generate(dec, input_ids=ids, attention_mask=mask, config=G.GenerationConfig(max_new_tokens=4))
