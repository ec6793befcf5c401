"""The serving engine's decode chunks as CUDA graphs, on the card.

These tests need a CUDA device and skip elsewhere (a CUDA graph has no CPU
mode). The file imports neither JAX nor merv_tpu:

    python -m pytest tests/test_torch_serving_cuda.py --noconftest -m cuda

A tiny bf16 decoder with head dim 64 (so its prefills run the flash kernel)
on random weights from a seeded generator, served at 3 slots: the captured
chunk's tokens (plain, and the verify at gamma 3) must equal the eager
chunk's from the same state, greedy and sampled from one seed; a slot
pointer past the buffer's end must write nowhere a key mask admits, with no
device assert; a chunk whose capture fails must raise, not fall back to the
eager chunk.
"""

import pytest
import torch

import merv_tpu_torch.serving.engine as E
from merv_tpu_torch.models.backbones.llm.transformer import KVCache, LlamaDecoder, tiny_decoder_config
from merv_tpu_torch.models.generation import GenerationConfig
from merv_tpu_torch.nn.core import init_weights
from merv_tpu_torch.serving import ContinuousBatchingEngine, Request

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


def _admitted(dev, cfg, gamma):
    """An engine with 3 slots admitted from seeded prompts (one repetitive, so drafts accept)."""
    eng = ContinuousBatchingEngine(_decoder(dev), config=cfg, slots=3, max_len=96, steps_per_sync=6,
                                   length_bucket=8, speculative_gamma=gamma)
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(3, LLM["vocab_size"], (n,), generator=g).numpy() for n in (11, 5)]
    prompts.append(torch.tensor([7, 8, 9] * 5).numpy())
    for i, p in enumerate(prompts):
        eng.submit(Request(f"r{i}", input_ids=p, max_new_tokens=40))
    eng._admit()
    with torch.inference_mode():
        eng._state.done.zero_()
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [0, 3], ids=["plain", "speculative"])
@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
def test_chunk_graph_matches_eager_chunk(cuda, gamma, sample):
    cfg = GenerationConfig(max_new_tokens=40, eos_token_id=-1, do_sample=sample, temperature=1.0, top_p=0.9)
    eng = _admitted(cuda, cfg, gamma)
    chunk = eng._chunk(gamma)
    assert chunk.graph is not None and chunk.capture_s > 0
    snap, gen_state = eng._state.snapshot(), chunk.generator.get_state()

    def window():
        return (chunk.wins.clone(), chunk.emits.clone()) if gamma else (chunk.toks.clone(),)

    runs = []
    for replay in (False, True, False):  # eager, graph, eager again: the state and the draws restored each time
        eng._state.restore(snap)
        chunk.generator.set_state(gen_state)
        if replay:
            chunk.graph.replay()
        else:
            chunk.run_eager(eng)
        torch.cuda.synchronize()
        runs.append(window() + (eng._state.length.clone(),))
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)
    for a, b in zip(runs[0], runs[2]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_no_collection_during_a_capture(cuda):
    """The cyclic garbage collector does not run while a decode runner or an
    engine chunk captures (a collection there can free an object whose release
    invalidates the capture): with the collector's threshold at one allocation,
    no collection starts while the stream captures."""
    import gc

    import merv_tpu_torch.models.generation as G

    seen = []

    def watch(phase, info):
        if phase == "start" and torch.cuda.is_current_stream_capturing():
            seen.append(info["generation"])

    threshold = gc.get_threshold()
    gc.callbacks.append(watch)
    gc.set_threshold(1, 1, 1)
    try:
        eng = _admitted(cuda, GenerationConfig(max_new_tokens=40, eos_token_id=-1), 0)
        eng._chunk(0)
        G.decode_runner(_decoder(cuda), 1, 32, GenerationConfig(max_new_tokens=8, eos_token_id=-1), cuda)
    finally:
        gc.set_threshold(*threshold)
        gc.callbacks.remove(watch)
    assert seen == []


@pytest.mark.cuda
def test_engine_serves_through_its_graphs(cuda):
    """A whole engine run on the card gives the tokens of the same run with
    the chunks eager (the graphs dropped after each capture)."""
    cfg = GenerationConfig(max_new_tokens=20, eos_token_id=-1)
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(3, LLM["vocab_size"], (n,), generator=g).numpy() for n in (7, 12, 3, 9, 5)]
    results = []
    for eager in (False, True):
        eng = ContinuousBatchingEngine(_decoder(cuda), config=cfg, slots=2, max_len=64, steps_per_sync=4,
                                       length_bucket=8, speculative_gamma=2)
        if eager:
            chunk0 = eng._chunk

            def no_graph(gamma, chunk0=chunk0):
                c = chunk0(gamma)
                c.release()
                return c

            eng._chunk = no_graph
        results.append(eng.run([Request(f"r{i}", input_ids=p, max_new_tokens=20) for i, p in enumerate(prompts)]))
    for rid in results[0]:
        assert (results[0][rid].token_ids == results[1][rid].token_ids).all(), rid


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 4])
def test_out_of_range_slot_write_is_dropped_on_the_card(cuda, T):
    dec = _decoder(cuda)
    R = 24  # rows; the last is the scratch row
    cache = KVCache.create(dec.cfg, 3, R, dec.cfg.compute_dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    cache.k.normal_(generator=g)
    cache.v.normal_(generator=g)
    before_k, before_v = cache.k.clone(), cache.v.clone()
    lengths = torch.tensor([R - 1, R + 7, 5], device=cuda)  # the scratch row, past the buffer, in range
    ids = torch.randint(3, LLM["vocab_size"], (3, T), device=cuda, generator=g)
    with torch.inference_mode():
        logits, out = dec(input_ids=ids, kv_cache=KVCache(cache.k, cache.v, lengths))
    torch.cuda.synchronize()  # a device assert would surface here
    assert torch.isfinite(logits.float()).all() and out.length.tolist() == [R - 1 + T, R + 7 + T, 5 + T]
    for b in (0, 1):
        assert torch.equal(cache.k[:, b, :, : R - 1], before_k[:, b, :, : R - 1])
        assert torch.equal(cache.v[:, b, :, : R - 1], before_v[:, b, :, : R - 1])
    assert torch.equal(cache.k[:, 2, :, :5], before_k[:, 2, :, :5])
    assert torch.equal(cache.k[:, 2, :, 5 + T : R - 1], before_k[:, 2, :, 5 + T : R - 1])


@pytest.mark.cuda
def test_a_failed_chunk_capture_raises(cuda, monkeypatch):
    """A chunk that reads a tensor back to the host cannot be captured: the
    engine raises, and nothing runs the eager chunk instead."""
    chunk_fn = E._decode_chunk

    def reads_back(decoder, st, *args, **kwargs):
        chunk_fn(decoder, st, *args, **kwargs)
        bool(st.done.all())

    monkeypatch.setattr(E, "_decode_chunk", reads_back)
    eng = _admitted(cuda, GenerationConfig(max_new_tokens=8, eos_token_id=-1), 0)
    with pytest.raises(RuntimeError):
        eng._chunk(0)
    assert 0 not in eng._chunks
