"""The port's serving engine (merv_tpu_torch.serving) against merv_tpu's, in fp32 on tiny configs.

The same requests, made from numpy seeds, go through both engines on the same
weights (a merv_tpu random init carried over by merv_tpu_torch.bridge): the
greedy tokens and ``finish_reason`` of every request must be identical, and so
must ``stats.prefill_buckets`` / ``admit_buckets`` / ``prefills`` (and the
verify counts when speculating), for heterogeneous budgets and EOS, slot
reuse, batched and fused admission, blocking admission, prefix caching mixed
with plain requests, the speculative engine and its budget freeze, and
``for_vidlm`` with ``register_prefix_video`` on the tiny MERV. Also: the
per-slot decoder steps (T=1 and T>1) against the scalar path and merv_tpu's
(logits within 1e-4, as tests/test_crossstack_parity.py holds them), a slot
pointer past the buffer's end, a vector ``q_offset``, the two-way
speculation monitor's transitions, the chunk functions with every host read
patched to raise (what a CUDA graph capture needs), and every K2 call of the
engine's prefills having a valid key on every query row. The tiny LLM has
head dim 64, so the prefills take the flash plan as the full model's do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import merv_tpu.serving.engine as jax_engine_mod
import merv_tpu_torch.ops.attention as A
import merv_tpu_torch.serving.engine as E
from merv_tpu.models.backbones.llm.transformer import KVCache as JaxKVCache
from merv_tpu.models.generation import GenerationConfig as JaxGenConfig
from merv_tpu.models.generation import prefill_prefix as jax_prefill_prefix
from merv_tpu.ops.attention import attention_reference as jax_attention_reference
from merv_tpu.serving.engine import ContinuousBatchingEngine as JaxEngine
from merv_tpu.serving.engine import Request as JaxRequest
from merv_tpu_torch.models.backbones.llm.transformer import KVCache
from merv_tpu_torch.models.generation import GenerationConfig, prefill_prefix
from merv_tpu_torch.serving import ContinuousBatchingEngine, Request
from test_torch_generation_shared import HOST_READS, LLM, _decoders, _videos, merv_pair

TOL = dict(atol=1e-4, rtol=1e-4)
V = LLM["vocab_size"]


@pytest.fixture(scope="module")
def decoders():
    return _decoders(seed=11)


@pytest.fixture(scope="module")
def pair():
    return merv_pair()


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(4, V, (n,)).astype(np.int32) for n in lens]


def _configs(**kw):
    kw.setdefault("eos_token_id", 1)
    return GenerationConfig(**kw), JaxGenConfig(**kw)


def _eos_case(dec):
    """An EOS id that one prompt's greedy continuation reaches at its third token."""
    from merv_tpu_torch.models.generation import generate

    ids = _prompts([6], seed=3)[0]
    probe = generate(dec, input_ids=torch.as_tensor(ids[None]).long(), config=GenerationConfig(max_new_tokens=4,
                                                                                               eos_token_id=-1))
    return int(probe[0, 2])


def _requests(spec):
    """[(request_id, input_ids, max_new_tokens, prefix_id)] -> both packages' Requests."""
    port = [Request(rid, input_ids=ids, max_new_tokens=n, prefix_id=pid) for rid, ids, n, pid in spec]
    jax = [JaxRequest(rid, input_ids=ids, max_new_tokens=n, prefix_id=pid) for rid, ids, n, pid in spec]
    return port, jax


def _case(name, dec):
    """(engine kwargs, generation config kwargs, request spec, {prefix_id: prefix ids})."""
    if name == "budgets_and_eos":
        eos = _eos_case(dec)
        ps = _prompts([6, 3, 9, 5, 12], seed=3)
        # r4: prompt + budget == max_len, so its pointer walks past the buffer before the host retires it
        spec = [("r0", ps[0], 8, None), ("r1", ps[1], 1, None), ("r2", ps[2], 5, None), ("r3", ps[3], 8, None),
                ("r4", ps[4], 20, None)]
        return dict(slots=2, max_len=32, steps_per_sync=3, length_bucket=4), dict(max_new_tokens=20, eos_token_id=eos), \
            spec, {}
    if name == "slot_reuse":
        ps = _prompts([5, 3, 9, 2, 7])
        return dict(slots=2, max_len=32, steps_per_sync=3, length_bucket=4), dict(max_new_tokens=8), \
            [(f"r{i}", p, 8, None) for i, p in enumerate(ps)], {}
    if name in ("batched_fused", "blocking_admission", "fusion_off"):
        ps = _prompts([2, 9, 3, 12, 2, 11], seed=1)
        kw = dict(slots=3, max_len=32, steps_per_sync=2, length_bucket=8)
        kw.update({"blocking_admission": dict(async_admission=False), "fusion_off": dict(fuse_admission_buckets=False)}
                  .get(name, {}))
        return kw, dict(max_new_tokens=4), [(f"r{i}", p, 4, None) for i, p in enumerate(ps)], {}
    if name == "prefix_mixed":
        shared = np.random.RandomState(8).randint(4, V, (6,)).astype(np.int32)
        sfx, plains = _prompts([2, 3, 3], seed=9), _prompts([5, 8], seed=10)
        spec = [("s0", sfx[0], 5, "p"), ("n0", plains[0], 5, None), ("s1", sfx[1], 5, "p"),
                ("n1", plains[1], 5, None), ("s2", sfx[2], 5, "p")]
        return dict(slots=2, max_len=32, steps_per_sync=2, length_bucket=4), dict(max_new_tokens=5), spec, \
            {"p": shared}
    if name == "speculative":
        ps = _prompts([5, 3, 9], seed=4) + [np.array([5, 6, 7, 8, 5, 6, 7, 8, 5, 6], np.int32),
                                            np.array([11, 12, 11, 12, 11, 12, 11], np.int32)]
        return dict(slots=2, max_len=48, steps_per_sync=3, length_bucket=4, speculative_gamma=3), \
            dict(max_new_tokens=16), [(f"r{i}", p, 16, None) for i, p in enumerate(ps)], {}
    if name == "speculative_budget_freeze":
        # prompt + budget == max_len: the freeze guard keeps the pointer inside the buffer
        return dict(slots=1, max_len=20, steps_per_sync=5, length_bucket=4, speculative_gamma=3), \
            dict(max_new_tokens=12), [("r0", _prompts([8], seed=11)[0], 12, None)], {}
    if name == "speculative_prefix":
        shared = np.array([7, 8, 9, 7, 8, 9, 7], np.int32)
        spec = [(f"s{i}", s, 10, "p") for i, s in enumerate(_prompts([2, 4, 3], seed=13))]
        return dict(slots=2, max_len=40, steps_per_sync=2, length_bucket=4, speculative_gamma=2), \
            dict(max_new_tokens=10), spec, {"p": shared}
    raise KeyError(name)


CASES = ["budgets_and_eos", "slot_reuse", "batched_fused", "blocking_admission", "fusion_off", "prefix_mixed",
         "speculative", "speculative_budget_freeze", "speculative_prefix"]


@pytest.mark.parametrize("name", CASES)
def test_engine_matches_merv_tpu(name, decoders):
    jdec, params, dec = decoders
    kw, gkw, spec, prefixes = _case(name, dec)
    cfg, jcfg = _configs(**gkw)
    port_reqs, jax_reqs = _requests(spec)
    jeng = JaxEngine(jdec, params, config=jcfg, **kw)
    eng = ContinuousBatchingEngine(dec, config=cfg, **kw)
    for pid, ids in prefixes.items():
        jeng.register_prefix(pid, jax_prefill_prefix(jdec, params, inputs_embeds=jdec.embed_input_ids(
            params, jnp.asarray(ids[None]))))
        with torch.inference_mode():
            eng.register_prefix(pid, prefill_prefix(dec, inputs_embeds=dec.embed_input_ids(
                torch.as_tensor(ids[None]).long())))
    want, got = jeng.run(jax_reqs), eng.run(port_reqs)
    assert sorted(got) == sorted(want) == sorted(r[0] for r in spec)
    for rid in want:
        np.testing.assert_array_equal(got[rid].token_ids, want[rid].token_ids, err_msg=rid)
        assert got[rid].finish_reason == want[rid].finish_reason, rid
    for key in ("prefill_buckets", "admit_buckets", "prefills", "prefix_admissions", "batched_admissions",
                "decode_chunks", "slot_steps_active", "spec_steps", "spec_emitted"):
        assert getattr(eng.stats, key) == getattr(jeng.stats, key), key
    if name == "budgets_and_eos":
        assert {r.finish_reason for r in got.values()} == {"eos", "budget"}
    if name == "speculative":
        assert eng.stats.tokens_per_step > 1.0
    if name.startswith("speculative"):
        assert int(eng._state.length.max()) <= eng._state.k.shape[3] - 1


def test_async_and_blocking_admission_give_the_same_tokens(decoders):
    _, _, dec = decoders
    kw, gkw, spec, _ = _case("batched_fused", dec)
    cfg, _ = _configs(**gkw)
    runs = [ContinuousBatchingEngine(dec, config=cfg, async_admission=a, **kw).run(_requests(spec)[0])
            for a in (True, False)]
    for rid in runs[0]:
        np.testing.assert_array_equal(runs[0][rid].token_ids, runs[1][rid].token_ids)


def test_engine_for_vidlm_matches_merv_tpu(pair):
    """The tiny MERV served by both frontends: video and text-only requests
    through the multimodal prefill, then the same questions on a video
    registered once (``register_prefix_video``), suffix-only."""
    jm, params, pm = pair
    videos = _videos(2, seed=21)
    prompts = ["In: a?\nOut: ", "In: what is happening here today?\nOut: ", "In: b?\nOut: "]
    stop = pm.llm_backbone.stop_token_id
    cfg, jcfg = _configs(max_new_tokens=4, eos_token_id=stop)
    kw = dict(slots=2, max_len=128, steps_per_sync=2, length_bucket=8)
    plain = [(videos[0], prompts[0]), (None, prompts[1]), (videos[1], prompts[2])]
    jeng, eng = JaxEngine.for_vidlm(jm, params, config=jcfg, **kw), ContinuousBatchingEngine.for_vidlm(pm, config=cfg,
                                                                                                        **kw)
    want = jeng.run([JaxRequest(f"r{i}", prompt_text=p, video=v, max_new_tokens=4) for i, (v, p) in enumerate(plain)])
    got = eng.run([Request(f"r{i}", prompt_text=p, video=v, max_new_tokens=4) for i, (v, p) in enumerate(plain)])
    for rid in want:
        np.testing.assert_array_equal(got[rid].token_ids, want[rid].token_ids, err_msg=rid)
        assert got[rid].finish_reason == want[rid].finish_reason
    assert eng.stats.prefill_buckets == jeng.stats.prefill_buckets and eng.stats.prefills == jeng.stats.prefills

    jeng.register_prefix_video("vid", videos[0])
    eng.register_prefix_video("vid", videos[0])
    want = jeng.run([JaxRequest(f"q{i}", prompt_text=p, prefix_id="vid", max_new_tokens=4)
                     for i, p in enumerate(prompts)])
    got = eng.run([Request(f"q{i}", prompt_text=p, prefix_id="vid", max_new_tokens=4) for i, p in enumerate(prompts)])
    for i in range(len(prompts)):
        np.testing.assert_array_equal(got[f"q{i}"].token_ids, want[f"q{i}"].token_ids)
    for key in ("prefill_buckets", "admit_buckets", "prefills", "prefix_admissions"):
        assert getattr(eng.stats, key) == getattr(jeng.stats, key), key
    # the shared prefix serves the same question as the full multimodal prefill does
    np.testing.assert_array_equal(got["q0"].token_ids, eng._results["r0"].token_ids)


def test_engine_for_vidlm_speculative_and_fault_isolation(pair, tmp_path):
    """Batched speculation on the tiny MERV gives the plain engine's tokens; a
    request naming a missing video file fails alone, with finish_reason
    "error", as merv_tpu's does."""
    _, _, pm = pair
    video = _videos(1, seed=5)[0]
    cfg, _ = _configs(max_new_tokens=6, eos_token_id=pm.llm_backbone.stop_token_id)
    reqs = lambda: [Request("a", prompt_text="In: a?\nOut: ", video=video, max_new_tokens=6),  # noqa: E731
                    Request("bad", prompt_text="In: b?\nOut: ", video=str(tmp_path / "missing.mp4"), max_new_tokens=6),
                    Request("c", prompt_text="In: say it again and again?\nOut: ", max_new_tokens=6)]
    kw = dict(slots=2, max_len=128, steps_per_sync=2, length_bucket=8)
    plain = ContinuousBatchingEngine.for_vidlm(pm, config=cfg, **kw).run(reqs())
    spec_eng = ContinuousBatchingEngine.for_vidlm(pm, config=cfg, speculative_gamma=3, **kw)
    spec = spec_eng.run(reqs())
    assert [rid for rid, r in spec.items() if r.finish_reason == "error"] == ["bad"] and spec_eng.stats.errors == 1
    for rid in ("a", "c"):
        np.testing.assert_array_equal(spec[rid].token_ids, plain[rid].token_ids)
    assert spec_eng.stats.spec_steps > 0


def test_spec_monitor_transitions_match_merv_tpu(decoders, monkeypatch):
    """The two-way monitor driven directly, with both packages' cost tables
    patched to the same values: every transition and the rebuilt device
    history match merv_tpu's."""
    jdec, params, dec = decoders
    table = {2: 1.1, 4: 1.2, 8: 1.3}
    monkeypatch.setattr(E, "_SPEC_COST_RATIO", dict(table))
    monkeypatch.setattr(jax_engine_mod, "_SPEC_COST_RATIO", dict(table))
    cfg, jcfg = _configs(max_new_tokens=8, pad_token_id=0)
    kw = dict(slots=2, max_len=64, steps_per_sync=2, length_bucket=4, speculative_gamma=2)
    engines = [ContinuousBatchingEngine(dec, config=cfg, **kw), JaxEngine(jdec, params, config=jcfg, **kw)]

    def state(e):
        hist = e._state.hist if isinstance(e, ContinuousBatchingEngine) else e._hist
        hist_len = e._state.hist_len if isinstance(e, ContinuousBatchingEngine) else e._hist_len
        return (e.spec_gamma, e._spec_off_by_monitor, e.stats.spec_disables, e.stats.spec_reenables,
                np.asarray(hist).tolist(), np.asarray(hist_len).tolist())

    def drive(e, step):
        e._spec_probe_steps = 4
        kind, arg = step
        if kind == "window":
            e._spec_monitor(*arg)
        elif kind == "estimate":
            e._est_win_steps, e._est_win_emitted = arg
            e._spec_monitor(0, 0)
        else:  # plant a live slot with a history
            slot = e._slots[0]
            slot.request = (Request if isinstance(e, ContinuousBatchingEngine) else JaxRequest)(
                "r0", input_ids=np.arange(4, dtype=np.int32), max_new_tokens=8)
            slot.done = False
            slot.prompt_ids, slot.emitted = list(arg[0]), list(arg[1])

    seq12 = [3, 7, 5, 9, 11, 13, 17, 19, 23, 29, 31, 37]
    steps = [("window", (4, 4)), ("estimate", (4, 4)), ("slot", ([3, 7, 5, 9] * 3, [3, 7, 5, 9] * 8)),
             ("estimate", (4, 16)), ("window", (4, 4)), ("slot", (seq12 * 2, seq12 * 6)), ("estimate", (4, 16)),
             ("window", (4, 12)), ("window", (4, 4))]
    seen = []
    for step in steps:
        for e in engines:
            drive(e, step)
        got, want = state(engines[0]), state(engines[1])
        assert got == want, (step, got[:4], want[:4])
        seen.append(got[0])
    assert seen == [0, 0, 0, 4, 0, 0, 8, 8, 0]


# ---------------------------------------------------------------------------
# the decoder's per-slot pointers and the plain attention's vector offset
# ---------------------------------------------------------------------------


def _prefilled(jdec, params, dec, lens, MAX, seed):
    """Per-row scalar caches (merv_tpu's and the port's) of seeded prompts, and
    a per-slot port cache of MAX + 1 rows (the last is scratch) and a merv_tpu
    one of MAX rows holding them."""
    prompts = _prompts(lens, seed=seed)
    jbig = JaxKVCache.create(jdec.cfg, len(lens), MAX, dtype=jnp.float32)
    big = KVCache.create(dec.cfg, len(lens), MAX + 1, torch.float32, torch.device("cpu"))
    jk, jv, rows = jbig.k, jbig.v, []
    with torch.inference_mode():
        for b, ids in enumerate(prompts):
            c = KVCache.create(dec.cfg, 1, MAX, torch.float32, torch.device("cpu"))
            _, c = dec(input_ids=torch.as_tensor(ids[None]).long(), kv_cache=c)
            big.k[:, b, :, :MAX], big.v[:, b, :, :MAX] = c.k[:, 0], c.v[:, 0]
            jk, jv = jk.at[:, b].set(jnp.asarray(c.k[:, 0].numpy())), jv.at[:, b].set(jnp.asarray(c.v[:, 0].numpy()))
            rows.append(c)
    return prompts, rows, big, JaxKVCache(jk, jv, jnp.asarray(lens, jnp.int32), None, None)


@pytest.mark.parametrize("T", [1, 3])
def test_per_slot_step_matches_scalar_path_and_merv_tpu(T, decoders):
    """Slots at their own lengths take T new tokens each (T=1: decode; T=3:
    the batched verify, per-row causal offsets): logits within 1e-4 of the
    port's scalar path row by row and of merv_tpu's per-slot path; the rows
    written at each slot's own offset; pointers advanced by T."""
    jdec, params, dec = decoders
    MAX, lens = 16, [5, 3]
    prompts, rows, big, jbig = _prefilled(jdec, params, dec, lens, MAX, seed=2)
    new = np.random.RandomState(3).randint(4, V, (2, T))
    with torch.inference_mode():
        got, out = dec(input_ids=torch.as_tensor(new).long(), kv_cache=KVCache(big.k, big.v, torch.tensor(lens)))
        for b in range(2):
            ref, ref_cache = dec(input_ids=torch.as_tensor(new[b : b + 1]).long(), kv_cache=rows[b])
            np.testing.assert_allclose(got[b].numpy(), ref[0].numpy(), **TOL)
            n = lens[b]
            np.testing.assert_allclose(big.k[:, b, :, n : n + T].numpy(), ref_cache.k[:, 0, :, n : n + T].numpy(),
                                       **TOL)
    want, jout = jdec(params, input_ids=jnp.asarray(new), kv_cache=jbig)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert out.length.tolist() == np.asarray(jout.length).tolist() == [n + T for n in lens]


@pytest.mark.parametrize("T", [1, 3])
def test_slot_pointer_past_the_buffer_is_dropped(T, decoders):
    """A slot whose pointer sits on or past the buffer's last row (it keeps
    stepping until the host retires it) writes nowhere that a key mask
    admits: no error, no wrap into its rows or its neighbour's, and the
    neighbour's logits are those of its own scalar path."""
    jdec, params, dec = decoders
    MAX = 12
    prompts, rows, big, _ = _prefilled(jdec, params, dec, [4, 3], MAX, seed=6)
    before_k, before_v = big.k.clone(), big.v.clone()
    new = np.random.RandomState(7).randint(4, V, (2, T))
    for pointer in (MAX, MAX + 1, MAX + 5):  # MAX is the scratch row; the others lie past the buffer
        with torch.inference_mode():
            lengths = torch.tensor([pointer, 3])
            got, out = dec(input_ids=torch.as_tensor(new).long(), kv_cache=KVCache(big.k, big.v, lengths))
            ref, _ = dec(input_ids=torch.as_tensor(new[1:]).long(),
                         kv_cache=KVCache(rows[1].k.clone(), rows[1].v.clone(), 3))
        assert torch.isfinite(got).all() and out.length.tolist() == [pointer + T, 3 + T]
        np.testing.assert_allclose(got[1].numpy(), ref[0].numpy(), **TOL)
        # slot 0's real rows are as they were: the writes went to the scratch row
        assert torch.equal(big.k[:, 0, :, :MAX], before_k[:, 0, :, :MAX])
        assert torch.equal(big.v[:, 0, :, :MAX], before_v[:, 0, :, :MAX])
        # slot 1 wrote its T rows at 3 and nothing else
        assert torch.equal(big.k[:, 1, :, :3], before_k[:, 1, :, :3])
        assert torch.equal(big.k[:, 1, :, 3 + T : MAX], before_k[:, 1, :, 3 + T : MAX])


def test_vector_q_offset_matches_merv_tpu():
    """attention_reference with a per-row [B] offset (and a 0-d one) equals
    merv_tpu's; a tensor offset takes the plain path through attention()."""
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(*s).astype(np.float32) for s in ((3, 4, 5, 64), (3, 2, 20, 64), (3, 2, 20, 64)))
    mask = rng.rand(3, 20) > 0.2
    offsets = np.array([0, 7, 15])
    for off in (offsets, np.array(6)):
        got = A.attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), causal=True,
                                    kv_mask=torch.from_numpy(mask), q_offset=torch.from_numpy(off))
        want = jax_attention_reference(*(jnp.asarray(x) for x in (q, k, v)), causal=True, kv_mask=jnp.asarray(mask),
                                       q_offset=jnp.asarray(off, jnp.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        routed = A.attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True, kv_mask=torch.from_numpy(mask),
                             q_offset=torch.from_numpy(off))
        assert torch.equal(routed, got)
    # each row of the vector offset is that row at its scalar offset
    full = A.attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), causal=True,
                                 kv_mask=torch.from_numpy(mask), q_offset=torch.from_numpy(offsets))
    for b, off in enumerate(offsets):
        one = A.attention_reference(*(torch.from_numpy(x[b : b + 1]) for x in (q, k, v)), causal=True,
                                    kv_mask=torch.from_numpy(mask[b : b + 1]), q_offset=int(off))
        np.testing.assert_allclose(full[b].numpy(), one[0].numpy(), **TOL)


# ---------------------------------------------------------------------------
# the chunk programs a CUDA graph captures on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gamma", [0, 3], ids=["plain", "speculative"])
def test_chunk_reads_nothing_back(gamma, decoders, monkeypatch):
    """A chunk (plain, or the batched verify) runs with Tensor.item / tolist /
    __bool__ / __int__ / __float__ / __index__ raising, sampled, with one slot
    finished and one about to pass the buffer's end: a host read added to the
    chunk fails here, not first in a capture on the card."""
    _, _, dec = decoders
    cfg = GenerationConfig(max_new_tokens=6, do_sample=True, temperature=0.8, top_k=30, top_p=0.9, min_length=9)
    eng = ContinuousBatchingEngine(dec, config=cfg, slots=3, max_len=24, steps_per_sync=4, length_bucket=4,
                                   speculative_gamma=gamma)
    for i, p in enumerate(_prompts([5, 9, 3], seed=5)):
        eng.submit(Request(f"r{i}", input_ids=p, max_new_tokens=6))
    eng._admit()
    st = eng._state
    st.done.copy_(torch.tensor([False, True, False]))
    st.length[2] = st.k.shape[3] - 2
    chunk = E._Chunk(eng, gamma, seed=3)
    snap = st.snapshot()

    def refuse(*args, **kwargs):
        raise AssertionError("the chunk read a tensor back to the host")

    for attr in HOST_READS:
        monkeypatch.setattr(torch.Tensor, attr, refuse)
    with pytest.raises(AssertionError):
        bool(torch.ones(()))
    chunk.run_eager(eng)
    monkeypatch.undo()
    assert st.length[1] == snap["length"][1]  # the finished slot's pointer froze
    out = chunk.wins if gamma else chunk.toks
    assert ((out >= 0) & (out < V)).all()
    if gamma:
        assert (chunk.emits[:, 1] == 0).all() and (chunk.emits >= 0).all()
    else:
        assert (chunk.toks[:, 1] == cfg.pad_token_id).all()


def test_chunk_graphs_are_bounded(decoders, monkeypatch):
    """At most MAX_CHUNK_GRAPHS chunk programs live per engine; the least
    recently used goes first."""
    _, _, dec = decoders
    monkeypatch.setattr(E, "MAX_CHUNK_GRAPHS", 2)
    eng = ContinuousBatchingEngine(dec, config=GenerationConfig(max_new_tokens=4), slots=2, max_len=16,
                                   speculative_gamma=2)
    for g in (0, 2, 0, 4):
        eng._chunk(g)
    assert list(eng._chunks) == [0, 4]


def test_refusals(decoders):
    """The sp mode serves (tests/test_torch_sp_serving.py), and so do a
    tensor axis (an uncut decoder, whole weights; a cut one:
    tests/test_torch_tensor_parallel.py) and a pipeline axis (merv_tpu's
    plain cached loop on whole weights): the tokens of no mesh, bit for bit.
    An unknown cache dtype still raises."""
    from merv_tpu_torch.parallel import VirtualMesh

    _, _, dec = decoders
    cfg, _ = _configs(max_new_tokens=5)

    def serve(mesh):
        eng = ContinuousBatchingEngine(dec, config=cfg, slots=2, max_len=24, length_bucket=4, mesh=mesh)
        out = eng.run([Request(f"r{i}", input_ids=p, max_new_tokens=5) for i, p in enumerate(_prompts([5, 3, 7]))])
        return {k: r.token_ids.tolist() for k, r in out.items()}

    want = serve(None)
    for mesh in (VirtualMesh(2, tensor=2), VirtualMesh(1, pipe=2)):
        assert serve(mesh) == want
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        ContinuousBatchingEngine(dec, config=GenerationConfig(kv_cache_dtype="fp8"))


# ---------------------------------------------------------------------------
# ROADMAP §C: every query row of the prefills that reach K2 sees a valid key
# ---------------------------------------------------------------------------


def test_no_engine_prefill_row_left_without_a_valid_key(decoders, pair, monkeypatch):
    """The engine's prefills that reach K2 (the batched LLM prefill padded to
    a power of two by repeating its last row, the suffix prefill at
    ``q_offset = P``, for_vidlm's multimodal prefill of a video and of a
    text-only row, and the prefix build) never give it a query row with no
    valid key. The buckets are 32 tokens (the engine's default is 64): a
    cached call of at most 16 query rows goes to K5 (``decode_attention``),
    which gives such a row merv_tpu's mean of V, so only longer ones reach K2."""
    _, _, dec = decoders
    _, _, pm = pair
    calls = []
    flash = A.flash_attention_forward

    def checked(q, k, v, *, causal, kv_mask=None, scale=None, q_offset=None, return_lse=False):
        Tq, Tk = q.shape[2], k.shape[2]
        offset = Tk - Tq if q_offset is None else q_offset
        calls.append(bool(A._visible(q.shape[0], Tq, Tk, causal, kv_mask, offset, q.device).any(-1).all()))
        return flash(q, k, v, causal=causal, kv_mask=kv_mask, scale=scale, q_offset=q_offset, return_lse=return_lse)

    monkeypatch.setattr(A, "flash_attention_forward", checked)
    cfg = GenerationConfig(max_new_tokens=3, eos_token_id=-1)
    eng = ContinuousBatchingEngine(dec, config=cfg, slots=4, max_len=48, length_bucket=32)
    with torch.inference_mode():
        eng.register_prefix("p", prefill_prefix(dec, inputs_embeds=dec.embed_input_ids(torch.arange(4, 10)[None])))
    reqs = [Request(f"r{i}", input_ids=p, max_new_tokens=3) for i, p in enumerate(_prompts([2, 7, 3], seed=1))]
    reqs += [Request(f"s{i}", input_ids=p, max_new_tokens=3, prefix_id="p") for i, p in enumerate(_prompts([1, 5, 2]))]
    calls.clear()
    eng.run(reqs)
    assert eng.stats.suffix_prefills >= 1 and len(calls) == eng.stats.prefills * dec.cfg.num_layers and all(calls)

    veng = ContinuousBatchingEngine.for_vidlm(pm, config=GenerationConfig(max_new_tokens=3, eos_token_id=-1),
                                              slots=2, max_len=128, length_bucket=32)
    video = _videos(1, seed=2)[0]
    calls.clear()
    veng.register_prefix_video("v", video)
    veng.run([Request("a", prompt_text="In: a?\nOut: ", video=video, max_new_tokens=3),
              Request("b", prompt_text="In: text only?\nOut: ", max_new_tokens=3),
              Request("c", prompt_text="In: c?\nOut: ", prefix_id="v", max_new_tokens=3),
              Request("d", prompt_text="In: dd?\nOut: ", prefix_id="v", max_new_tokens=3)])
    assert calls and all(calls), calls
