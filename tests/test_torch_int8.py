"""Int8 serving in the port (merv_tpu_torch) against merv_tpu: weight-only int8 Linears and the int8 KV cache.

Bit-equal where merv_tpu's arithmetic is repeated exactly: the int8 weights
and their scales (``quantize_kernel``, ``quantize_tree`` carried over by the
bridge, load order), and the cache's int8 values and scales (``_quantize_kv``),
each against merv_tpu's function jitted, as merv_tpu serves it (XLA computes
its ``amax / 127`` as ``amax * (1/127)``; test_eager_division_differs_from_what_merv_tpu_serves shows
that an eager call does not).
Elsewhere in fp32 on tiny configs, as tests/test_crossstack_parity.py holds a
port: identical greedy tokens and finish reasons, logits within 1e-4
(absolute and relative). The int8 Linear in bf16 is held within one bf16
rounding of merv_tpu's (2**-8 relative): both sum in fp32, in other orders,
before the same two roundings. K4 and K5 themselves run on the card
(tests/test_torch_int8_cuda.py); here their wrappers take the plain versions,
which are what merv_tpu computes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import merv_tpu.nn.quantization as jax_q
import merv_tpu_torch.ops.attention as A
import merv_tpu_torch.ops.int8_linear as K4
from merv_tpu.models.backbones.llm.transformer import KVCache as JaxKVCache
from merv_tpu.models.backbones.llm.transformer import _quantize_kv as jax_quantize_kv
from merv_tpu.models.backbones.llm.transformer import pack_serving_params as jax_pack_serving_params
from merv_tpu.models.generation import GenerationConfig as JaxGenConfig
from merv_tpu.models.generation import generate as jax_generate
from merv_tpu.models.generation import generate_speculative as jax_generate_speculative
from merv_tpu.nn.core import Linear as JaxLinear
from merv_tpu.ops.attention import attention_reference as jax_attention_reference
from merv_tpu.serving.engine import ContinuousBatchingEngine as JaxEngine
from merv_tpu_torch.bridge import state_dict_from_jax
from merv_tpu_torch.models.backbones.llm.transformer import KVCache, LlamaDecoder, _quantize_kv, tiny_decoder_config
from merv_tpu_torch.models.generation import GenerationConfig, generate, generate_speculative
from merv_tpu_torch.nn.core import Linear
from merv_tpu_torch.nn.quantization import apply_quantized, dequantize_kernel, quantize_kernel, quantize_tree
from merv_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain, dequantize_kv
from merv_tpu_torch.serving import ContinuousBatchingEngine
from test_torch_generation_shared import LLM, _decoders, _np_tree
from test_torch_serving_engine import _case, _configs, _requests

TOL = dict(atol=1e-4, rtol=1e-4)
CPU = torch.device("cpu")


def _jax_quantized(params):
    """merv_tpu's quantize_tree as it serves it (jitted, as in its load_vid)."""
    return _np_tree(jax.jit(jax_q.quantize_tree)(params))


@pytest.fixture(scope="module")
def int8_decoders():
    """(merv_tpu decoder, its int8 params, the port's int8 decoder on the same bytes)."""
    jdec, params, dec = _decoders(seed=5)
    qparams = _jax_quantized(params)
    quantize_tree(dec)
    dec.load_state_dict(state_dict_from_jax(qparams), strict=True)
    return jdec, qparams, dec


# ---------------------------------------------------------------------------
# the int8 values and scales, bit for bit
# ---------------------------------------------------------------------------


def test_quantize_kernel_is_bit_equal():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((48, 40)).astype(np.float32)  # (in, out), merv_tpu's layout
    w[:, 3] = 0.0  # an all-zero column: scale 1.0, values 0
    w[5, 7] = 127.5 * np.abs(w[:, 7]).max() / 127.0  # a value that rounds half to even at the clip
    want = jax.jit(jax_q.quantize_kernel)(jnp.asarray(w))  # as merv_tpu serves it: inside a jitted program
    q, scale = quantize_kernel(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want["kernel_q"]).T)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want["scale"])[0])
    assert scale[3] == 1.0 and not q[3].any()
    np.testing.assert_array_equal(dequantize_kernel(q, scale).numpy(),
                                  np.asarray(jax_q.dequantize_kernel(want)).T)
    x = rng.standard_normal((3, 48)).astype(np.float32)
    np.testing.assert_allclose(apply_quantized(torch.from_numpy(x), q, scale).numpy(),
                               np.asarray(jax_q.apply_quantized(jnp.asarray(x), want)), atol=1e-5, rtol=1e-5)


def test_quantize_kv_is_bit_equal():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 3, 5, 16)) * 3).astype(np.float32)
    x[1, 2, 4] = 0.0  # an all-zero position
    jq, js = jax.jit(jax_quantize_kv)(jnp.asarray(x))  # as merv_tpu's jitted decoder writes its cache
    q, s = _quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[1, 2, 4, 0] == 1.0
    np.testing.assert_array_equal(dequantize_kv(q, s, torch.float32).numpy(),
                                  np.asarray(jq).astype(np.float32) * np.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_linear_matches_jax(dtype):
    """merv_tpu's Linear on its int8 leaves against the port's quantized Linear
    (with a bias): fp32 within 1e-5; bf16 within one bf16 rounding."""
    rng = np.random.default_rng(2)
    jl = JaxLinear(64, 24, use_bias=True)
    params = _np_tree(jl.init(jax.random.PRNGKey(3)))
    qparams = {**_jax_quantized({"kernel": params["kernel"]}), "bias": params["bias"]}
    lin = Linear(64, 24, use_bias=True).quantize_()
    lin.load_state_dict(state_dict_from_jax(qparams), strict=True)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jl(qparams, jnp.asarray(x, jdt)).astype(jnp.float32))
    got = lin(torch.from_numpy(x).to(tdt)).float().numpy()
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=2 ** -8 * np.abs(want).max(), rtol=2 ** -7)
    np.testing.assert_allclose(got, want, **tol)
    # K4's plain version is the module's arithmetic
    xt = torch.from_numpy(x).to(tdt)
    assert torch.equal(K4.int8_linear(xt, lin.weight_q, lin.scale, lin.bias), lin(xt))


def test_bridge_carries_stacked_int8_leaves(int8_decoders):
    """merv_tpu's quantize_tree on the stacked [L, in, out] decoder tree, carried
    over by the bridge, equals the port's quantize_tree on the same float
    weights, byte for byte (norm scales stay ``weight``)."""
    _, params, dec_ref = _decoders(seed=5)
    sd = state_dict_from_jax(_jax_quantized(params))
    assert sd["layers.1.attn.q_proj.weight_q"].dtype == torch.int8
    assert sd["layers.1.attn.q_proj.scale"].shape == (LLM["num_heads"] * LLM["head_dim"],)
    assert sd["layers.0.input_norm.weight"].dtype == torch.float32 and "layers.0.input_norm.scale" not in sd
    assert "embed_tokens.weight" in sd and "embed_tokens.weight_q" not in sd
    mine = quantize_tree(dec_ref.state_dict())
    assert sorted(mine) == sorted(sd)
    for name in sd:
        assert torch.equal(sd[name], mine[name]), name
    assert all(torch.equal(a, b) for a, b in zip(quantize_tree(dec_ref).state_dict().values(), mine.values()))


def test_load_order_and_packed_layout():
    """Quantizing after the cast to bf16 (merv_tpu's order) gives merv_tpu's
    bytes and, here, other bytes than quantizing the fp32 weights; merv_tpu's
    packed q/k/v and gate/up kernels quantize to the port's unpacked ones,
    column for column."""
    jdec, params, dec = _decoders(seed=9)
    bf = jax.tree_util.tree_map(lambda x: np.asarray(jnp.asarray(x).astype(jnp.bfloat16)), params)
    packed = _jax_quantized(jax_pack_serving_params(bf))
    dec.to(torch.bfloat16)
    quantize_tree(dec)
    sd = dec.state_dict()
    L, q_dim, kv_dim = len(dec.layers), LLM["num_heads"] * LLM["head_dim"], LLM["num_kv_heads"] * LLM["head_dim"]
    for i in range(L):
        qkv, gu = packed["layers"]["attn"]["qkv_proj"], packed["layers"]["mlp"]["gate_up_proj"]
        cols = {"attn.q_proj": (0, q_dim), "attn.k_proj": (q_dim, q_dim + kv_dim),
                "attn.v_proj": (q_dim + kv_dim, q_dim + 2 * kv_dim)}
        for name, (a, b) in cols.items():
            np.testing.assert_array_equal(sd[f"layers.{i}.{name}.weight_q"].numpy(), qkv["kernel_q"][i][:, a:b].T)
            np.testing.assert_array_equal(sd[f"layers.{i}.{name}.scale"].numpy(), qkv["scale"][i][0, a:b])
        inter = LLM["intermediate_size"]
        for name, (a, b) in {"mlp.gate_proj": (0, inter), "mlp.up_proj": (inter, 2 * inter)}.items():
            np.testing.assert_array_equal(sd[f"layers.{i}.{name}.weight_q"].numpy(), gu["kernel_q"][i][:, a:b].T)
    fp32_first = quantize_kernel(torch.tensor(np.asarray(params["layers"]["attn"]["q_proj"]["kernel"][0]).T))[0]
    assert not torch.equal(fp32_first, sd["layers.0.attn.q_proj.weight_q"])


# ---------------------------------------------------------------------------
# decoding with int8 weights and an int8 cache
# ---------------------------------------------------------------------------

MODES = {"weights": (True, None), "kv": (False, "int8"), "both": (True, "int8")}


def _prompt(seed=0, B=2, T=7):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, LLM["vocab_size"], size=(B, T))
    mask = np.ones((B, T), np.int64)
    mask[1, T - 2:] = 0
    return ids, mask


@pytest.mark.parametrize("mode", list(MODES))
def test_generate_matches_jax(mode, int8_decoders):
    """``generate`` with int8 weights, an int8 cache or both: merv_tpu's greedy
    tokens, and the prefill and first decode step's logits within 1e-4."""
    quant, kv = MODES[mode]
    jdec, qparams, qdec = int8_decoders
    if quant:
        params, dec = qparams, qdec
    else:
        jdec, params, dec = _decoders(seed=5)
    ids, mask = _prompt(seed=1)
    cfg = dict(max_new_tokens=6, eos_token_id=-1, kv_cache_dtype=kv)
    want = np.asarray(jax_generate(jdec, params, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                                   config=JaxGenConfig(**cfg)))
    got = generate(dec, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                   config=GenerationConfig(**cfg))
    np.testing.assert_array_equal(got.numpy(), want)
    # the prefill into a cache and one T=1 step on it
    T, n = ids.shape[1], 12
    jc = JaxKVCache.create(jdec.cfg, 2, n, dtype=jnp.int8 if kv else jnp.float32)
    c = KVCache.create(dec.cfg, 2, n, torch.int8 if kv else torch.float32, CPU)
    jl, jc = jdec(params, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask), kv_cache=jc)
    with torch.inference_mode():
        pl, c = dec(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask), kv_cache=c)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    if kv:
        np.testing.assert_allclose(c.k_scale.numpy(), np.asarray(jc.k_scale), **TOL)
        assert (np.abs(c.k.numpy().astype(int) - np.asarray(jc.k).astype(int)) <= 1).all()
    step = np.full((2, 1), 5)
    jl, _ = jdec(params, input_ids=jnp.asarray(step), attention_mask=jnp.ones((2, n), jnp.int32), kv_cache=jc)
    with torch.inference_mode():
        pl, _ = dec(input_ids=torch.from_numpy(step), attention_mask=torch.ones((2, n), dtype=torch.long),
                    kv_cache=c)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)


def test_generate_speculative_matches_jax(int8_decoders):
    jdec, params, dec = int8_decoders
    ids = np.array([[5, 6, 7, 8, 5, 6, 7, 8, 5, 6, 7]])
    cfg = dict(max_new_tokens=10, eos_token_id=-1, kv_cache_dtype="int8")
    want = np.asarray(jax_generate_speculative(jdec, params, input_ids=jnp.asarray(ids), config=JaxGenConfig(**cfg),
                                               gamma=3))
    got = generate_speculative(dec, input_ids=torch.from_numpy(ids), config=GenerationConfig(**cfg), gamma=3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), generate(dec, input_ids=torch.from_numpy(ids),
                                                        config=GenerationConfig(**cfg)).numpy())


@pytest.mark.parametrize("name", ["slot_reuse", "prefix_mixed", "speculative"])
def test_engine_int8_matches_merv_tpu(name, int8_decoders):
    """Both engines on int8 weights and an int8 slot cache: the same greedy
    tokens, finish reasons and program counts, plain, with shared prefixes
    and speculating."""
    from merv_tpu.models.generation import prefill_prefix as jax_prefill_prefix
    from merv_tpu_torch.models.generation import prefill_prefix

    jdec, params, dec = int8_decoders
    kw, gkw, spec, prefixes = _case(name, dec)
    cfg, jcfg = _configs(kv_cache_dtype="int8", **gkw)
    port_reqs, jax_reqs = _requests(spec)
    jeng, eng = JaxEngine(jdec, params, config=jcfg, **kw), ContinuousBatchingEngine(dec, config=cfg, **kw)
    assert eng._state.k.dtype == torch.int8 and eng._state.k_scale.dtype == torch.float32
    for pid, ids in prefixes.items():
        jeng.register_prefix(pid, jax_prefill_prefix(jdec, params, kv_cache_dtype="int8", inputs_embeds=jdec.embed_input_ids(
            params, jnp.asarray(ids[None]))))
        with torch.inference_mode():
            eng.register_prefix(pid, prefill_prefix(dec, kv_cache_dtype="int8", inputs_embeds=dec.embed_input_ids(
                torch.as_tensor(ids[None]).long())))
    want, got = jeng.run(jax_reqs), eng.run(port_reqs)
    assert sorted(got) == sorted(want) == sorted(r[0] for r in spec)
    for rid in want:
        np.testing.assert_array_equal(got[rid].token_ids, want[rid].token_ids, err_msg=rid)
        assert got[rid].finish_reason == want[rid].finish_reason, rid
    for key in ("prefill_buckets", "prefills", "prefix_admissions", "decode_chunks", "spec_steps", "spec_emitted"):
        assert getattr(eng.stats, key) == getattr(jeng.stats, key), key


def test_engine_refuses_a_prefix_of_the_other_dtype(int8_decoders):
    """merv_tpu's two dtype checks, with its messages."""
    from merv_tpu_torch.models.generation import VideoPrefix, prefill_prefix

    _, _, dec = int8_decoders
    eng = ContinuousBatchingEngine(dec, config=GenerationConfig(kv_cache_dtype="int8"), slots=1, max_len=32)
    with torch.inference_mode():
        bf = prefill_prefix(dec, inputs_embeds=dec.embed_input_ids(torch.arange(3, 8)[None]))
    with pytest.raises(ValueError, match="was built with kv_cache_dtype=None but this engine serves 'int8'"):
        eng.register_prefix("p", VideoPrefix(bf, (), None))
    with pytest.raises(ValueError, match="cache dtype float32 does not match the engine's KV dtype int8"):
        eng.register_prefix("p", bf)


def test_slot_scales_follow_the_scratch_row(int8_decoders):
    """A per-slot write at or past the last row lands in the scratch row, the
    scales too; no key mask admits it, so the valid rows' attention is as if it
    never happened."""
    _, _, dec = int8_decoders
    rows = 10
    cache = KVCache.create(dec.cfg, 2, rows, torch.int8, CPU)
    ids = torch.tensor([[7], [9]])
    with torch.inference_mode():
        dec(input_ids=torch.tensor([[3, 4, 5], [3, 4, 5]]), kv_cache=cache)
        pos = torch.tensor([[3], [rows - 1]])  # the same RoPE positions for both pointers
        logits, _ = dec(input_ids=ids, positions=pos, kv_cache=cache.at(torch.tensor([3, rows + 4])))
        again, _ = dec(input_ids=ids, positions=pos, kv_cache=cache.at(torch.tensor([3, rows - 1])))
    assert (cache.k_scale[:, 1, :, 3 : rows - 1] == 1.0).all()  # nothing written between
    assert not (cache.k_scale[:, 1, :, rows - 1] == 1.0).all()  # the scratch row took the write
    torch.testing.assert_close(logits, again, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K5's plain version: merv_tpu's dequantize-then-attention
# ---------------------------------------------------------------------------


def _offset(form, B, Tk, Tq):
    return {"none": None, "int": Tk - Tq - 3, "scalar_tensor": torch.tensor(Tk - Tq - 5),
            "vector": torch.tensor([Tk - Tq - 1, 4][:B])}[form]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_cache", "int8_cache"])
@pytest.mark.parametrize("form", ["t1_mask", "none", "int", "scalar_tensor", "vector"])
def test_decode_attention_plain_matches_jax(form, int8):
    """At every offset form (T = 1 under a key mask only; T = 5 causal with
    None / a host int / a 0-d tensor / a [B] tensor), GQA 4 -> 2, with a
    ragged key mask and a row with no valid key: the plain version (and the
    wrapper on the CPU) against merv_tpu's dequantize then attention_reference,
    in bf16 to the bit."""
    rng = np.random.default_rng(4)
    B, H, Hk, Tk, D = 2, 4, 2, 24, 16
    Tq = 1 if form == "t1_mask" else 5
    q = rng.standard_normal((B, H, Tq, D)).astype(np.float32)
    kf = rng.standard_normal((B, Hk, Tk, D)).astype(np.float32)
    vf = rng.standard_normal((B, Hk, Tk, D)).astype(np.float32)
    mask = np.ones((B, Tk), bool)
    mask[0, 17:] = False
    mask[1, :6] = False
    if form == "t1_mask":
        mask[1] = False  # row 1 sees no key: the mean of V over the buffer
    qt = torch.from_numpy(q).to(torch.bfloat16)
    if int8:
        (k8, ks), (v8, vs) = _quantize_kv(torch.from_numpy(kf)), _quantize_kv(torch.from_numpy(vf))
        kj = (jnp.asarray(k8.numpy()).astype(jnp.float32) * jnp.asarray(ks.numpy())).astype(jnp.bfloat16)
        vj = (jnp.asarray(v8.numpy()).astype(jnp.float32) * jnp.asarray(vs.numpy())).astype(jnp.bfloat16)
        args = (k8, v8, ks, vs)
    else:
        kb, vb = torch.from_numpy(kf).to(torch.bfloat16), torch.from_numpy(vf).to(torch.bfloat16)
        kj, vj = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (kb, vb))
        args = (kb, vb)
    causal = form != "t1_mask"
    off = _offset(form, B, Tk, Tq) if causal else None
    joff = None if off is None else (jnp.asarray(off.numpy()) if isinstance(off, torch.Tensor) else off)
    want = jax_attention_reference(jnp.asarray(q).astype(jnp.bfloat16), kj, vj, causal=causal,
                                   kv_mask=jnp.asarray(mask), q_offset=joff)
    kw = dict(kv_mask=torch.from_numpy(mask), causal=causal, q_offset=off)
    got = decode_attention_plain(qt, *args, **kw)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert torch.equal(decode_attention(qt, *args, **kw), got)
    if form == "t1_mask":
        mean = (dequantize_kv(args[1], args[3], torch.bfloat16) if int8 else args[1])[1].float()
        w = torch.tensor(1.0 / Tk).to(torch.bfloat16).float()
        torch.testing.assert_close(got[1, :, 0].float(), (mean.repeat_interleave(2, 0) * w).sum(1).to(torch.bfloat16)
                                   .float(), atol=2e-2, rtol=2e-2)


def test_decoder_sends_short_cached_calls_to_decode_attention(int8_decoders, monkeypatch):
    """Calls with a cache and at most 16 query rows reach K5's wrapper with
    the cache buffers themselves (no copy); longer ones dequantize and go
    through attention() (K2 on the card)."""
    import merv_tpu_torch.ops.decode_attention as K5

    _, _, dec = int8_decoders
    seen = []
    real = K5.decode_attention

    def spy(q, k, v, ks=None, vs=None, **kw):
        seen.append((q.shape[2], k.data_ptr(), k.dtype))
        return real(q, k, v, ks, vs, **kw)

    monkeypatch.setattr(K5, "decode_attention", spy)
    cache = KVCache.create(dec.cfg, 1, 40, torch.int8, CPU)
    with torch.inference_mode():
        dec(input_ids=torch.arange(3, 23)[None], kv_cache=cache)  # T = 20: attention()
        assert seen == []
        dec(input_ids=torch.arange(3, 19)[None], kv_cache=cache.at(20))  # T = 16: K5
        dec(input_ids=torch.tensor([[4]]), kv_cache=cache.at(torch.tensor(36)))
    assert [s[0] for s in seen] == [16] * len(dec.layers) + [1] * len(dec.layers)
    assert {s[1] for s in seen} == {cache.k[i].data_ptr() for i in range(len(dec.layers))}
    assert {s[2] for s in seen} == {torch.int8}


def test_launch_accounting_helpers():
    before = A.launch_counts()
    A.add_launch_counts({"decode_attention": 3, "int8_linear": 2})
    assert A.launches_since(before) == {"decode_attention": 3, "int8_linear": 2}
    A.add_launch_counts({"decode_attention": -3, "int8_linear": -2})
    assert A.launch_counts() == before


def test_quantized_linear_splits_by_rows():
    """At most 64 rows go to K4's wrapper, more to the plain matmul form (counted)."""
    lin = Linear(64, 8)
    lin.reset_parameters(torch.Generator().manual_seed(0))
    lin.quantize_()
    K4.reset_matmul_dispatches()
    for rows in (1, 64, 65):
        lin(torch.randn(rows, 64))
    assert K4.matmul_dispatches() == {"int8_linear_matmul": 1}


def test_eager_division_differs_from_what_merv_tpu_serves():
    """merv_tpu's ``amax / 127.0`` eagerly is a division; under jit (its
    load_vid and its decoder) XLA makes it a product with fp32 1/127. The port
    repeats the jitted form, so on these weights it differs from the eager call
    in some scales' last bit and equals the jitted call everywhere."""
    w = np.random.default_rng(0).standard_normal((128, 512)).astype(np.float32) * 0.02
    eager, jitted = jax_q.quantize_kernel(jnp.asarray(w)), jax.jit(jax_q.quantize_kernel)(jnp.asarray(w))
    _, scale = quantize_kernel(torch.from_numpy(w.T.copy()))
    assert (scale.numpy() != np.asarray(eager["scale"])[0]).any()
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jitted["scale"])[0])
