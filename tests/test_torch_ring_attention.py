"""The port's sequence parallelism (merv_tpu_torch/ops/ring_attention.py,
merv_tpu_torch/parallel, the decoder's sp paths) against merv_tpu's on the
same numpy-seeded inputs.

merv_tpu runs on its 8 virtual CPU devices (tests/test_ring_attention.py's
mesh: data 2 x sp 4); the port runs its plain kernel versions over 4
in-process virtual ranks (``VirtualMesh(4)``), and once over a spawned gloo
world of 4 processes (the process-group exchange), held against the
in-process result. fp32 within 1e-4 on outputs, gradients and logits.
"""

import dataclasses
import logging
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import merv_tpu.ops.ring_attention as JR
import merv_tpu_torch.ops.attention as A
import merv_tpu_torch.ops.decode_attention as K5
import merv_tpu_torch.ops.ring_attention as R
import merv_tpu_torch.overwatch as ow
import torch_sp_workers
from merv_tpu.models.backbones.llm.transformer import KVCache as JaxKVCache
from merv_tpu.models.backbones.llm.transformer import LlamaDecoder as JaxDecoder
from merv_tpu.models.backbones.llm.transformer import tiny_decoder_config as jax_tiny_decoder
from merv_tpu.parallel import MeshConfig as JaxMeshConfig
from merv_tpu.parallel import build_mesh as jax_build_mesh
from merv_tpu.parallel.sharding import activation_mesh as jax_activation_mesh
from merv_tpu_torch.bridge import state_dict_from_jax
from merv_tpu_torch.models.backbones.llm.transformer import KVCache, LlamaDecoder, tiny_decoder_config
from merv_tpu_torch.parallel import MeshConfig, VirtualMesh, activation_mesh, axis_size, mesh_shape
from merv_tpu_torch.parallel.mesh import SEQ_AXIS

TOL = dict(atol=1e-4, rtol=1e-4)
VM = VirtualMesh(4)


@pytest.fixture(scope="module")
def jmesh():
    return jax_build_mesh(JaxMeshConfig(data=2, fsdp=1, tensor=1, seq=4))


def _qkv(seed, B, H, Hk, S, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in ((B, H, S, D), (B, Hk, S, D), (B, Hk, S, D)))


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def _jax_ring(jmesh, q, k, v, **kw):
    return np.asarray(jax.jit(lambda q, k, v: JR.ring_attention(q, k, v, jmesh, **kw))(q, k, v))


# ---------------------------------------------------------------------------
# the ring, forward
# ---------------------------------------------------------------------------

RING_CASES = {
    "full": dict(shape=(2, 4, 4, 64, 16), causal=False),
    "causal": dict(shape=(2, 4, 4, 64, 16), causal=True),
    "gqa_full": dict(shape=(2, 8, 2, 32, 8), causal=False),
    "gqa_causal": dict(shape=(2, 8, 2, 32, 8), causal=True),
}


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_matches_merv_tpu(jmesh, case):
    c = RING_CASES[case]
    q, k, v = _qkv(0, *c["shape"])
    want = _jax_ring(jmesh, q, k, v, causal=c["causal"])
    got = R.ring_attention(*_t(q, k, v), VM, causal=c["causal"])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("gqa", [False, True])
def test_zigzag_ring_matches_merv_tpu(jmesh, gqa):
    q, k, v = _qkv(1, 2, 8 if gqa else 4, 2 if gqa else 4, 64, 16)
    perm = R.zigzag_perm(64, 4)
    np.testing.assert_array_equal(perm, JR.zigzag_perm(64, 4))
    zq, zk, zv = (x[:, :, perm] for x in (q, k, v))
    want = _jax_ring(jmesh, zq, zk, zv, causal=True, zigzag=True)
    got = R.ring_attention(*_t(zq, zk, zv), VM, causal=True, zigzag=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # back in natural order it is plain causal attention
    ref = A.attention_reference(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(got.numpy()[:, :, np.argsort(perm)], ref.numpy(), **TOL)


def test_ring_bf16_stays_bf16_and_close():
    q, k, v = (t.to(torch.bfloat16) for t in _t(*_qkv(2, 2, 4, 4, 64, 16)))
    out = R.ring_attention(q, k, v, VM, causal=True)
    assert out.dtype == torch.bfloat16
    ref = A.attention_reference(q.float(), k.float(), v.float(), causal=True)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_block_q_chunking_matches(jmesh, causal):
    """K2 tiles the queries itself: block_q changes nothing, as it changes nothing in merv_tpu."""
    q, k, v = _qkv(3, 2, 4, 4, 64, 16)
    base = R.ring_attention(*_t(q, k, v), VM, causal=causal)
    for bq in (512, 8, 4):
        np.testing.assert_array_equal(R.ring_attention(*_t(q, k, v), VM, causal=causal, block_q=bq).numpy(),
                                      base.numpy())
    np.testing.assert_allclose(base.numpy(), _jax_ring(jmesh, q, k, v, causal=causal, block_q=4), **TOL)


@pytest.mark.parametrize("sq, target", [(16, 512), (16, 4), (12, 5), (7, 3), (1, 4)])
def test_ring_q_block_divisor(sq, target):
    assert R._ring_q_block(sq, target) == JR._ring_q_block(sq, target)


@pytest.mark.parametrize("seq, n", [(64, 4), (32, 2), (16, 8)])
def test_zigzag_perm_roundtrip(seq, n):
    perm = R.zigzag_perm(seq, n)
    np.testing.assert_array_equal(perm, JR.zigzag_perm(seq, n))
    np.testing.assert_array_equal(np.arange(seq)[perm][np.argsort(perm)], np.arange(seq))


def test_ring_rejects_bad_shapes():
    q, k, v = _t(*_qkv(4, 1, 2, 2, 64, 8))
    with pytest.raises(ValueError, match="zigzag layout only applies"):
        R.ring_attention(q, k, v, VM, causal=False, zigzag=True)
    with pytest.raises(ValueError, match="not divisible by 2\\*sp"):
        R.ring_attention(q[:, :, :36], k[:, :, :36], v[:, :, :36], VM, causal=True, zigzag=True)
    with pytest.raises(ValueError, match="not divisible"):
        R.ring_attention(q[:, :, :30], k[:, :, :30], v[:, :, :30], VM, causal=True)
    with pytest.raises(ValueError, match="kv heads"):
        R.ring_attention(q, k[:, :1].expand(1, 3, 64, 8).contiguous(), v[:, :1].expand(1, 3, 64, 8).contiguous(),
                         VM, causal=True)


@pytest.mark.parametrize("mesh", [None, VirtualMesh(1)], ids=["no_mesh", "sp1"])
def test_ring_falls_back_off_mesh(mesh):
    q, k, v = _t(*_qkv(5, 2, 2, 2, 16, 8))
    got = R.ring_attention(q, k, v, mesh, causal=True)
    np.testing.assert_allclose(got.numpy(), A.attention_reference(q, k, v, causal=True).numpy(), atol=2e-6)
    assert R.sp_exchange(mesh) is None


@pytest.mark.parametrize("n, causal, zigzag, want", [(2, True, False, 3), (4, True, False, 10), (4, False, False, 16),
                                                     (2, True, True, 8), (4, True, True, 24)])
def test_ring_block_counts(n, causal, zigzag, want):
    """K2 calls of one ring forward: n(n+1)/2 with the masked blocks skipped; zigzag 3n + n(n-1)."""
    assert R.ring_block_count(n, causal, zigzag) == want


# ---------------------------------------------------------------------------
# the ring, backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("zigzag, gqa", [(False, False), (True, False), (False, True), (True, True)])
def test_ring_grads_match_merv_tpu(jmesh, zigzag, gqa):
    q, k, v = _qkv(6, 2, 8 if gqa else 4, 2 if gqa else 4, 64, 16)
    do = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    if zigzag:
        perm = R.zigzag_perm(64, 4)
        q, k, v, do = (x[:, :, perm] for x in (q, k, v, do))

    def jloss(q, k, v):
        return jnp.sum(JR.ring_attention(q, k, v, jmesh, causal=True, zigzag=zigzag) * do)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    leaves = tuple(t.requires_grad_() for t in _t(q, k, v))
    out = R.ring_attention(*leaves, VM, causal=True, zigzag=zigzag)
    out.backward(torch.from_numpy(do))
    for got, w in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), **TOL)


def test_ring_backward_launch_plan_matches_forward(monkeypatch):
    """The backward replays exactly the forward's blocks (one K3 call each)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = A.flash_attention_forward_plain, A.flash_attention_backward_plain

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(A, "flash_attention_forward_plain", count("fwd", fwd))
    monkeypatch.setattr(A, "flash_attention_backward_plain", count("bwd", bwd))
    leaves = tuple(t.requires_grad_() for t in _t(*_qkv(8, 1, 2, 2, 32, 8)))
    R.ring_attention(*leaves, VM, causal=True, zigzag=True, impl="plain").sum().backward()
    assert calls == {"fwd": 24, "bwd": 24}


# ---------------------------------------------------------------------------
# attention over a sharded KV cache
# ---------------------------------------------------------------------------


def _cache_case(seed, B=2, H=4, Hk=2, T=3, L=32, D=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, D)).astype(np.float32)
    k = rng.standard_normal((B, Hk, L, D)).astype(np.float32)
    v = rng.standard_normal((B, Hk, L, D)).astype(np.float32)
    return q, k, v


def _jax_cache(jmesh, q, k, v, mask, off):
    fn = jax.jit(lambda q, k, v, m, o: JR.sharded_cache_attention(q, k, v, m, jmesh, q_offset=o))
    return np.asarray(fn(q, k, v, mask, jnp.asarray(off, jnp.int32)))


CACHE_CASES = {
    # (T, per-row key masks as (start, stop) of valid keys, q_offset): L = 32 over 4 shards of 8
    "scalar_decode": (1, [(0, 20), (0, 20)], 19),
    "scalar_verify": (5, [(0, 32), (0, 32)], 10),
    "per_slot_verify": (5, [(0, 32), (0, 32)], [3, 22]),
    "ragged_edges": (3, [(0, 9), (0, 17)], [6, 14]),
    "empty_on_one_shard": (3, [(0, 32), (2, 32)], 5),  # the offsets leave shards 1-3 without a key
    "prefill_k2_route": (20, [(0, 32), (0, 26)], 4),
}


@pytest.mark.parametrize("case", list(CACHE_CASES))
def test_sharded_cache_attention_matches_merv_tpu(jmesh, case):
    T, spans, off = CACHE_CASES[case]
    q, k, v = _cache_case(9, T=T)
    mask = np.zeros((2, 32), bool)
    for b, (lo, hi) in enumerate(spans):
        mask[b, lo:hi] = True
    want = _jax_cache(jmesh, q, k, v, mask, off)
    q_off = torch.tensor(off) if isinstance(off, list) else off
    got = R.sharded_cache_attention(*_t(q, k, v), torch.from_numpy(mask), VM, q_offset=q_off)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_sharded_cache_row_empty_everywhere_is_zero(jmesh):
    """merv_tpu's sharded body gives 0 to a row with no valid key on any shard
    (its unsharded path gives the mean of V: each path matches its own)."""
    q, k, v = _cache_case(10)
    mask = np.ones((2, 32), bool)
    mask[1] = False
    want = _jax_cache(jmesh, q, k, v, mask, 30)
    got = R.sharded_cache_attention(*_t(q, k, v), torch.from_numpy(mask), VM, q_offset=30)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert float(got[1].abs().max()) == 0.0
    off = R.sharded_cache_attention(*_t(q, k, v), torch.from_numpy(mask), None, q_offset=30)
    np.testing.assert_allclose(off[1].numpy(), np.broadcast_to(v[1].repeat(2, 0).mean(1, keepdims=True), off[1].shape),
                               atol=1e-5)


def test_sharded_cache_int8_matches_merv_tpu(jmesh):
    """An int8 cache with fp32 scales: merv_tpu's decoder dequantizes before
    its sharded call; the port hands the shards to the kernel as they lie."""
    from merv_tpu_torch.models.backbones.llm.transformer import _quantize_kv

    q, k, v = _cache_case(11, T=4)
    (kq, ks), (vq, vs) = _quantize_kv(torch.from_numpy(k)), _quantize_kv(torch.from_numpy(v))
    kd, vd = (K5.dequantize_kv(a, s, torch.float32).numpy() for a, s in ((kq, ks), (vq, vs)))
    mask = np.ones((2, 32), bool)
    want = _jax_cache(jmesh, q, kd, vd, mask, [5, 27])
    got = R.sharded_cache_attention(torch.from_numpy(q), kq, vq, torch.from_numpy(mask), VM,
                                    q_offset=torch.tensor([5, 27]), k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_sharded_cache_rejects_indivisible_length():
    q, k, v = _t(*_cache_case(12, L=30))
    with pytest.raises(ValueError, match="not divisible"):
        R.sharded_cache_attention(q, k, v, None, VM, q_offset=3)


@pytest.mark.parametrize("T, off", [(1, 5), (4, -3), (4, 40), (4, torch.tensor([-5, 3]))])
def test_decode_attention_plain_lse(T, off):
    """K5's plain version with its LSE: the function of the reference on rows
    with a valid key, 0 and -inf on a row without one (a negative offset
    hides every key, one past the shard shows them all)."""
    q, k, v = _t(*_cache_case(13, T=T, L=24))
    mask = torch.ones(2, 24, dtype=torch.bool)
    o, lse = K5.decode_attention_plain(q, k, v, kv_mask=mask, causal=True, q_offset=off, return_lse=True)
    offs = off if isinstance(off, torch.Tensor) else torch.full((2,), off)
    for b in range(2):
        for t in range(T):
            hi = int(offs[b]) + t + 1
            if hi <= 0:
                assert float(o[b, :, t].abs().max()) == 0 and bool(torch.isneginf(lse[b, :, t]).all())
                continue
            kk, vv = k[b:b + 1, :, :hi].repeat_interleave(2, 1), v[b:b + 1, :, :hi].repeat_interleave(2, 1)
            s = torch.einsum("hd,hkd->hk", q[b, :, t], kk[0]) * 16 ** -0.5
            torch.testing.assert_close(lse[b, :, t], torch.logsumexp(s, -1), atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(o[b, :, t], torch.einsum("hk,hkd->hd", s.softmax(-1), vv[0]), atol=1e-5,
                                       rtol=1e-5)


# ---------------------------------------------------------------------------
# layout helpers and the mesh
# ---------------------------------------------------------------------------


def test_constrain_seq_dim_and_cache_seq():
    x = torch.arange(4 * 64 * 2, dtype=torch.float32).view(4, 64, 2)
    assert R.constrain_seq_dim(x, VM) is x  # in-process ranks hold the whole sequence
    assert R.constrain_seq_dim(x, None) is x
    buf = torch.arange(2 * 16, dtype=torch.float32).view(1, 1, 2, 16, 1).expand(3, 1, 2, 16, 1).contiguous()
    sharded = R.constrain_cache_seq(buf, VM)
    assert sharded.shape == (3, 1, 2, 20, 1)
    torch.testing.assert_close(sharded[..., 5:9, :], buf[..., 4:8, :])
    assert float(sharded[..., 4, :].abs().max()) == 0  # each shard's scratch row
    assert R.constrain_cache_seq(buf[..., :15, :], VM).shape[3] == 15  # indivisible: unchanged


RESOLVE_CASES = [(dict(), 8), (dict(data=2, fsdp=1, seq=4), 8), (dict(data=1, fsdp=-1, tensor=1, seq=2), 8),
                 (dict(data=2, fsdp=-1, seq=2, pipe=2), 8), (dict(fsdp=-1, seq=3), 8), (dict(data=-1, fsdp=-1), 8),
                 (dict(data=3, fsdp=1), 8), (dict(data=1, fsdp=1, seq=2), 2)]


@pytest.mark.parametrize("kw, n", RESOLVE_CASES)
def test_mesh_config_resolve_matches_merv_tpu(kw, n):
    try:
        want = JaxMeshConfig(**kw).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" ")[0]):
            MeshConfig(**kw).resolve(n)
        return
    assert MeshConfig(**kw).resolve(n) == want


def test_virtual_mesh_axes():
    assert mesh_shape(VM) == {"data": 1, "fsdp": 1, "tensor": 1, "sp": 4, "pp": 1}
    assert axis_size(None, SEQ_AXIS) == 1 and axis_size(VirtualMesh(2, tensor=2), "tensor") == 2
    ex = R.sp_exchange(VM)
    assert isinstance(ex, R.VirtualRanks) and ex.n == 4 and ex.ranks == (0, 1, 2, 3)


def test_single_process_overwatch():
    w = ow.initialize_overwatch("merv_tpu_torch.single")
    assert (w.rank(), w.world_size(), w.is_rank_zero()) == (0, 1, True)
    assert w.rank_zero_only(lambda: 3)() == 3 and w.rank_zero_only()(lambda: 4)() == 4


# ---------------------------------------------------------------------------
# the decoder's sp paths
# ---------------------------------------------------------------------------

LLM = dict(num_layers=3)


@pytest.fixture(scope="module")
def decoders():
    jcfg = jax_tiny_decoder(compute_dtype=jnp.float32, sequence_parallel=True, **LLM)
    params = jax.tree_util.tree_map(np.asarray, JaxDecoder(jcfg).init(jax.random.PRNGKey(0)))
    cfg = tiny_decoder_config(compute_dtype=torch.float32, sequence_parallel=True, **LLM)
    dec = LlamaDecoder(cfg, device="cpu")
    dec.load_state_dict(state_dict_from_jax(params))
    plain = LlamaDecoder(dataclasses.replace(cfg, sequence_parallel=False), device="cpu")
    plain.load_state_dict(dec.state_dict())
    return JaxDecoder(jcfg), params, dec.eval(), plain.eval()


def _ids(seed, B, T):
    return np.random.RandomState(seed).randint(2, 64, (B, T)).astype(np.int32)


@pytest.mark.parametrize("zigzag", [True, False])
def test_decoder_sp_right_padding_matches_merv_tpu(jmesh, decoders, zigzag):
    jdec, params, dec, plain = decoders
    jdec = JaxDecoder(dataclasses.replace(jdec.cfg, sp_zigzag=zigzag))
    dec.cfg = dataclasses.replace(dec.cfg, sp_zigzag=zigzag)
    ids = _ids(9, 2, 16)
    mask = np.asarray([[1] * 16, [1] * 11 + [0] * 5], np.int32)
    with jax_activation_mesh(jmesh):
        want = np.asarray(jax.jit(lambda p, i, m: jdec(p, input_ids=i, attention_mask=m)[0])(params, ids, mask))
    with torch.no_grad(), activation_mesh(VM):
        got = dec(input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask))[0]
    ref = plain(input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask))[0].detach()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[valid], want[valid], **TOL)
    np.testing.assert_allclose(got.numpy()[valid], ref.numpy()[valid], **TOL)
    dec.cfg = dataclasses.replace(dec.cfg, sp_zigzag=True)


def test_decoder_sp_grads_and_remat_match_merv_tpu(jmesh, decoders):
    jdec, params, dec, _ = decoders
    ids = _ids(1, 2, 16)

    def jloss(p):
        with jax_activation_mesh(jmesh):
            logits, _ = jdec(p, input_ids=ids, remat=True)
            return jnp.mean(logits.astype(jnp.float32) ** 2)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    dec.requires_grad_(True)
    dec.zero_grad()
    with activation_mesh(VM):
        logits, _ = dec(input_ids=torch.from_numpy(ids).long(), remat=True)
        loss = (logits.float() ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    for name, p in dec.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-4, err_msg=name)
    dec.zero_grad()
    dec.requires_grad_(False)


def test_decoder_sp_indivisible_seq_falls_back(decoders):
    _, _, dec, plain = decoders
    ids = torch.from_numpy(_ids(2, 2, 10)).long()
    with torch.no_grad(), activation_mesh(VM):
        got = dec(input_ids=ids)[0]
    torch.testing.assert_close(got, plain(input_ids=ids)[0].detach(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("max_len, dtype", [(16, None), (18, None), (16, "int8")])
def test_decoder_sp_serving_cache_matches_merv_tpu(jmesh, decoders, max_len, dtype):
    """A cache that tiles sp shards its rows (prefill through the shards, then
    a T=1 step); one that does not stays whole, as merv_tpu falls back."""
    jdec, params, dec, plain = decoders
    ids = _ids(3, 1, 9)
    jdtype, tdtype = (jnp.int8, torch.int8) if dtype else (jnp.float32, torch.float32)

    def jrun(p, i, c):
        with jax_activation_mesh(jmesh):
            return jdec(p, input_ids=i, kv_cache=c)

    jcache = JaxKVCache.create(jdec.cfg, 1, max_len, dtype=jdtype)
    jpre, jcache = jax.jit(jrun)(params, ids[:, :8], jcache)
    jstep, _ = jax.jit(jrun)(params, ids[:, 8:9], jcache)
    with torch.no_grad(), activation_mesh(VM):
        cache = KVCache.create(dec.cfg, 1, max_len, tdtype, "cpu", mesh=VM)
        pre, cache = dec(input_ids=torch.from_numpy(ids[:, :8]).long(), kv_cache=cache)
        step, _ = dec(input_ids=torch.from_numpy(ids[:, 8:9]).long(), kv_cache=cache)
    assert (cache.sp is not None) == (max_len % 4 == 0)
    if cache.sp is not None:
        assert cache.k.shape[3] == max_len + 4  # each rank's rows and its scratch row
    np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), **TOL)
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), **TOL)


def test_decoder_sp_per_slot_cache_matches_unsharded(decoders):
    """Per-slot pointers over a sharded cache (the engine's decode and verify)
    give the unsharded per-slot cache's logits."""
    _, _, dec, plain = decoders
    ids = torch.from_numpy(_ids(4, 2, 14)).long()
    whole = KVCache.create(plain.cfg, 2, 17, torch.float32, "cpu")  # 16 positions and the scratch row
    with torch.no_grad():
        _, whole = plain(input_ids=ids[:, :9], kv_cache=whole)
        with activation_mesh(VM):
            shard = KVCache.create(dec.cfg, 2, 16, torch.float32, "cpu", mesh=VM)
            _, shard = dec(input_ids=ids[:, :9], kv_cache=shard)
        start = torch.tensor([3, 9])
        for t in (1, 4):
            want = plain(input_ids=ids[:, 9:9 + t], kv_cache=whole.at(start))[0]
            with activation_mesh(VM):
                got = dec(input_ids=ids[:, 9:9 + t], kv_cache=shard.at(start))[0]
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_decoder_refuses_tensor_and_pipe_axes(decoders):
    """A tensor axis beside sp runs the ring: a decoder that is not cut to
    tensor shards (on a virtual mesh its weights stay whole) computes what the
    plain decoder does (a cut one runs the ring on its heads:
    tests/test_torch_tensor_parallel.py). A pipeline axis runs GPipe
    (tests/test_torch_parallel_training.py), except beside an sp axis with
    both paths on: merv_tpu's ValueError."""
    _, _, dec, plain = decoders
    ids = torch.from_numpy(_ids(5, 1, 8)).long()
    with torch.no_grad():
        with activation_mesh(VirtualMesh(2, tensor=2)):
            got = dec(input_ids=ids)[0]
        torch.testing.assert_close(got, plain(input_ids=ids)[0], atol=1e-5, rtol=1e-5)
    both = LlamaDecoder(dataclasses.replace(dec.cfg, pipeline_parallel=True), device="cpu")
    with activation_mesh(VirtualMesh(2, pipe=3)), pytest.raises(ValueError, match="cannot both be active"):
        both(input_ids=ids)


# ---------------------------------------------------------------------------
# the process-group exchange: one gloo world of 4 spawned processes
# ---------------------------------------------------------------------------

WORLD = 4


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_world(fn, world, inp, tmp_path):
    """Run ``fn`` as ``world`` gloo ranks (spawned processes) on ``inp``; each rank's saved results."""
    import torch.multiprocessing as mp

    path = tmp_path / "inp.pt"
    torch.save(inp, path)
    mp.start_processes(fn, args=(world, _free_port(), str(path), str(tmp_path)), nprocs=world, join=True,
                       start_method="spawn")
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _world_inputs(decoders):
    _, _, dec, _ = decoders
    ring = {}
    for name, (shape, causal, zigzag) in {"causal": ((2, 4, 4, 64, 16), True, False),
                                          "full": ((2, 4, 4, 64, 16), False, False),
                                          "zigzag_gqa": ((2, 8, 2, 64, 16), True, True)}.items():
        q, k, v = _t(*_qkv(20, *shape))
        do = torch.randn(q.shape, generator=torch.Generator().manual_seed(21))
        ring[name] = dict(q=q, k=k, v=v, do=do, causal=causal, zigzag=zigzag)
    cache = {}
    for name in ("scalar_verify", "per_slot_verify", "empty_on_one_shard", "prefill_k2_route"):
        T, spans, off = CACHE_CASES[name]
        q, k, v = _t(*_cache_case(22, T=T))
        mask = torch.zeros(2, 32, dtype=torch.bool)
        for b, (lo, hi) in enumerate(spans):
            mask[b, lo:hi] = True
        cache[name] = dict(q=q, k=k, v=v, mask=mask, q_offset=torch.tensor(off) if isinstance(off, list) else off)
    ids = torch.from_numpy(_ids(9, 2, 16)).long()
    mask = torch.tensor([[1] * 16, [1] * 11 + [0] * 5])
    return dict(ring=ring, cache=cache, decoder=dict(cfg=dec.cfg, state=dec.state_dict(), ids=ids, mask=mask))


@pytest.fixture(scope="module")
def gloo_world(decoders, tmp_path_factory):
    inp = _world_inputs(decoders)
    return inp, spawn_world(torch_sp_workers.ring_world, WORLD, inp, tmp_path_factory.mktemp("ring_world"))


@pytest.mark.parametrize("case", ["causal", "full", "zigzag_gqa"])
def test_process_group_ring_matches_in_process(gloo_world, case):
    inp, ranks = gloo_world
    c = inp["ring"][case]
    leaves = tuple(c[t].clone().requires_grad_() for t in ("q", "k", "v"))
    out = R.ring_attention(*leaves, VM, causal=c["causal"], zigzag=c["zigzag"])
    out.backward(c["do"])
    for key, want in (("out", out.detach()), ("dq", leaves[0].grad), ("dk", leaves[1].grad), ("dv", leaves[2].grad)):
        got = torch.cat([r[f"ring/{case}"][key] for r in ranks], dim=2)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5, msg=key)


@pytest.mark.parametrize("case", ["scalar_verify", "per_slot_verify", "empty_on_one_shard", "prefill_k2_route"])
def test_process_group_cache_matches_in_process(gloo_world, case):
    inp, ranks = gloo_world
    c = inp["cache"][case]
    want = R.sharded_cache_attention(c["q"], c["k"], c["v"], c["mask"], VM, q_offset=c["q_offset"])
    for r in ranks:
        torch.testing.assert_close(r[f"cache/{case}"], want, atol=1e-5, rtol=1e-5)


def test_process_group_decoder_matches_in_process(gloo_world, decoders):
    inp, ranks = gloo_world
    _, _, dec, _ = decoders
    d = inp["decoder"]
    with torch.no_grad(), activation_mesh(VM):
        want = dec(input_ids=d["ids"], attention_mask=d["mask"])[0]
        cache = KVCache.create(dec.cfg, 1, 16, torch.float32, "cpu", mesh=VM)
        pre, cache = dec(input_ids=d["ids"][:1, :8], kv_cache=cache)
        step, _ = dec(input_ids=d["ids"][:1, 8:9], kv_cache=cache)
    valid = d["mask"].bool()
    for r in ranks:
        torch.testing.assert_close(r["decoder/no_cache"][valid], want[valid], atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(r["decoder/cache"]["prefill"], pre, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(r["decoder/cache"]["step"], step, atol=1e-5, rtol=1e-5)
        assert r["decoder/cache"]["rows"] == 16 // WORLD + 1  # a rank holds its rows and a scratch row


def test_process_group_mesh_and_overwatch(gloo_world):
    _, ranks = gloo_world
    for i, r in enumerate(ranks):
        assert r["mesh_shape"] == {"data": 1, "fsdp": 1, "tensor": 1, "sp": WORLD, "pp": 1}
        o = r["overwatch"]
        assert o["kind"] == "DistributedOverwatch" and (o["rank"], o["world_size"]) == (i, WORLD)
        assert o["rank_zero"] == (i == 0) and o["error"]
        assert o["info"] == (i == 0)  # INFO on rank zero, ERROR elsewhere
        assert (o["bare"], o["called"]) == ((0, 0) if i == 0 else (None, None))
        assert r["collectives"]["all_reduce"] > 0 and r["collectives"]["ring_shift"] > 0
