"""The port's attention (merv_tpu_torch.ops.attention) against merv_tpu's.

The Pallas kernels run in interpret mode on the CPU (as tests/test_attention.py
runs them); the port's wrappers take their plain versions for CPU tensors.
Inputs come from numpy seeds and go through both packages.

Tolerances: fp32 <= 1e-5 (same math, different summation order). bf16 <= 1e-2
absolute: both sides compute fp32 scores and round p and the output to bf16,
so they may differ by one bf16 ulp of the output (<= 2**-7 at |o| < 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import merv_tpu.ops.attention as A
import merv_tpu_torch.ops.attention as TA

FP32_TOL = 1e-5
BF16_TOL = 1e-2


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(A, "_INTERPRET", True)


def _qkv(seed, B, H, Hk, Tq, Tk, D):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, Tq, D).astype(np.float32)
    k = rng.randn(B, Hk, Tk, D).astype(np.float32)
    v = rng.randn(B, Hk, Tk, D).astype(np.float32)
    return q, k, v


def _to_jax(x, dtype):
    return jnp.asarray(x, jnp.float32 if dtype == "float32" else jnp.bfloat16)


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(torch.float32 if dtype == "float32" else torch.bfloat16)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [40, 65, 257, 261, 289])  # just past 64, 256 and 288 keys, as on the card
def test_small_attention_kt_plain_matches_pallas(T, dtype):
    q, k, v = _qkv(0, 1, 2, 2, T, T, 64)
    kt = np.ascontiguousarray(k.transpose(0, 1, 3, 2))
    scale = 64 ** -0.5
    ref = A.small_attention_kt(_to_jax(q, dtype), _to_jax(kt, dtype), _to_jax(v, dtype), scale)
    out = TA.small_attention_kt(_to_torch(q, dtype), _to_torch(kt, dtype), _to_torch(v, dtype), scale)
    assert out.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=0)


# (name, B, H, Hk, Tq, Tk, D, causal, q_offset, mask kind)
FLASH_CASES = [
    ("noncausal", 1, 2, 2, 130, 130, 64, False, None, None),
    ("causal_tq_lt_tk", 1, 2, 2, 40, 100, 128, True, None, None),
    ("causal_q_offset_kv_mask", 2, 2, 2, 40, 100, 128, True, 30, "right_pad"),
    ("gqa_kv_mask", 2, 4, 2, 64, 96, 64, False, None, "random"),
    ("fully_masked_row", 2, 2, 1, 24, 48, 64, False, None, "row1_empty"),
]


def _mask(kind, B, Tk):
    if kind is None:
        return None
    if kind == "right_pad":
        m = np.ones((B, Tk), bool)
        m[1, 60:] = False
        return m
    if kind == "random":
        m = np.random.RandomState(1).rand(B, Tk) > 0.3
        m[:, 0] = True
        return m
    m = np.ones((B, Tk), bool)
    m[1] = False
    return m


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_forward_plain_matches_pallas(case, dtype):
    name, B, H, Hk, Tq, Tk, D, causal, q_offset, mask_kind = case
    q, k, v = _qkv(2, B, H, Hk, Tq, Tk, D)
    mask = _mask(mask_kind, B, Tk)
    scale = D ** -0.5
    ref = A._flash_forward(
        _to_jax(q, dtype), _to_jax(k, dtype), _to_jax(v, dtype),
        None if mask is None else jnp.asarray(mask), causal, scale, 128, 128, q_offset,
    )
    out = TA.flash_attention_forward(
        _to_torch(q, dtype), _to_torch(k, dtype), _to_torch(v, dtype), causal=causal,
        kv_mask=None if mask is None else torch.from_numpy(mask), scale=scale, q_offset=q_offset,
    )
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=0)
    if mask_kind == "row1_empty":
        assert not out[1].float().abs().any(), "a row with no valid key must be exactly 0"


@pytest.mark.parametrize(
    "causal,q_offset,mask_kind,Hk", [(False, None, None, 4), (True, None, "right_pad", 2), (True, 30, "row1_empty", 4)]
)
def test_attention_reference_matches_jax(causal, q_offset, mask_kind, Hk):
    B, H, Tq, Tk, D = 2, 4, 40, 100, 32
    q, k, v = _qkv(3, B, H, Hk, Tq, Tk, D)
    mask = _mask(mask_kind, B, Tk)
    bias = np.random.RandomState(4).randn(1, 1, Tq, Tk).astype(np.float32)
    ref = A.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_mask=None if mask is None else jnp.asarray(mask), bias=jnp.asarray(bias), q_offset=q_offset,
    )
    out = TA.attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
        kv_mask=None if mask is None else torch.from_numpy(mask), bias=torch.from_numpy(bias), q_offset=q_offset,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_TOL, rtol=0)


def test_dispatch_routes_main_path_shapes():
    plan = TA.dispatch_plan
    assert plan(261, 261, 64, causal=False, has_bias=False, self_shaped=True) == "small"  # DINOv2 frames
    assert plan(257, 257, 64, causal=False, has_bias=False, self_shaped=True) == "small"  # LanguageBind spatial
    assert plan(196, 196, 64, causal=False, has_bias=False, self_shaped=True) == "plain"  # SigLIP frames
    assert plan(3137, 3137, 64, causal=False, has_bias=False, self_shaped=True) == "flash"  # ViViT
    assert plan(1088, 1120, 128, causal=True, has_bias=False, has_mask=True) == "flash"  # LLM cache prefill
    assert plan(1, 1120, 128, causal=True, has_bias=False, has_mask=True) == "plain"  # T=1 decode
    assert plan(128, 128, 64, causal=False, has_bias=True) == "plain"  # temporal bias path


def test_cpu_tensors_take_plain_versions_without_counting():
    TA.reset_launch_counts()
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, 2, 2, 261, 261, 64))
    kt = k.transpose(-1, -2).contiguous()
    out = TA.small_attention_kt(q, kt, v, 0.125)
    ref = TA.attention_reference(q, k, v, scale=0.125)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=FP32_TOL, rtol=0)
    out = TA.attention(q, k, v, causal=True)  # planned 'flash'
    ref = TA.attention_reference(q, k, v, causal=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=FP32_TOL, rtol=0)
    # K4, K5 and K6 (ops/int8_linear.py, ops/decode_attention.py, ops/layer_norm.py) count in the same table
    import merv_tpu_torch.ops.decode_attention as K5
    import merv_tpu_torch.ops.int8_linear as K4
    import merv_tpu_torch.ops.layer_norm as K6

    w = torch.randint(-127, 128, (8, 64), dtype=torch.int8)
    assert torch.equal(K4.int8_linear(q[0, 0, :3], w, torch.ones(8)), K4.int8_linear_plain(q[0, 0, :3], w, torch.ones(8)))
    out = K5.decode_attention(q[:, :, :1], k, v, kv_mask=torch.ones((1, 261), dtype=torch.bool))
    np.testing.assert_allclose(out.numpy(), TA.attention_reference(q[:, :, :1], k, v).numpy(), atol=FP32_TOL, rtol=0)
    x, ones = q.flatten()[: 32 * 768].reshape(32, 768).to(torch.bfloat16), torch.ones(768)
    assert torch.equal(K6.layer_norm(x, ones, ones, 1e-6), K6.layer_norm_plain(x, ones, ones, 1e-6))
    assert TA.launch_counts() == {"small_attention_kt": 0, "flash_attention_forward": 0, "flash_attention_backward": 0,
                                  "small_attention": 0, "packed_temporal_attention": 0, "fused_vit_attn_block": 0,
                                  "fused_vit_attn_block_d72": 0, "int8_linear": 0, "decode_attention": 0,
                                  "decode_attention_lse": 0, "layer_norm": 0}


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------

BWD_FP32_TOL = 1e-5
# bf16: P and dS (port) or dP (merv_tpu's reference VJP) are rounded to bf16 before their products, and each
# gradient once more: <= 2e-2 absolute plus 2e-2 relative (one bf16 ulp is 0.03 at |g| in [4, 8), which the
# early keys' dK and dV reach when ~100 causal queries sum onto them)
BWD_BF16_TOL = 2e-2

# (name, B, H, Hk, T, D, causal, mask kind): Tq == Tk as in training
BWD_CASES = [
    ("causal_ragged_T200", 1, 2, 2, 200, 64, True, None),
    ("causal_gqa_4_to_2", 1, 4, 2, 96, 128, True, None),
    ("kv_mask_d64", 2, 2, 2, 80, 64, False, "random"),
    ("causal_kv_mask_d128", 2, 4, 2, 72, 128, True, "right_pad_short"),
    # batch row 1 has no valid key: merv_tpu's reference VJP averages V there
    ("row1_empty", 2, 4, 2, 48, 64, False, "row1_empty"),
]


def _bwd_mask(kind, B, T):
    if kind == "right_pad_short":
        m = np.ones((B, T), bool)
        m[1, T - 20:] = False
        return m
    return _mask(kind, B, T)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_flash_backward_plain_matches_jax_grad(case, dtype):
    """The gradient of flash_attention on the CPU (FlashAttention: the plain
    forward's o and lse into flash_attention_backward's plain version, plus
    the rows with no valid key) against jax.vjp of merv_tpu's _flash_attention
    custom VJP in interpret mode."""
    import jax

    name, B, H, Hk, T, D, causal, mask_kind = case
    q, k, v = _qkv(6, B, H, Hk, T, T, D)
    do = np.random.RandomState(7).randn(B, H, T, D).astype(np.float32)
    mask = _bwd_mask(mask_kind, B, T)
    scale = D ** -0.5
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda q, k, v: A._flash_attention(q, k, v, causal, scale, 128, 128, mask is not None, jmask),
                     _to_jax(q, dtype), _to_jax(k, dtype), _to_jax(v, dtype))
    refs = vjp(_to_jax(do, dtype))
    tq, tk, tv = (_to_torch(x, dtype) for x in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = TA.flash_attention(*leaves, causal=causal, kv_mask=tmask, scale=scale)
    grads = torch.autograd.grad(out, leaves, _to_torch(do, dtype))
    tol = dict(atol=BWD_FP32_TOL, rtol=0) if dtype == "float32" else dict(atol=BWD_BF16_TOL, rtol=BWD_BF16_TOL)
    for gname, out, ref, x in zip(("dq", "dk", "dv"), grads, refs, (tq, tk, tv)):
        assert out.shape == x.shape and out.dtype == x.dtype
        np.testing.assert_allclose(_np(out), _np(ref), **tol, err_msg=gname)


@pytest.mark.parametrize("Hk,mask_kind", [(2, None), (1, "row1_empty")])
def test_flash_autograd_function_matches_plain_autograd(Hk, mask_kind):
    """attention() (the 'flash' plan) and flash_attention() on the CPU, through FlashAttention, against
    torch.autograd of the plain forward, fp32. On a row with no valid key dq and
    dk are 0 and every key's dv is round(1/Tk) * dO summed over the row's
    queries and GQA group (merv_tpu's reference VJP averages V there), where
    autograd of the plain forward (which writes 0 there) gives 0."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(8, 2, 4, Hk, 48, 48, 64))
    mask = _mask(mask_kind, 2, 48)
    tmask = None if mask is None else torch.from_numpy(mask)
    g = torch.from_numpy(np.random.RandomState(9).randn(2, 4, 48, 64).astype(np.float32))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fn = TA.attention if mask is None else TA.flash_attention  # attention() plans a short masked call 'plain'
    out = fn(*leaves, causal=mask is None, kv_mask=tmask)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(g)
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    TA.flash_attention_forward_plain(*ref_leaves, causal=mask is None, kv_mask=tmask).backward(g)
    for a, b in zip(leaves, ref_leaves):
        np.testing.assert_allclose(a.grad[0].numpy(), b.grad[0].numpy(), atol=FP32_TOL, rtol=0)
    if mask_kind == "row1_empty":
        assert not leaves[0].grad[1].any() and not leaves[1].grad[1].any()
        expect = g[1].sum(dim=1).view(Hk, 4 // Hk, 64).sum(1)[:, None, :] / 48  # [Hk, 1, D], each key the same
        np.testing.assert_allclose(leaves[2].grad[1].numpy(), expect.expand(Hk, 48, 64).numpy(), atol=FP32_TOL,
                                   rtol=0)
    else:
        np.testing.assert_allclose(leaves[2].grad[1].numpy(), ref_leaves[2].grad[1].numpy(), atol=FP32_TOL, rtol=0)
        for a, b in zip(leaves[:2], ref_leaves[:2]):
            np.testing.assert_allclose(a.grad[1].numpy(), b.grad[1].numpy(), atol=FP32_TOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_small_attention_kt_grad_matches_jax(dtype):
    """SmallAttentionKt (its backward recomputes through attention_reference)
    against jax.vjp of merv_tpu's small_attention_kt in interpret mode."""
    import jax

    q, k, v = _qkv(10, 1, 2, 2, 40, 40, 64)
    kt = np.ascontiguousarray(k.transpose(0, 1, 3, 2))
    g = np.random.RandomState(11).randn(*q.shape).astype(np.float32)
    scale = 64 ** -0.5
    _, vjp = jax.vjp(lambda q, kt, v: A.small_attention_kt(q, kt, v, scale), *(_to_jax(x, dtype) for x in (q, kt, v)))
    refs = vjp(_to_jax(g, dtype))
    leaves = [_to_torch(x, dtype).requires_grad_() for x in (q, kt, v)]
    TA.SmallAttentionKt.apply(*leaves, scale, "auto").backward(_to_torch(g, dtype))
    tol = dict(atol=FP32_TOL, rtol=0) if dtype == "float32" else dict(atol=BWD_BF16_TOL, rtol=BWD_BF16_TOL)
    for leaf, ref in zip(leaves, refs):
        np.testing.assert_allclose(_np(leaf.grad), _np(ref), **tol)


def test_q_offset_refuses_a_gradient():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(12, 1, 2, 2, 8, 40, 64))
    with pytest.raises(ValueError, match="inference-only"):
        TA.attention(q, k, v, causal=True, q_offset=30)
    with torch.no_grad():  # the KV-cache path itself still runs
        out = TA.attention(q, k, v, causal=True, q_offset=30)
    assert out.shape == q.shape


def _kernel_stand_ins(monkeypatch):
    """Make the wrappers behave as they do for CUDA tensors: a kernel fills a
    fresh tensor, so its output carries no autograd history."""
    small, fwd, bwd = TA.small_attention_kt, TA.flash_attention_forward, TA.flash_attention_backward
    monkeypatch.setattr(TA, "small_attention_kt", lambda *a: small(*a).detach())

    def flash_detached(*a, **kw):
        out = fwd(*a, **kw)
        return tuple(x.detach() for x in out) if isinstance(out, tuple) else out.detach()

    monkeypatch.setattr(TA, "flash_attention_forward", flash_detached)
    monkeypatch.setattr(TA, "flash_attention_backward", lambda *a, **kw: tuple(x.detach() for x in bwd(*a, **kw)))


@pytest.mark.parametrize("module", ["tower_small_kt", "decoder_flash"])
def test_gradient_through_kernel_wrappers_matches_plain(module, monkeypatch):
    """With the wrappers' outputs detached, as a kernel's are, the gradient
    with respect to a tower's video (K1 frames, 230 tokens) and a decoder's
    input embeddings (K2, causal) still equals the all-plain path's: each
    kernel sits inside its autograd Function."""
    from test_torch_merv import _port_tower

    from merv_tpu_torch.device import make_generator
    from merv_tpu_torch.models.backbones.llm.transformer import LlamaDecoder, tiny_decoder_config
    from merv_tpu_torch.nn.core import init_weights

    _kernel_stand_ins(monkeypatch)
    rng = np.random.RandomState(13)
    if module == "tower_small_kt":
        net = _port_tower("dinov2_kt")
        x = torch.from_numpy(rng.randn(1, 2, 3, 120, 120).astype(np.float32))
        run = lambda inp, impl: net(inp, impl=impl)  # noqa: E731
    else:
        net = LlamaDecoder(tiny_decoder_config(compute_dtype=torch.float32), device="cpu")
        x = torch.from_numpy(rng.randn(2, 24, 64).astype(np.float32))
        run = lambda inp, impl: net(inputs_embeds=inp, attn_impl=impl)[0]  # noqa: E731
    init_weights(net, make_generator(torch.device("cpu"), 13))
    grads = []
    for impl in ("auto", "plain"):
        inp = x.clone().requires_grad_()
        out = run(inp, impl)
        out.backward(torch.from_numpy(np.random.RandomState(14).randn(*out.shape).astype(np.float32)))
        grads.append(inp.grad)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_lse_is_the_masked_logsumexp(causal):
    """The plain forward's lse (the reference the card holds K2's against) is
    logsumexp of the visible scaled scores, within 1e-5 in fp32, and +inf on
    exactly the rows with no valid key."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 2, 4, 2, 37, 45, 64))
    mask = torch.ones((2, 45), dtype=torch.bool)
    mask[0, 30:] = False
    mask[1] = False
    _, lse = TA.flash_attention_forward_plain(q, k, v, causal=causal, kv_mask=mask, return_lse=True)
    s = torch.matmul(q, k.repeat_interleave(2, 1).transpose(-1, -2)) * 64 ** -0.5
    s = s.masked_fill(~TA._visible(2, 37, 45, causal, mask, 45 - 37, q.device), float("-inf"))
    torch.testing.assert_close(lse[0], torch.logsumexp(s[0], -1), rtol=0, atol=FP32_TOL)
    assert bool(torch.isposinf(lse[1]).all())


def test_lse_hold_catches_an_offset_and_other_empty_rows():
    """chip_smoke.hold_lse, the card's check of K2's lse: it passes the plain
    lse against itself and fails an offset of 0.05, a finite value on a row
    with no valid key, and a NaN."""
    from chip_smoke import LSE_PLANTED_OFFSET, hold_lse

    q, k, v = (torch.from_numpy(x) for x in _qkv(6, 2, 2, 2, 40, 40, 64))
    mask = torch.ones((2, 40), dtype=torch.bool)
    mask[1] = False
    _, lse = TA.flash_attention_forward_plain(q, k, v, causal=True, kv_mask=mask, return_lse=True)
    h = hold_lse(lse, lse)
    assert h["ok"] and h["empty_rows"] == 2 * 40
    assert not hold_lse(lse + LSE_PLANTED_OFFSET, lse)["ok"]
    finite_empty, nan = lse.clone(), lse.clone()
    finite_empty[1, 0, 3] = 0.0
    nan[0, 1, 7] = float("nan")
    assert not hold_lse(finite_empty, lse)["ok"] and not hold_lse(nan, lse)["ok"]


def test_compile_report_reads_ptxas_output(monkeypatch, tmp_path):
    """chip_smoke.compile_report, the card's record of what was compiled for K2,
    K3, K1 and B3: registers, spills and shared memory per kernel from ``ptxas
    -v``'s report (kernels named with their int or bool template argument),
    and ptxas's warnings; without ``cuobjdump`` the SASS counts read as not
    measured (None) instead of failing the run."""
    import chip_smoke
    from merv_tpu_torch.ops import _build

    log = (
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__f68bbc09_12_flash_fwd_cu_751008f416flash_fwd_kernel"
        "ILi128EEEv14CUtensorMap_stS1_S1_PKhP13__nv_bfloat16Pfiiiiiif' for 'sm_90a'\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 64 bytes smem\n"
        "ptxas warning : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized\n"
    )
    monkeypatch.setattr(_build, "build_log", lambda name: log)
    monkeypatch.setattr(chip_smoke.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))  # no cuobjdump there either
    report = chip_smoke.compile_report()
    assert set(report) == set(chip_smoke.COMPILED_LIBS)
    fwd = report["flash_fwd"]
    assert fwd["kernels"] == {"flash_fwd_kernel<128>": dict(spill_stores=8, spill_loads=4, registers=168,
                                                             static_smem_bytes=64)}
    assert fwd["sass"] is None
    assert fwd["ptxas_warnings"] == [log.splitlines()[-1].strip()]
    small_log = (
        "ptxas info    : Compiling entry function '_ZN10small_attn17small_attn_kernelILb1EEEv14CUtensorMap_stS1_S1_"
        "PK13__nv_bfloat16PS2_iiiif' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n"
    )
    monkeypatch.setattr(_build, "build_log", lambda name: small_log)
    kt = chip_smoke.compile_report()["small_attention_kt"]
    assert kt["kernels"] == {"small_attn_kernel<true>": dict(spill_stores=0, spill_loads=0, registers=168,
                                                              static_smem_bytes=0)}
    assert kt["ptxas_warnings"] == []
