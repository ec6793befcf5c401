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
@pytest.mark.parametrize("T", [40, 261])
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
    assert TA.launch_counts() == {"small_attention_kt": 0, "flash_attention_forward": 0}
