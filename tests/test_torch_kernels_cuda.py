"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip elsewhere (the kernels have no CPU
mode). The file imports neither JAX nor merv_tpu, so it runs on a machine
without them:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -m cuda

Each output is held by ``chip_smoke.hold``, element by element and on the
mean, under the limit stated there.
"""

import numpy as np
import pytest
import torch

import merv_tpu_torch.ops.attention as A
from chip_smoke import hold


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bf16(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)


def _assert_close(out, ref, mag):
    h = hold(out, ref, mag)
    assert h["ok"], f"outside the limit: {h}"


@pytest.mark.cuda
@pytest.mark.parametrize("T", [40, 257, 261, 512])
def test_small_attention_kt_matches_plain(cuda, T):
    rng = np.random.default_rng(T)
    q, k, v = (_bf16(rng, (2, 4, T, 64), cuda) for _ in range(3))
    kt = k.transpose(-1, -2).contiguous()
    out = A.small_attention_kt(q, kt, v, 0.125)
    _assert_close(out, A.small_attention_kt_plain(q, kt, v, 0.125), A.small_attention_kt_plain(q, kt, v.abs(), 0.125))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "H,Hk,Tq,Tk,D,causal,q_offset",
    [(4, 4, 130, 130, 64, False, None), (4, 2, 100, 170, 128, True, 30), (4, 1, 77, 77, 128, True, None),
     (2, 2, 40, 300, 64, True, None)],
)
def test_flash_forward_matches_plain(cuda, H, Hk, Tq, Tk, D, causal, q_offset):
    rng = np.random.default_rng(Tq + Tk)
    q = _bf16(rng, (2, H, Tq, D), cuda)
    k, v = (_bf16(rng, (2, Hk, Tk, D), cuda) for _ in range(2))
    mask = torch.ones((2, Tk), dtype=torch.bool, device=cuda)
    mask[1, Tk // 2:] = False
    kw = dict(causal=causal, kv_mask=mask, q_offset=q_offset)
    out = A.flash_attention_forward(q, k, v, **kw)
    _assert_close(out, A.flash_attention_forward_plain(q, k, v, **kw), A.flash_attention_forward_plain(q, k, v.abs(), **kw))


@pytest.mark.cuda
def test_flash_forward_fully_masked_row_is_zero(cuda):
    rng = np.random.default_rng(0)
    q, k, v = (_bf16(rng, (2, 2, 64, 64), cuda) for _ in range(3))
    mask = torch.ones((2, 64), dtype=torch.bool, device=cuda)
    mask[1] = False
    out = A.flash_attention_forward(q, k, v, causal=False, kv_mask=mask)
    assert out[1].abs().max().item() == 0.0


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 1, 64, 32), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        A.flash_attention_forward(q, q, q, causal=False)  # head dim 32
    with pytest.raises(ValueError):
        A.small_attention_kt(q.float(), q.float().transpose(-1, -2), q.float(), 1.0)  # fp32
