"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip elsewhere (the kernels have no CPU
mode). The file imports neither JAX nor merv_tpu, so it runs on a machine
without them:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -m cuda

Each output is held by ``chip_smoke.hold``, element by element and on the
mean, under the limit stated there; the flash forward's log-sum-exp by
``chip_smoke.hold_lse``, row by row; the fused ViT block's with the
magnitudes of ``chip_smoke.fused_block_mags`` and stage by stage by
``chip_smoke.hold_fused``; K6 (``layer_norm``) also within one bf16 ulp of
its plain version, element by element, at the magnitude of the terms rounded
(``chip_smoke.bf16_ulps``).
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import merv_tpu_torch.ops.attention as A
import merv_tpu_torch.ops.fused_vit_block as TF
from merv_tpu_torch.ops import _build
from chip_smoke import (
    LSE_PLANTED_OFFSET,
    SP_K5_CASES,
    backward_mags,
    bf16_ulps,
    fused_args,
    fused_block_mags,
    fused_layer,
    hold,
    hold_from_plain_forward,
    hold_fused,
    hold_lse,
    k5_lse_hold,
    layer_norm_terms,
    patched,
    planted_tower_faults,
    sp_k5_inputs,
)


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


# the whole-sequence kernels' edges: 64-row query tiles and 64-key score blocks (63/64/65, 128/129),
# 256 keys (wgmma's largest N), the towers' 257 and 261, the one-pass bound of 272 keys of scores in
# registers (272/273: two key chunks above it), 288/289, 320/321 (one shared-memory stage for kt above
# it) and 512
SMALL_EDGE_T = [1, 16, 40, 63, 64, 65, 128, 129, 256, 257, 261, 272, 273, 288, 289, 320, 321, 511, 512]


@pytest.mark.cuda
@pytest.mark.parametrize("T", SMALL_EDGE_T)
def test_small_attention_kt_matches_plain(cuda, T):
    rng = np.random.default_rng(T)
    q, k, v = (_bf16(rng, (2, 4, T, 64), cuda) for _ in range(3))
    kt = k.transpose(-1, -2).contiguous()
    out = A.small_attention_kt(q, kt, v, 0.125)
    _assert_close(out, A.small_attention_kt_plain(q, kt, v, 0.125), A.small_attention_kt_plain(q, kt, v.abs(), 0.125))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["small_attention_kt", "small_attention"])
@pytest.mark.parametrize("B,H,T", [(24, 16, 261), (18, 16, 512), (300, 1, 65)])
def test_small_kernels_persistent_grid_wraps(cuda, kernel, B, H, T):
    """More heads than the card has SMs: each block walks several heads through its
    ring of stages (two stages at T=261, one at T=512, and 300 one-tile heads)."""
    rng = np.random.default_rng(B * T)
    q, k, v = (_bf16(rng, (B, H, T, 64), cuda) for _ in range(3))
    assert B * H > torch.cuda.get_device_properties(cuda).multi_processor_count
    if kernel == "small_attention_kt":
        kt = k.transpose(-1, -2).contiguous()
        out, ref = A.small_attention_kt(q, kt, v, 0.125), A.small_attention_kt_plain(q, kt, v, 0.125)
        mag = A.small_attention_kt_plain(q, kt, v.abs(), 0.125)
    else:
        out, ref = A.small_attention(q, k, v, 0.125), A.small_attention_plain(q, k, v, 0.125)
        mag = A.small_attention_plain(q, k, v.abs(), 0.125)
    _assert_close(out, ref, mag)


@pytest.mark.cuda
def test_small_kernels_are_deterministic(cuda):
    """No atomics, and a fixed schedule: two calls on the same inputs give the same bits."""
    rng = np.random.default_rng(5)
    q, k, v = (_bf16(rng, (20, 16, 261, 64), cuda) for _ in range(3))
    kt = k.transpose(-1, -2).contiguous()
    assert torch.equal(A.small_attention_kt(q, kt, v, 0.125), A.small_attention_kt(q, kt, v, 0.125))
    k, v = k[:, :4].contiguous(), v[:, :4].contiguous()  # GQA 16 -> 4
    assert torch.equal(A.small_attention(q, k, v, 0.125), A.small_attention(q, k, v, 0.125))


@pytest.mark.cuda
def test_small_kernels_raise_on_a_misaligned_pointer(cuda):
    """The kernels' TMA and bulk copies need 16-byte aligned bases: a contiguous
    view 2 bytes into its storage is refused, for each of q, k (kt) and v."""
    n = 2 * 4 * 100 * 64
    flat = torch.zeros(n + 1, dtype=torch.bfloat16, device=cuda)
    bad = flat[1:].view(2, 4, 100, 64)
    good = torch.zeros((2, 4, 100, 64), dtype=torch.bfloat16, device=cuda)
    good_kt = good.transpose(-1, -2).contiguous()
    bad_kt = flat[1:].view(2, 4, 64, 100)
    for args in ((bad, good_kt, good), (good, bad_kt, good), (good, good_kt, bad)):
        with pytest.raises(ValueError, match="aligned"):
            A.small_attention_kt(*args, 0.125)
    for args in ((bad, good, good), (good, bad, good), (good, good, bad)):
        with pytest.raises(ValueError, match="aligned"):
            A.small_attention(*args, 0.125)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "H,Hk,Tq,Tk,D,causal,q_offset",
    [(4, 4, 130, 130, 64, False, None), (4, 2, 100, 170, 128, True, 30), (4, 1, 77, 77, 128, True, None),
     (2, 2, 40, 300, 64, True, None),
     # tile edges (128 query rows per block, 128 keys per tile) and a causal q_offset call off the tile grid
     (4, 4, 127, 127, 64, True, None), (4, 2, 128, 128, 128, False, None), (2, 2, 129, 129, 128, True, None),
     (4, 4, 255, 255, 64, False, None), (4, 2, 200, 330, 128, True, 100)],
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
    out_lse, lse = A.flash_attention_forward(q, k, v, return_lse=True, **kw)
    _, lse_ref = A.flash_attention_forward_plain(q, k, v, return_lse=True, **kw)
    assert torch.equal(out_lse, out)
    h = hold_lse(lse, lse_ref)
    assert h["ok"], f"lse outside the limit: {h}"
    assert not hold_lse(lse + LSE_PLANTED_OFFSET, lse_ref)["ok"]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,H,Hk,Tq,Tk,q_offset,valid",
    # the LLM families' prefills (1,088 tokens into a 1,120-row cache: Qwen-2.5-7B 28 -> 4, Qwen-2.5-3B 16 -> 2,
    # Llama-2-13B 40 heads) and Qwen-2.5-7B's suffix prefill (8 suffixes of 64 tokens at q_offset 1,024, no BOS)
    [(1, 28, 4, 1088, 1120, 0, 1088), (1, 16, 2, 1088, 1120, 0, 1088), (1, 40, 40, 1088, 1120, 0, 1088),
     (8, 28, 4, 64, 1152, 1024, None)],
)
def test_flash_forward_at_the_families_gqa_groups(cuda, B, H, Hk, Tq, Tk, q_offset, valid):
    """K2 maps query head h to kv head h / (H / Hk): at groups 7 and 8 against the plain version."""
    rng = np.random.default_rng(H * Hk + Tq)
    q = _bf16(rng, (B, H, Tq, 128), cuda)
    k, v = (_bf16(rng, (B, Hk, Tk, 128), cuda) for _ in range(2))
    mask = torch.zeros((B, Tk), dtype=torch.bool, device=cuda)
    if valid is not None:
        mask[:, :valid] = True
    else:
        mask[:, :q_offset] = True
        for b in range(B):
            mask[b, q_offset: q_offset + 64 - 7 * b] = True
    kw = dict(causal=True, kv_mask=mask, q_offset=q_offset)
    out = A.flash_attention_forward(q, k, v, **kw)
    _assert_close(out, A.flash_attention_forward_plain(q, k, v, **kw), A.flash_attention_forward_plain(q, k, v.abs(), **kw))


@pytest.mark.cuda
def test_flash_forward_fully_masked_row_is_zero(cuda):
    rng = np.random.default_rng(0)
    q, k, v = (_bf16(rng, (2, 2, 64, 64), cuda) for _ in range(3))
    mask = torch.ones((2, 64), dtype=torch.bool, device=cuda)
    mask[1] = False
    out, lse = A.flash_attention_forward(q, k, v, causal=False, kv_mask=mask, return_lse=True)
    assert out[1].abs().max().item() == 0.0
    assert bool(torch.isposinf(lse[1]).all()) and bool(torch.isfinite(lse[0]).all())


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 1, 64, 32), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        A.flash_attention_forward(q, q, q, causal=False)  # head dim 32
    with pytest.raises(ValueError):
        A.small_attention_kt(q.float(), q.float().transpose(-1, -2), q.float(), 1.0)  # fp32


def _assert_backward_close(q, k, v, mask, causal):
    """Forward kernel -> (o, lse); the backward kernel against the plain
    backward on those same inputs, each gradient under ``hold``'s limit with
    the magnitudes of ``chip_smoke.backward_mags``; the lse against the plain
    forward's, and the gradients against the plain backward on the plain
    forward's o and lse (``chip_smoke.hold_from_plain_forward``)."""
    rng = np.random.default_rng(q.shape[2] * 7 + k.shape[2])
    o, lse = A.flash_attention_forward(q, k, v, causal=causal, kv_mask=mask, return_lse=True)
    do = _bf16(rng, tuple(q.shape), q.device)
    kw = dict(causal=causal, kv_mask=mask)
    grads = A.flash_attention_backward(q, k, v, o, lse, do, **kw)
    refs = A.flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
    mags = backward_mags(q, k, v, lse, do, **kw)
    for name, out, ref, mag in zip(("dq", "dk", "dv"), grads, refs, mags):
        h = hold(out, ref, mag)
        assert h["ok"], f"{name} outside the limit: {h}"
    fp = hold_from_plain_forward(q, k, v, lse, do, grads, **kw)
    assert fp["lse"]["ok"], f"lse outside the limit: {fp['lse']}"
    assert fp["backward"]["ok"], f"against the plain forward's o and lse: {fp['backward']['per_grad']}"
    return grads


@pytest.mark.cuda
@pytest.mark.parametrize(
    "H,Hk,Tq,Tk,D,causal,masked",
    [(4, 4, 200, 200, 64, True, False), (4, 2, 130, 130, 128, True, False), (4, 1, 77, 150, 128, False, True),
     (2, 2, 40, 100, 64, True, True), (4, 4, 64, 64, 128, False, False),
     # tile edges (64-row streamed tiles, 128-row blocks) and a GQA 32 -> 8 call across several key tiles
     (4, 4, 127, 127, 128, True, False), (4, 2, 128, 128, 64, True, True), (2, 2, 129, 129, 128, False, False),
     (4, 4, 255, 255, 128, True, False), (32, 8, 1088, 1088, 128, True, False)],
)
def test_flash_backward_matches_plain(cuda, H, Hk, Tq, Tk, D, causal, masked):
    rng = np.random.default_rng(H * Tq + Tk)
    q = _bf16(rng, (2, H, Tq, D), cuda)
    k, v = (_bf16(rng, (2, Hk, Tk, D), cuda) for _ in range(2))
    mask = None
    if masked:
        mask = torch.ones((2, Tk), dtype=torch.bool, device=cuda)
        mask[1, Tk // 3:] = False
    _assert_backward_close(q, k, v, mask, causal)


@pytest.mark.cuda
def test_flash_backward_is_deterministic(cuda):
    """No atomics: two calls on the same inputs give bit-identical dq, dk, dv."""
    rng = np.random.default_rng(3)
    q = _bf16(rng, (2, 8, 300, 128), cuda)
    k, v = (_bf16(rng, (2, 2, 300, 128), cuda) for _ in range(2))
    mask = torch.ones((2, 300), dtype=torch.bool, device=cuda)
    mask[1, 250:] = False
    o, lse = A.flash_attention_forward(q, k, v, causal=True, kv_mask=mask, return_lse=True)
    do = _bf16(rng, tuple(q.shape), cuda)
    first = A.flash_attention_backward(q, k, v, o, lse, do, causal=True, kv_mask=mask)
    second = A.flash_attention_backward(q, k, v, o, lse, do, causal=True, kv_mask=mask)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), f"{name} differs between two calls"


@pytest.mark.cuda
def test_flash_backward_fully_masked_row_has_zero_gradient(cuda):
    rng = np.random.default_rng(1)
    q, k, v = (_bf16(rng, (2, 2, 70, 64), cuda) for _ in range(3))
    mask = torch.ones((2, 70), dtype=torch.bool, device=cuda)
    mask[1] = False
    dq, dk, dv = _assert_backward_close(q, k, v, mask, False)
    assert dq[1].abs().max().item() == 0.0 and dk[1].abs().max().item() == 0.0 and dv[1].abs().max().item() == 0.0


@pytest.mark.cuda
def test_flash_autograd_runs_the_backward_kernel(cuda):
    rng = np.random.default_rng(2)
    q, k, v = (_bf16(rng, (1, 2, 96, 64), cuda).requires_grad_() for _ in range(3))
    A.reset_launch_counts()
    out = A.attention(q, k, v, causal=True)
    out.float().square().sum().backward()
    counts = A.launch_counts()
    assert counts["flash_attention_forward"] == 1 and counts["flash_attention_backward"] == 1, counts
    assert all(t.grad is not None and torch.isfinite(t.grad.float()).all() for t in (q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "H,Hk,T",
    [(4, 4, 40), (16, 16, 261), (16, 4, 229), (2, 2, 512)]
    + [(4, 4, T) for T in SMALL_EDGE_T if T not in (40, 512)]
    + [(16, 4, 257), (16, 1, 261), (16, 4, 289), (16, 1, 512)],
)
def test_small_attention_matches_plain(cuda, H, Hk, T):
    rng = np.random.default_rng(T + Hk)
    q = _bf16(rng, (2, H, T, 64), cuda)
    k, v = (_bf16(rng, (2, Hk, T, 64), cuda) for _ in range(2))
    out = A.small_attention(q, k, v, 0.125)
    mag = A.small_attention_plain(q, k, v.abs(), 0.125)
    _assert_close(out, A.small_attention_plain(q, k, v, 0.125), mag)
    if 1 < Hk < H:  # the kv-head index matters: heads tiled instead of grouped is caught (the same at Hk = 1)
        fault = planted_tower_faults()["b3_kv_head_ignored"][2]
        assert not hold(out, fault(q, k, v, 0.125), mag)["ok"]


# K1 and B3 at SigLIP so400m's head dim 72: its 256-token frames at 16 heads, the ragged 229, the one-pass
# bound (272 / 273), one stage of kt (320 / 321) and 512, the tile edges and a persistent grid that wraps
D72_EDGE_T = [1, 40, 64, 65, 229, 256, 257, 272, 273, 320, 321, 512]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["small_attention_kt", "small_attention"])
@pytest.mark.parametrize("B,H,Hk,T", [(2, 4, 4, T) for T in D72_EDGE_T] + [(16, 16, 16, 256), (4, 16, 4, 256),
                                                                           (18, 16, 16, 512)])
def test_small_kernels_at_head_dim_72_match_plain(cuda, kernel, B, H, Hk, T):
    """Head dim 72: both kernels against their plain versions; a plain version
    that ignores head-dim columns 64-71 (what 64-column slabs would give) and,
    for B3 on GQA, one that tiles the kv heads, are caught."""
    if kernel == "small_attention_kt" and Hk != H:
        pytest.skip("K1 has no GQA")
    rng = np.random.default_rng(T + 72 * Hk)
    q = _bf16(rng, (B, H, T, 72), cuda)
    k, v = (_bf16(rng, (B, Hk, T, 72), cuda) for _ in range(2))
    faults = planted_tower_faults()
    if kernel == "small_attention_kt":
        kt = k.transpose(-1, -2).contiguous()
        out, args, plain = A.small_attention_kt(q, kt, v, 72 ** -0.5), (q, kt, v), A.small_attention_kt_plain
        tail_fault = faults["k1_head_dim_tail_ignored"][2]
    else:
        out, args, plain = A.small_attention(q, k, v, 72 ** -0.5), (q, k, v), A.small_attention_plain
        tail_fault = faults["b3_head_dim_tail_ignored"][2]
    mag = plain(args[0], args[1], args[2].abs(), 72 ** -0.5)
    _assert_close(out, plain(*args, 72 ** -0.5), mag)
    if T > 16:  # a few rows can all fall within the limit
        assert not hold(out, tail_fault(*args, 72 ** -0.5), mag)["ok"]
    if 1 < Hk < H:
        assert not hold(out, faults["b3_kv_head_ignored"][2](q, k, v, 72 ** -0.5), mag)["ok"]


@pytest.mark.cuda
def test_small_kernels_raise_on_other_head_dims(cuda):
    """The C entry points take head dims 64 and 72; the wrappers raise on any other for CUDA tensors."""
    for D in (80, 128, 32):
        q = torch.zeros((1, 2, 256, D), dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="D in"):
            A.small_attention_kt(q, q.transpose(-1, -2).contiguous(), q, 1.0)
        with pytest.raises(ValueError, match="D in"):
            A.small_attention(q, q, q, 1.0)
    for name in ("small_attention_kt", "small_attention"):
        fn, args = A._kernel_lib(name), [0, 0, 0, 0]
        dims = [2, 256, 80] if name == "small_attention_kt" else [1, 2, 2, 256, 80]
        assert getattr(fn, {"small_attention_kt": "small_attention_kt_bf16",
                            "small_attention": "small_attention_bf16"}[name])(*args, *dims, 1.0, 0) != 0


# B5's edges: the towers' 16 heads of 8 frames, rows of 32 and of 12 keys (more than one chunk of 8
# keys a row), R % heads != 0 (rows of 9 and of 8 keys), one head (every row sees all 512), one key a
# row, and more windows than the persistent grid has blocks (2 a SM)
B5_EDGES = [(3, 128, 16), (5, 256, 8), (2, 48, 4), (3, 130, 16), (2, 512, 1), (3, 64, 64), (300, 128, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("Bn,R,heads", B5_EDGES)
def test_packed_temporal_matches_plain(cuda, Bn, R, heads):
    rng = np.random.default_rng(R + heads)
    q, v = (_bf16(rng, (Bn, R, 64), cuda) for _ in range(2))
    kt = _bf16(rng, (Bn, 64, R), cuda)
    out = A.packed_temporal_attention(q, kt, v, 0.125, heads)
    mag = A.packed_temporal_attention_plain(q, kt, v.abs(), 0.125, heads)
    _assert_close(out, A.packed_temporal_attention_plain(q, kt, v, 0.125, heads), mag)
    if heads > 1:  # with one head every row sees every row: there is no mask to drop
        assert not hold(out, planted_tower_faults()["b5_mask_dropped"][2](q, kt, v, 0.125, heads), mag)["ok"]


@pytest.mark.cuda
def test_packed_temporal_is_deterministic_and_refuses_a_misaligned_pointer(cuda):
    """A fixed schedule and no atomics: two calls give the same bits. The bulk
    copies need 16-byte aligned windows: a view 2 bytes into its storage is
    refused, for each of q, kt and v."""
    rng = np.random.default_rng(6)
    q, v = (_bf16(rng, (300, 128, 64), cuda) for _ in range(2))
    kt = _bf16(rng, (300, 64, 128), cuda)
    assert torch.equal(A.packed_temporal_attention(q, kt, v, 0.125, 16), A.packed_temporal_attention(q, kt, v, 0.125, 16))
    flat = torch.zeros(4 * 128 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    bad, bad_kt = flat[1:].view(4, 128, 64), flat[1:].view(4, 64, 128)
    good, good_kt = q[:4].contiguous(), kt[:4].contiguous()
    for args in ((bad, good_kt, good), (good, bad_kt, good), (good, good_kt, bad)):
        with pytest.raises(ValueError, match="aligned"):
            A.packed_temporal_attention(*args, 0.125, 16)


# B6's edges, at D = 768 (SigLIP, ViViT: 12 heads) and 1024 (DINOv2: 16 heads), with B * S mostly not a
# multiple of the GEMM's 128-row tiles: one token; the whole-head stage's 64-row tiles (63/64/65) and
# its one-pass bound of 272 keys (272/273: two key chunks above it); the towers' 196, 257 and 261; 256/257,
# where S starts to pick the whole-head stage; 512, the last length it takes, and 513; ViViT's 3137
B6_EDGES = [("siglip", 3, 1), ("dinov2", 2, 16), ("dinov2", 2, 37), ("siglip", 2, 63), ("dinov2", 2, 64),
            ("siglip", 2, 65), ("siglip", 2, 196), ("siglip", 2, 256), ("dinov2", 2, 257), ("dinov2", 3, 261),
            ("siglip", 1, 272), ("dinov2", 1, 273), ("dinov2", 1, 512), ("siglip", 1, 513), ("vivit", 1, 700),
            ("vivit", 1, 3137)]


def _fused_case(dev, tower, B, S):
    from merv_tpu_torch.models.backbones.video.vit import DINOV2_LARGE_REG4, SIGLIP_BASE_224, VIVIT_BASE_16x2

    cfg = dict(dinov2=DINOV2_LARGE_REG4, siglip=SIGLIP_BASE_224, vivit=VIVIT_BASE_16x2)[tower]
    layer = fused_layer(dev, cfg, S)
    x = _bf16(np.random.default_rng(S), (B, S, cfg.hidden_size), dev)
    return cfg, fused_args(layer, x)


@pytest.mark.cuda
@pytest.mark.parametrize("tower,B,S", B6_EDGES)
def test_fused_vit_block_matches_plain(cuda, tower, B, S):
    cfg, args = _fused_case(cuda, tower, B, S)
    A.reset_launch_counts()
    out = TF.fused_vit_attn_block(*args)
    assert A.launch_counts()["fused_vit_attn_block"] == 1
    _assert_close(out, TF.fused_vit_attn_block_plain(*args), fused_block_mags(*args))
    out, stages = TF.fused_vit_attn_block_stages(*args)
    held = hold_fused(args, out, stages)
    assert held["ok"], f"a stage outside its limit: {held['stages']}"
    faults = planted_tower_faults()
    # with one key a softmax is 1 at any scale: unscaled scores change nothing
    for fault in (("b6_q_bias_dropped",) + (("b6_scores_unscaled",) if S > 1 else ())
                  + (("b6_gamma_ignored",) if cfg.use_layerscale else ())):
        with patched(faults[fault]):
            assert not hold_fused(args, out, stages)["ok"], fault
    if S <= 512:  # both attention stages take the length: each forced, whichever S picks
        for key_tiled in (False, True):
            held = hold_fused(args, *TF.fused_vit_attn_block_stages(*args, key_tiled=key_tiled))
            assert held["ok"], f"key_tiled={key_tiled}: a stage outside its limit: {held['stages']}"


# B6 at SigLIP so400m's head dim 72 (hidden 1152, 16 heads; the key-tiled stage at every S): one token, one
# 128-row query tile and one 128-key tile (128/129), so400m's 256 tokens at its 16 frames, a ragged 229, and
# 257 / 513, the lengths that cross the stage boundaries at head dim 64
B6_D72_EDGES = [(3, 1), (2, 128), (2, 129), (16, 256), (2, 229), (2, 257), (1, 513)]


def _so400m_case(dev, B, S):
    from merv_tpu_torch.models.backbones.video.vit import SIGLIP_SO400M_224

    layer = fused_layer(dev, SIGLIP_SO400M_224, 72 + S)
    x = _bf16(np.random.default_rng(72 + S), (B, S, SIGLIP_SO400M_224.hidden_size), dev)
    return SIGLIP_SO400M_224, fused_args(layer, x)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", B6_D72_EDGES)
def test_fused_vit_block_head_dim_72_matches_plain(cuda, B, S):
    """B6 at head dim 72 held end to end and stage by stage; the launch counts under its own counter; the
    planted faults (the q bias dropped, the scores unscaled, the softmax scale of head dim 64) caught."""
    cfg, args = _so400m_case(cuda, B, S)
    A.reset_launch_counts()
    out = TF.fused_vit_attn_block(*args)
    counts = A.launch_counts()
    assert counts["fused_vit_attn_block_d72"] == 1 and counts["fused_vit_attn_block"] == 0
    _assert_close(out, TF.fused_vit_attn_block_plain(*args), fused_block_mags(*args))
    out, stages = TF.fused_vit_attn_block_stages(*args)
    assert stages["q"].shape == (B, 16, S, 72)
    held = hold_fused(args, out, stages)
    assert held["ok"], f"a stage outside its limit: {held['stages']}"
    assert torch.equal(out, TF.fused_vit_attn_block_stages(*args, key_tiled=True)[0])  # the stage S picks at 72
    faults = planted_tower_faults()
    for fault in ("b6_q_bias_dropped",) + (("b6_scores_unscaled", "b6_scale_of_head_dim_64") if S > 1 else ()):
        with patched(faults[fault]):
            assert not hold_fused(args, out, stages)["ok"], fault


@pytest.mark.cuda
def test_fused_vit_block_head_dim_72_is_deterministic(cuda):
    _, args = _so400m_case(cuda, 2, 257)
    one, stages = TF.fused_vit_attn_block_stages(*args)
    two, again = TF.fused_vit_attn_block_stages(*args)
    assert torch.equal(one, two) and all(torch.equal(stages[k], again[k]) for k in stages)


@pytest.mark.cuda
def test_fused_vit_block_refuses_head_dim_80(cuda):
    """Head dims other than 64 and 72 raise, naming where their port would wait; the C entry refuses them too."""
    x = torch.zeros((1, 16, 1280), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((1280, 1280), dtype=torch.bfloat16, device=cuda)
    vec = torch.zeros(1280, device=cuda)
    with pytest.raises(ValueError, match="ROADMAP"):
        TF.fused_vit_attn_block(x, vec, vec, w, vec, w, vec, w, vec, w, vec, vec, 16, 1e-6)
    lib = _build.bind("fused_vit_block", *TF._SIGNATURE)
    scratch = torch.zeros(1 << 20, dtype=torch.bfloat16, device=cuda)
    ptr = scratch.data_ptr()
    assert lib.fused_vit_attn_block_bf16(*[ptr] * 10, 1, 16, 1280, 16, -1, 1e-6, 80 ** -0.5, 0) != 0


@pytest.mark.cuda
def test_fused_vit_block_whole_head_stage_refused_at_head_dim_72(cuda):
    """The whole-head stage is built for head dim 64: asking for it at 72 raises, naming ROADMAP.md."""
    _, args = _so400m_case(cuda, 1, 257)
    with pytest.raises(ValueError, match="ROADMAP"):
        TF.fused_vit_attn_block_stages(*args, key_tiled=False)


@pytest.mark.cuda
@pytest.mark.parametrize("key_tiled", [False, True])
def test_fused_vit_block_is_deterministic_and_refuses_a_misaligned_pointer(cuda, key_tiled):
    """Two calls on the same inputs give the same bits (each attention stage),
    and the TMA loads' bases must be 16-byte aligned: an x or a weight 2 bytes
    into its storage is refused."""
    _, args = _fused_case(cuda, "dinov2", 3, 261)
    one, stages = TF.fused_vit_attn_block_stages(*args, key_tiled=key_tiled)
    two, again = TF.fused_vit_attn_block_stages(*args, key_tiled=key_tiled)
    assert torch.equal(one, two) and all(torch.equal(stages[k], again[k]) for k in stages)
    x, w = args[0], args[3]
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        TF.fused_vit_attn_block(flat[1:].view(x.shape), *args[1:])
    flat = torch.zeros(w.numel() + 1, dtype=w.dtype, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        TF.fused_vit_attn_block(*args[:3], flat[1:].view(w.shape), *args[4:])


@pytest.mark.cuda
def test_tower_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 2, 64, 32), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        A.small_attention(q, q, q, 1.0)  # head dim 32
    with pytest.raises(ValueError):
        A.packed_temporal_attention(q[0], q[0].transpose(-1, -2).contiguous(), q[0], 1.0, 2)  # head dim 32
    x = torch.zeros((1, 8, 128), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((128, 128), dtype=torch.float32, device=cuda)
    vec = torch.zeros(128, device=cuda)
    with pytest.raises(ValueError):
        TF.fused_vit_attn_block(x, vec, vec, w, vec, w, vec, w, vec, w, vec, vec, 2, 1e-6)  # fp32 weights
    x = torch.zeros((1, 8, 4096), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((4096, 4096), dtype=torch.bfloat16, device=cuda)
    vec = torch.zeros(4096, device=cuda)
    with pytest.raises(ValueError):
        TF.fused_vit_attn_block(x, vec, vec, w, vec, w, vec, w, vec, w, vec, vec, 64, 1e-6)  # D > 2048
    _, args = _fused_case(cuda, "siglip", 1, 513)
    with pytest.raises(ValueError):
        TF.fused_vit_attn_block_stages(*args, key_tiled=False)  # the whole-head stage past 512


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["small_attention_kt", "small_attention", "packed_temporal", "fused_vit_block"])
def test_a_second_copy_of_a_library_sets_itself_up(cuda, name, tmp_path, monkeypatch):
    """Two copies of one library in a process (as when two trees are compared
    in one run) each raise their own kernels' shared-memory limit: the
    per-device setup record has internal linkage, so the copy loaded second
    does not read the first one's record as its own and skip its setup."""
    rng = np.random.default_rng(7)
    q, k, v = (_bf16(rng, (2, 4, 261, 64), cuda) for _ in range(3))
    kt = k.transpose(-1, -2).contiguous()
    qp, vp = (_bf16(rng, (8, 128, 64), cuda) for _ in range(2))
    ktp = _bf16(rng, (8, 64, 128), cuda)
    call = dict(
        small_attention_kt=lambda: A.small_attention_kt(q, kt, v, 0.125),
        small_attention=lambda: A.small_attention(q, k, v, 0.125),
        packed_temporal=lambda: A.packed_temporal_attention(qp, ktp, vp, 0.125, 16),
        fused_vit_block=lambda args=_fused_case(cuda, "dinov2", 2, 261)[1]: TF.fused_vit_attn_block(*args),
    )[name]
    first = call()  # through the package's own library, which sets itself up
    copy = tmp_path / f"lib{name}.so"
    shutil.copyfile(_build.load(name)._name, copy)
    lib = ctypes.CDLL(str(copy))
    lib.merv_cuda_error_string.argtypes = [ctypes.c_int]
    lib.merv_cuda_error_string.restype = ctypes.c_char_p
    monkeypatch.setitem(_build._LIBS, name, lib)
    assert torch.equal(call(), first)


# ---------------------------------------------------------------------------
# sequence parallelism: K5 with its LSE on cache shards, the ring on K2 / K3
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", SP_K5_CASES, ids=[c[0] for c in SP_K5_CASES])
def test_decode_attention_lse_on_cache_shards(cuda, case):
    """Each shard's K5 call with its LSE against the plain version (0 and
    -inf on a row with no valid key in the shard), at phase 4i(a)'s shapes
    (``chip_smoke.SP_K5_CASES``: the decode and the verify, bf16 and int8, 3
    rows over 553-row shards, 4 slots at per-slot offsets, GQA), and the
    shards merged by LSE against unsharded K5 on the same positions."""
    import merv_tpu_torch.ops.decode_attention as K5
    import merv_tpu_torch.ops.ring_attention as R

    x = sp_k5_inputs(case, np.random.default_rng(len(case[0])), cuda)
    q = x["q"]
    for sh, kw in zip(x["shards"], x["kws"]):
        o, lse = K5.decode_attention(q, *sh, return_lse=True, **kw)
        h = k5_lse_hold(q, *sh, kw, o, lse)
        assert h["ok"], f"outside the limits: {h}"
        empty = torch.isneginf(lse)
        assert not bool(empty.any()) or float(o.float()[empty].abs().max()) == 0.0
    merged = R.cache_shard_attention(q, x["shards"], x["masks"], R.VirtualRanks(x["n"]), x["rows"],
                                     causal=x["causal"], q_offset=x["off"])
    whole = [t for t in x["whole"] if t is not None]
    ref = K5.decode_attention(q, *whole, **x["kw_whole"])
    kd, vd = whole[:2] if len(whole) == 2 else (K5.dequantize_kv(whole[0], whole[2], q.dtype),
                                                K5.dequantize_kv(whole[1], whole[3], q.dtype))
    _assert_close(merged, ref, K5.decode_attention_plain(q, kd, vd.abs(), **x["kw_whole"]))


@pytest.mark.cuda
@pytest.mark.parametrize("n, zigzag, Hk", [(2, False, 4), (4, False, 4), (2, True, 2), (4, True, 4)])
def test_ring_matches_whole_sequence_kernels(cuda, n, zigzag, Hk):
    """The ring over n in-process ranks (K2 a block, K3 a block in the
    backward) against K2 and K3 on the whole sequence, with the launches the
    block decomposition predicts."""
    import merv_tpu_torch.ops.ring_attention as R
    from merv_tpu_torch.parallel import VirtualMesh

    rng = np.random.default_rng(n + 7 * zigzag)
    S, H = 1024, 4
    q, do = _bf16(rng, (1, H, S, 128), cuda), _bf16(rng, (1, H, S, 128), cuda)
    k, v = _bf16(rng, (1, Hk, S, 128), cuda), _bf16(rng, (1, Hk, S, 128), cuda)
    o_ref, lse_ref = A.flash_attention_forward(q, k, v, causal=True, return_lse=True)
    grads = A.flash_attention_backward(q, k, v, o_ref, lse_ref, do, causal=True)
    perm = torch.as_tensor(R.zigzag_perm(S, n), device=cuda) if zigzag else torch.arange(S, device=cuda)
    inv = torch.argsort(perm)
    leaves = tuple(t[:, :, perm].contiguous().requires_grad_() for t in (q, k, v))
    A.reset_launch_counts()
    out = R.ring_attention(*leaves, VirtualMesh(n), causal=True, zigzag=zigzag)
    out.backward(do[:, :, perm].contiguous())
    counts = A.launch_counts()
    want = R.ring_block_count(n, True, zigzag)
    assert (counts["flash_attention_forward"], counts["flash_attention_backward"]) == (want, want)
    _assert_close(out.detach()[:, :, inv], o_ref, A.flash_attention_forward(q, k, v.abs(), causal=True))
    for leaf, ref, mag in zip(leaves, grads, backward_mags(q, k, v, lse_ref, do, causal=True)):
        _assert_close(leaf.grad[:, :, inv], ref, mag)


# K6: the towers' LayerNorm shapes (one served video's LanguageBind rows, the align micro-batch's DINOv2 rows, ViViT's
# 3,137 tokens, SigLIP's micro-batch, so400m's frames), rows that leave the last block's warps partly idle (257, 261),
# a [B, S, D] input; eps 1e-5 and 1e-6; fp32 w and b as the towers store them, bf16 ones too
LAYER_NORM_EDGES = [(4112, 1024, 1e-5, torch.float32), (66816, 1024, 1e-6, torch.float32),
                    (3137, 768, 1e-6, torch.float32), (50176, 768, 1e-6, torch.float32),
                    (4096, 1152, 1e-6, torch.float32), (257, 1024, 1e-5, torch.float32),
                    (261, 768, 1e-6, torch.float32), (257, 1152, 1e-5, torch.float32),
                    (261, 1024, 1e-6, torch.bfloat16), (257, 768, 1e-5, torch.bfloat16),
                    ((16, 261, 1024), 1024, 1e-6, torch.float32)]


def _ln_params(rng, D, dtype, dev):
    w = torch.from_numpy(1 + 0.3 * rng.standard_normal(D).astype(np.float32)).to(dev, dtype)
    b = torch.from_numpy(0.5 * rng.standard_normal(D).astype(np.float32)).to(dev, dtype)
    return w, b


@pytest.mark.cuda
@pytest.mark.parametrize("rows,D,eps,wdtype", LAYER_NORM_EDGES)
def test_layer_norm_matches_plain(cuda, rows, D, eps, wdtype):
    import merv_tpu_torch.ops.layer_norm as LN

    rng = np.random.default_rng(D + (rows if isinstance(rows, int) else 1))
    shape = (rows, D) if isinstance(rows, int) else rows
    x = _bf16(rng, shape, cuda) * 3 + 0.7  # a mean away from 0, which a one-pass variance would lose
    w, b = _ln_params(rng, D, wdtype, cuda)
    before = A.launch_counts()
    out = LN.layer_norm_one_pass(x, w, b, eps)
    assert A.launches_since(before) == {"layer_norm": 1}
    ref = LN.layer_norm_plain(x, w, b, eps)
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    _assert_close(out, ref, torch.zeros_like(ref))
    ulps = bf16_ulps(out, ref, layer_norm_terms(x, w, b, eps))
    print(f"layer_norm {shape} eps {eps} {wdtype}: bit-equal share {ulps['bit_equal_share']:.6f}, "
          f"at most {ulps['max_ulps']:.3f} bf16 ulps")
    assert ulps["max_ulps"] <= 1.0, ulps
    assert torch.equal(LN.layer_norm_one_pass(x, w, b, eps), out)  # the same bits every call


@pytest.mark.cuda
def test_layer_norm_route_on_the_card(cuda):
    """``layer_norm`` takes the kernel for bf16 x of its widths with nothing to
    differentiate, and keeps the plain formula (nothing counted) for fp32 x,
    other widths and calls that need a gradient."""
    import merv_tpu_torch.ops.layer_norm as LN

    rng = np.random.default_rng(3)
    for D, dtype, grad, kernel in ((1024, torch.bfloat16, False, True), (768, torch.bfloat16, False, True),
                                   (1024, torch.float32, False, False), (512, torch.bfloat16, False, False),
                                   (1024, torch.bfloat16, True, False)):
        x = _bf16(rng, (37, D), cuda).to(dtype)
        w, b = _ln_params(rng, D, torch.float32, cuda)
        w.requires_grad_(grad)
        before = A.launch_counts()
        out = LN.layer_norm(x, w, b, 1e-6)
        assert A.launches_since(before) == ({"layer_norm": 1} if kernel else {})
        assert (out.grad_fn is not None) is grad
        _assert_close(out, LN.layer_norm_plain(x, w, b, 1e-6), torch.zeros_like(out, dtype=torch.float32))
    # the kernel's wrapper raises on what the kernel does not take
    w, b = _ln_params(rng, 1024, torch.float32, cuda)
    misaligned = torch.empty(37 * 1024 + 1, dtype=torch.bfloat16, device=cuda)[1:].view(37, 1024)
    for x, wb in ((_bf16(rng, (37, 1024), cuda).float(), (w, b)), (_bf16(rng, (37, 512), cuda), (w[:512], b[:512])),
                  (_bf16(rng, (37, 1024), cuda), (w, b.half())), (misaligned, (w, b))):
        with pytest.raises(ValueError):
            LN.layer_norm_one_pass(x, *wb, 1e-6)


def _layer_norm_f64_stats(x, w, b, eps):
    """The plain formula with its mean and variance taken in float64, then
    rounded to fp32: as exact as the plain version, with other roundings in
    its statistics."""
    xd = x.double()
    mean = xd.mean(-1, keepdim=True).float()
    var = xd.var(-1, keepdim=True, unbiased=False).float()
    return (((x.float() - mean) * torch.rsqrt(var + eps)) * w.float() + b.float()).to(x.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("tower,sites", [("dinov2", 46), ("languagebind", 70)])
def test_layer_norm_in_a_tower_matches_plain(cuda, tower, sites):
    """A full-size tower at B = 1 (16 frames at 224 px) under ``no_grad``: one
    K6 launch a norm site (DINOv2-L's penultimate-layer tap: 23 layers x 2;
    LanguageBind-L: 23 x 3 with the temporal norm, and its pre-norm), each held
    against the plain formula on its own input and within one bf16 ulp of it.
    The tower's output against the same tower with every norm forced through
    the plain formula: a one-ulp difference at a norm moves the layers after
    it, as any other order of the statistics' sums does (on random weights
    LanguageBind-L's output moves by ~1.4e-2 relative L2 under either, DINOv2's
    by ~1e-8), so the distance is held against a control, the same tower with
    its norms' statistics taken in float64: at most twice the control's, plus
    1e-4 (a fortieth of a bf16 ulp)."""
    import merv_tpu_torch.ops.layer_norm as LN
    from chip_smoke import patched, rel_l2
    from merv_tpu_torch.device import make_generator
    from merv_tpu_torch.models.backbones.video import DinoV2VideoBackbone, LangBindVideoBackbone
    from merv_tpu_torch.nn.core import LayerNorm, init_weights

    cls, ident = ((DinoV2VideoBackbone, "dinov2-video-all-tokens") if tower == "dinov2"
                  else (LangBindVideoBackbone, "languagebind-video-noclass"))
    vb = cls(ident, "resize-naive", num_frames=16, device=cuda)
    gen = make_generator(cuda, 11)
    init_weights(vb, gen)
    with torch.no_grad():
        for m in vb.modules():
            if isinstance(m, LayerNorm):
                m.weight.normal_(1.0, 0.2, generator=gen)
                m.bias.normal_(0.0, 0.2, generator=gen)
    video = torch.randn((1, *vb.default_video_resolution), generator=gen, device=cuda)
    one_pass, held = LN.layer_norm_one_pass, []

    def one_pass_held(x, w, b, eps):
        out = one_pass(x, w, b, eps)
        ref = LN.layer_norm_plain(x, w, b, eps)
        held.append((hold(out, ref, torch.zeros_like(ref, dtype=torch.float32)),
                     bf16_ulps(out, ref, layer_norm_terms(x, w, b, eps))))
        return out

    with torch.no_grad():
        before = A.launch_counts()
        with patched((LN, "layer_norm_one_pass", one_pass_held)):
            out = vb(video)
        assert A.launches_since(before).get("layer_norm") == sites
        with patched((LayerNorm, "forward", lambda m, x: LN.layer_norm_plain(x, m.weight, m.bias, m.eps))):
            ref = vb(video)
        with patched((LayerNorm, "forward", lambda m, x: _layer_norm_f64_stats(x, m.weight, m.bias, m.eps))):
            control = vb(video)
    assert len(held) == sites
    assert all(h["ok"] for h, _ in held), [h for h, _ in held if not h["ok"]][:2]
    assert max(u["max_ulps"] for _, u in held) <= 1.0
    share = sum(u["bit_equal_share"] for _, u in held) / sites
    moved, control_moved = rel_l2(out.float(), ref.float()), rel_l2(control.float(), ref.float())
    print(f"{tower}: {sites} norms, mean bit-equal share {share:.6f}; output moved {moved:.3e} (relative L2), "
          f"the float64-statistics control {control_moved:.3e}")
    assert moved <= 2 * control_moved + 1e-4
