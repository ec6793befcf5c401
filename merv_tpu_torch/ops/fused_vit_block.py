"""The fused ViT attention half-layer (counterpart of
``merv_tpu/ops/fused_vit_block.py``): ``x + gamma * o_proj(attn(qkv(LN1(x))))``.

:func:`fused_vit_attn_block` launches ``csrc/fused_vit_block.cu`` for a CUDA
tensor (one C entry point, four kernels on the caller's stream: LN1 (its
statistics and its bf16 output), the q/k/v GEMM, attention per (image,
head), the o-proj GEMM with the bias, LayerScale and fp32-residual
epilogue; the GEMMs and the attention on wgmma fed by TMA) and takes
:func:`fused_vit_attn_block_plain` for a CPU tensor. ``merv_tpu`` runs it
under ``MERV_TPU_FUSED_VIT_BLOCK=1`` (``ViTLayer.forward``).

Two plain functions, kept apart because they round at different places:

- :func:`fused_vit_attn_block_plain` is the kernel's function, step by step
  as ``merv_tpu``'s ``_fused_block_kernel``: fp32 LN statistics, ``xn``
  rounded to x's dtype; each head's q, k, v an fp32 product plus the fp32 bias,
  rounded; fp32 scores; ``p / l`` rounded before PV; ``o_h`` rounded before
  the o-projection, which is accumulated in fp32, then ``+ bo``, then
  ``x + gamma * y`` in fp32 and one rounding.
- :func:`fused_block_reference` is ``merv_tpu``'s ``_fused_block_reference``
  (projections and biases in x's dtype, softmax, PV in x's dtype), what the
  backward recomputes through, as ``_fused_block_bwd_rule`` does.

Weights come in the port's ``Linear`` layout ``(out, in)``.
"""

from __future__ import annotations

import ctypes

import torch

from merv_tpu_torch.ops import _build
from merv_tpu_torch.ops.attention import _LAUNCHES, _check_cuda

_SIGNATURE = ("fused_vit_attn_block_bf16", [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
              + [ctypes.c_void_p])


def _ln_stats(xf: torch.Tensor, eps: float):
    """LN1's fp32 row statistics: mean and 1 / sqrt(var + eps), [..., 1]."""
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return mu, torch.rsqrt(var + eps)


def _normalize(xf, mu, rstd, norm_scale, norm_bias, dtype: torch.dtype) -> torch.Tensor:
    """LN1's output from its statistics in the kernel's order
    (``((x - mu) * rstd) * ns + nb`` in fp32), rounded to ``dtype``."""
    return ((xf - mu) * rstd * norm_scale.float() + norm_bias.float()).to(dtype)


def _layer_norm(x: torch.Tensor, norm_scale: torch.Tensor, norm_bias: torch.Tensor, eps: float):
    """(fp32 x, xn rounded to x's dtype) with ``merv_tpu``'s LN order."""
    xf = x.float()
    mu, rstd = _ln_stats(xf, eps)
    return xf, _normalize(xf, mu, rstd, norm_scale, norm_bias, x.dtype)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    B, S, D = t.shape
    return t.view(B, S, heads, D // heads).transpose(1, 2)


# The plain version's three stages after LN1. Each is also what the card's
# check holds the kernel's matching stage against, fed the kernel's own
# inputs to it (``fused_vit_attn_block_stages``).


def _plain_qkv(xn, wq, bq, wk, bk, wv, bv, heads: int):
    """q, k, v [B, H, S, dh]: each head an fp32 product of xn plus the fp32
    bias, rounded to xn's dtype."""
    xn32 = xn.float()

    def proj(w, b):
        return _heads((torch.matmul(xn32, w.float().t()) + b.float()).to(xn.dtype), heads)

    return proj(wq, bq), proj(wk, bk), proj(wv, bv)


def _plain_attention(q, k, v, scale: float) -> torch.Tensor:
    """o [B, S, H * dh] in v's dtype: fp32 scores, ``p / l`` rounded before
    PV, o_h rounded before the o-projection."""
    B, H, S, dh = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul((p / p.sum(dim=-1, keepdim=True)).to(v.dtype).float(), v.float()).to(v.dtype)
    return o.transpose(1, 2).reshape(B, S, H * dh)


def _plain_out(xf, o, wo, bo, gamma, dtype: torch.dtype) -> torch.Tensor:
    """The o-projection accumulated in fp32, ``+ bo``, then ``x + gamma * y``
    in fp32 and one rounding to ``dtype``."""
    y = torch.matmul(o.float(), wo.float().t()) + bo.float()
    return (xf + gamma.float() * y).to(dtype)


def fused_vit_attn_block_plain(x, norm_scale, norm_bias, wq, bq, wk, bk, wv, bv, wo, bo, gamma, heads: int,
                               eps: float) -> torch.Tensor:
    """The kernel's function in plain torch (the rounding of
    ``_fused_block_kernel``). x [B, S, D]; w* [D, D] (out, in)."""
    D = x.shape[-1]
    xf, xn = _layer_norm(x, norm_scale, norm_bias, eps)
    q, k, v = _plain_qkv(xn, wq, bq, wk, bk, wv, bv, heads)
    return _plain_out(xf, _plain_attention(q, k, v, (D // heads) ** -0.5), wo, bo, gamma, x.dtype)


def fused_block_reference(x, norm_scale, norm_bias, wq, bq, wk, bk, wv, bv, wo, bo, gamma, heads: int,
                          eps: float) -> torch.Tensor:
    """``merv_tpu``'s ``_fused_block_reference`` (differentiable)."""
    B, S, D = x.shape
    dt = x.dtype
    xf, xn = _layer_norm(x, norm_scale, norm_bias, eps)

    def proj(w, b):  # product and bias in x's dtype
        return _heads(torch.matmul(xn, w.to(dt).t()) + b.to(dt), heads)

    q, k, v = proj(wq, bq), proj(wk, bk), proj(wv, bv)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (D // heads) ** -0.5
    o = torch.matmul(torch.softmax(s, dim=-1).to(dt), v)
    y = torch.matmul(o.transpose(1, 2).reshape(B, S, D).float(), wo.to(dt).float().t()) + bo.float()
    return (xf + gamma.float() * y).to(dt)


def _check_args(x, vecs, weights, heads: int) -> None:
    B, S, D = x.shape
    if x.dim() != 3 or D % heads or any(w.shape != (D, D) for w in weights):
        raise ValueError(f"fused_vit_attn_block: x {tuple(x.shape)}, heads {heads}, "
                         f"weights {[tuple(w.shape) for w in weights]}")
    if any(t.shape != (D,) for t in vecs):
        raise ValueError(f"fused_vit_attn_block: vectors {[tuple(t.shape) for t in vecs]}, expected ({D},)")


def fused_vit_attn_block(x, norm_scale, norm_bias, wq, bq, wk, bk, wv, bv, wo, bo, gamma, heads: int,
                         eps: float) -> torch.Tensor:
    """One ViT layer's attention half: x [B, S, D]; w* [D, D] in ``Linear``'s
    (out, in) layout; biases, the LN affine and gamma [D].

    CUDA: ``csrc/fused_vit_block.cu`` through
    :func:`fused_vit_attn_block_stages`. CPU: :func:`fused_vit_attn_block_plain`.

    Replaces ``merv_tpu/ops/fused_vit_block.py::fused_vit_attn_block``
    (Pallas, ``pallas_call`` at :135). Bound on the H100 by operations at
    the towers' shapes (the four D x D projections). Design: see the source."""
    _check_args(x, (norm_scale, norm_bias, bq, bk, bv, bo, gamma), (wq, wk, wv, wo), heads)
    if x.device.type == "cpu":
        return fused_vit_attn_block_plain(x, norm_scale, norm_bias, wq, bq, wk, bk, wv, bv, wo, bo, gamma, heads, eps)
    return fused_vit_attn_block_stages(x, norm_scale, norm_bias, wq, bq, wk, bk, wv, bv, wo, bo, gamma, heads,
                                       eps)[0]


def fused_vit_attn_block_stages(x, norm_scale, norm_bias, wq, bq, wk, bk, wv, bv, wo, bo, gamma, heads: int,
                                eps: float, key_tiled: bool | None = None):
    """One launch of ``csrc/fused_vit_block.cu`` on CUDA tensors: the output
    and the kernel's intermediates, ``{"mu", "rstd"}`` (LN1's statistics,
    [B, S, 1] fp32), ``{"q", "k", "v"}`` ([B, H, S, 64]) and ``"o"`` (the
    attention output, [B, S, D]), so that each stage can be held on its own.

    x and the four weights bf16 and contiguous, D == 64 * heads <= 2048, any S.
    The attention stage goes by S: 256 < S <= 512 stages whole heads, other
    lengths go through the key-tiled stage (on an H100 each is the faster on
    its side of 256). ``key_tiled=True`` forces the key-tiled stage at any S,
    ``False`` the whole-head stage (S <= 512), so that both can be held and
    timed at one shape. The wrapper casts nothing in [D, D]: the weights
    must already be bf16 (the towers store them so). The seven [D] vectors
    are cast to fp32 and stacked once per call, into the one [7, D] block the
    kernel reads. Scratch (LN statistics, q/k/v, and one [B * S, D] buffer
    that holds LN1's output until the attention output overwrites it) is
    allocated here per call."""
    vecs = (norm_scale, norm_bias, bq, bk, bv, bo, gamma)
    _check_args(x, vecs, (wq, wk, wv, wo), heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_vit_attn_block: the kernel needs a CUDA tensor, got {x.device}")
    _check_cuda("fused_vit_attn_block", x, wq, wk, wv, wo)
    B, S, D = x.shape
    if D != 64 * heads or D > 2048:
        # SigLIP so400m (head dim 72) reaches this route under MERV_TPU_FUSED_VIT_BLOCK=1 in merv_tpu: its
        # port waits in ROADMAP.md section B ("B6 at D = 72")
        raise ValueError(f"fused_vit_attn_block: the CUDA kernel takes head dim 64 and D <= 2048, got D={D} "
                         f"heads={heads} (head dim {D // max(heads, 1)}; B6 at other head dims: ROADMAP B)")
    if key_tiled is False and S > 512:
        raise ValueError(f"fused_vit_attn_block: the whole-head stage takes S <= 512, got S={S}")
    if any(t.device != x.device for t in vecs):
        raise ValueError("fused_vit_attn_block: vectors on another device")
    vec = torch.stack(vecs).to(torch.float32)  # one stack, one cast
    M = B * S
    stats = torch.empty((2, M), dtype=torch.float32, device=x.device)
    qkv = torch.empty((3, B, heads, S, 64), dtype=x.dtype, device=x.device)
    attn = torch.empty((M, D), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    lib = _build.bind("fused_vit_block", *_SIGNATURE)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fused_vit_attn_block_bf16(
            x.data_ptr(), vec.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), wo.data_ptr(),
            stats.data_ptr(), qkv.data_ptr(), attn.data_ptr(), out.data_ptr(), B, S, D, heads, -1 if key_tiled is None else int(key_tiled),
            float(eps), 64 ** -0.5, stream,
        )
    _build.check(lib, rc, "fused_vit_attn_block")
    _LAUNCHES["fused_vit_attn_block"] += 1
    stats = stats.view(2, B, S, 1)
    return out, dict(mu=stats[0], rstd=stats[1], q=qkv[0], k=qkv[1], v=qkv[2], o=attn.view(B, S, D))


class FusedVitAttnBlock(torch.autograd.Function):
    """:func:`fused_vit_attn_block` (``impl="plain"``: its plain version) with
    the backward of ``merv_tpu``'s ``_fused_block_bwd_rule``: a recompute
    through :func:`fused_block_reference`."""

    @staticmethod
    def forward(ctx, x, ns, nb, wq, bq, wk, bk, wv, bv, wo, bo, gamma, heads: int, eps: float, impl: str):
        fn = fused_vit_attn_block_plain if impl == "plain" else fused_vit_attn_block
        ctx.save_for_backward(x, ns, nb, wq, bq, wk, bk, wv, bv, wo, bo, gamma)
        ctx.heads, ctx.eps = heads, eps
        return fn(x, ns, nb, wq, bq, wk, bk, wv, bv, wo, bo, gamma, heads, eps)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        want = [i for i, need in enumerate(ctx.needs_input_grad[:12]) if need]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in want) for i, t in enumerate(saved)]
            out = fused_block_reference(*leaves, ctx.heads, ctx.eps)
            grads = torch.autograd.grad(out, [leaves[i] for i in want], g)
        full = [None] * 12
        for i, gi in zip(want, grads):
            full[i] = gi
        return (*full, None, None, None)
