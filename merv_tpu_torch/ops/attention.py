"""Attention ops: three hand-written Hopper kernels, their plain versions, the
autograd Functions around them, and the dispatcher (counterpart of
``merv_tpu/ops/attention.py``).

Shapes follow ``merv_tpu``: ``[batch, heads, seq, head_dim]``, GQA through
``num_kv_heads < num_heads``.

- :func:`small_attention_kt` (``csrc/small_attention_kt.cu``) replaces the
  Pallas ``small_attention_kt`` the towers' frame attention runs.
- :func:`flash_attention_forward` (``csrc/flash_fwd.cu``) replaces the Pallas
  ``_flash_forward`` (and, at ViViT's shape, the forward of the library
  flash kernel the TPU used); it also returns the per-row log-sum-exp.
- :func:`flash_attention_backward` (``csrc/flash_bwd.cu``) replaces the
  backward of the ``_flash_attention`` custom VJP and of the library flash
  kernel the TPU trained through.

Each wrapper takes its plain PyTorch version (``*_plain``) only for tensors on
the CPU; for a CUDA tensor it launches the kernel or raises. Each counts its
launches in a plain integer (:func:`launch_counts`), so a run can show it went
through the kernel. The two plain forwards differ on purpose where their JAX
counterparts do: the flash forward writes 0 for a row with no valid key (and
its gradient there is 0), :func:`attention_reference` (mask value
``-0.7 * fp32 max``) averages V there.

Gradients: :class:`SmallAttentionKt` and :class:`FlashAttention` are the
``torch.autograd.Function`` s the model calls (the towers' ``_mha`` applies
the first, :func:`attention` the second through :func:`flash_attention`). The first recomputes its backward through
:func:`attention_reference`, as ``merv_tpu``'s rule does; the second saves
``q, k, v, o, lse`` and runs :func:`flash_attention_backward`. The ``q_offset``
path is inference-only, as in ``merv_tpu``: asking for its gradient raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from merv_tpu_torch.ops import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# kernel launches per wrapper, counted where each launches its kernel
_LAUNCHES = {"small_attention_kt": 0, "flash_attention_forward": 0, "flash_attention_backward": 0}


# ---------------------------------------------------------------------------
# Reference (materialized scores)
# ---------------------------------------------------------------------------


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    q_offset: Optional[int] = None,
) -> torch.Tensor:
    """Materialized-scores attention. q [B,H,Tq,D], k/v [B,Hk,Tk,D], kv_mask [B,Tk] bool.

    Scores in fp32 (exact products of the inputs), masked entries set to
    ``DEFAULT_MASK_VALUE``, the softmax cast to the input dtype before PV.
    Causal masking is aligned to the right: query i sits at key ``q_offset + i``
    (default ``Tk - Tq``)."""
    B, H, Tq, D = q.shape
    Hk, Tk = k.shape[1], k.shape[2]
    if Hk != H:
        if H % Hk:
            raise ValueError(f"num_heads {H} is not a multiple of num_kv_heads {Hk}")
        k = k.repeat_interleave(H // Hk, dim=1)
        v = v.repeat_interleave(H // Hk, dim=1)
    scale = D ** -0.5 if scale is None else scale
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask[:, None, None, :].bool(), DEFAULT_MASK_VALUE)
    if causal:
        offset = Tk - Tq if q_offset is None else int(q_offset)
        qi = torch.arange(Tq, device=q.device)[:, None]
        ki = torch.arange(Tk, device=q.device)[None, :]
        logits = logits.masked_fill(~(ki <= qi + offset), DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# K1: small_attention_kt (tower frame attention)
# ---------------------------------------------------------------------------

SMALL_KT_MAX_T = 512  # K and V^T of one head fit the block's shared memory


def small_attention_kt_plain(q: torch.Tensor, kt: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """The kernel's function in plain torch: fp32 scores, exact softmax, p cast
    to the value dtype for PV, output divided by the fp32 row sum after PV."""
    s = torch.matmul(q.float(), kt.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return (o / l).to(q.dtype)


def _check_cuda(name: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices ({t.device} vs {dev})")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the CUDA kernel takes bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the CUDA kernel needs 16-byte aligned tensors")


def small_attention_kt(q: torch.Tensor, kt: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Tower-frame attention with K pre-transposed: q/v [B,H,T,D], kt [B,H,D,T].

    CUDA: ``csrc/small_attention_kt.cu`` (bf16, D == 64, T <= 512).
    CPU: :func:`small_attention_kt_plain`.

    Replaces ``merv_tpu/ops/attention.py::small_attention_kt`` (Pallas,
    ``pallas_call`` at :540). Bound on the H100 by bytes at the towers' T of
    257/261 (~T/2 flops per byte, under the bf16 balance point). Design: one
    block per (batch, head) stages the head's K (transposed out of kt) and
    V^T in shared memory once, then 8 warps take 16 query rows at a time
    through mma.sync with an exact two-pass softmax (see the source)."""
    B, H, T, D = q.shape
    if kt.shape != (B, H, D, T) or v.shape != q.shape:
        raise ValueError(f"small_attention_kt: q {tuple(q.shape)}, kt {tuple(kt.shape)}, v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return small_attention_kt_plain(q, kt, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"small_attention_kt: unsupported device {q.device}")
    _check_cuda("small_attention_kt", q, kt, v)
    if D != 64 or not 0 < T <= SMALL_KT_MAX_T:
        raise ValueError(f"small_attention_kt: the CUDA kernel takes D == 64 and T <= {SMALL_KT_MAX_T}, got D={D} T={T}")
    lib = _kernel_lib("small_attention_kt")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.small_attention_kt_bf16(
            q.data_ptr(), kt.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, T, D, float(scale), stream
        )
    _build.check(lib, rc, "small_attention_kt")
    _LAUNCHES["small_attention_kt"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: flash_attention_forward (ViViT frames, LLM prefill)
# ---------------------------------------------------------------------------


def _visible(B: int, Tq: int, Tk: int, causal: bool, kv_mask, offset: int, device) -> torch.Tensor:
    """[B or 1, 1, Tq, Tk] bool: the (query, key) pairs the flash function lets through."""
    valid = torch.ones((1, 1, Tq, Tk), dtype=torch.bool, device=device)
    if kv_mask is not None:
        valid = valid & kv_mask[:, None, None, :].bool()
    if causal:
        qi = torch.arange(Tq, device=device)[:, None]
        ki = torch.arange(Tk, device=device)[None, :]
        valid = valid & (ki <= qi + offset)
    return valid


def _repeat_kv(k: torch.Tensor, v: torch.Tensor, H: int):
    Hk = k.shape[1]
    if H % Hk:
        raise ValueError(f"num_heads {H} is not a multiple of num_kv_heads {Hk}")
    if Hk == H:
        return k, v
    return k.repeat_interleave(H // Hk, dim=1), v.repeat_interleave(H // Hk, dim=1)


def flash_attention_forward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    q_offset: Optional[int] = None,
    return_lse: bool = False,
):
    """The flash kernel's function in plain torch: fp32 scores, right-aligned
    causal mask, exact zeros for masked keys, 0 for a row with no valid key,
    p cast to the value dtype for PV, division by the fp32 row sum after PV.
    ``return_lse`` also returns the fp32 log-sum-exp ``m + log l`` [B, H, Tq]
    of the scaled scores (+inf for a row with no valid key)."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    k, v = _repeat_kv(k, v, H)
    scale = D ** -0.5 if scale is None else scale
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    offset = Tk - Tq if q_offset is None else int(q_offset)
    s = s.masked_fill(~_visible(B, Tq, Tk, causal, kv_mask, offset, q.device), float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)  # exp(-inf) == 0 at masked keys
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    o = (o / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(l == 0, torch.full_like(l, float("inf")), m + torch.log(l))[..., 0]
    return o, lse.detach()


def flash_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    q_offset: Optional[int] = None,
    return_lse: bool = False,
):
    """Blocked online-softmax attention forward: q [B,H,Tq,D], k/v [B,Hk,Tk,D].

    ``kv_mask`` [B,Tk] bool marks valid keys; under ``causal`` query i sits at
    key ``q_offset + i`` (default ``Tk - Tq``). A row with no valid key is 0.
    ``return_lse`` also returns the fp32 log-sum-exp [B,H,Tq] the backward
    recomputes P from (+inf for a row with no valid key).
    CUDA: ``csrc/flash_fwd.cu`` (bf16, D in {64, 128}, any Tq/Tk).
    CPU: :func:`flash_attention_forward_plain`.

    Replaces ``merv_tpu/ops/attention.py::_flash_forward`` (Pallas,
    ``pallas_call`` at :376) and, at ViViT's shape, the forward of the
    library flash kernel. Bound on the H100 by operations at ViViT's 3137
    tokens and near the balance point at the Llama prefill. Design: one
    block per (batch, head, 64 query rows) loops over 64-key tiles staged in
    shared memory, mma.sync with an fp32 online softmax, masks (key mask,
    right-aligned causal, ragged edges) applied in the kernel, and causal
    tiles past the block's last visible key skipped (see the source)."""
    B, H, Tq, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"flash_attention_forward: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    Hk, Tk = k.shape[1], k.shape[2]
    if kv_mask is not None and tuple(kv_mask.shape) != (B, Tk):
        raise ValueError(f"flash_attention_forward: kv_mask {tuple(kv_mask.shape)} != {(B, Tk)}")
    if q.device.type == "cpu":
        return flash_attention_forward_plain(
            q, k, v, causal=causal, kv_mask=kv_mask, scale=scale, q_offset=q_offset, return_lse=return_lse
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_forward: unsupported device {q.device}")
    _check_cuda("flash_attention_forward", q, k, v)
    if D not in (64, 128) or H % Hk:
        raise ValueError(f"flash_attention_forward: the CUDA kernel takes D in (64, 128) and H % Hk == 0, got D={D} H={H} Hk={Hk}")
    mask_ptr = None
    if kv_mask is not None:
        if kv_mask.device != q.device:
            raise ValueError("flash_attention_forward: kv_mask on another device")
        kv_mask = kv_mask.to(torch.bool).contiguous()
        mask_ptr = kv_mask.data_ptr()
    scale = D ** -0.5 if scale is None else scale
    offset = Tk - Tq if q_offset is None else int(q_offset)
    lib = _kernel_lib("flash_fwd")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device) if return_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, H, Hk, Tq, Tk, D, int(causal), offset, float(scale), stream,
        )
    _build.check(lib, rc, "flash_attention_forward")
    _LAUNCHES["flash_attention_forward"] += 1
    return (out, lse) if return_lse else out


# ---------------------------------------------------------------------------
# K3: flash_attention_backward (the LLM's training backward)
# ---------------------------------------------------------------------------


def flash_attention_backward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
):
    """The backward kernel's function in plain torch, fp32 throughout:
    P = exp(S * scale - lse) on the visible pairs (0 elsewhere),
    dV = P^T dO, dP = dO V^T, delta = rowsum(dO * O), dS = P * (dP - delta),
    dK = scale dS^T Q, dQ = scale dS K, with P and dS rounded to the input
    dtype before their products (a no-op in fp32) and dK, dV summed over each
    GQA group. Returns (dq, dk, dv) in the inputs' dtypes."""
    B, H, Tq, D = q.shape
    Hk, Tk = k.shape[1], k.shape[2]
    kr, vr = _repeat_kv(k, v, H)
    scale = D ** -0.5 if scale is None else scale
    qf, kf, vf, dof = q.float(), kr.float(), vr.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    vis = _visible(B, Tq, Tk, causal, kv_mask, Tk - Tq, q.device)
    p = torch.where(vis, torch.exp(s - lse.float()[..., None]), torch.zeros_like(s))
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dq = torch.matmul(ds, kf) * scale
    if Hk != H:  # fold the repeated kv heads back
        dk = dk.view(B, Hk, H // Hk, Tk, D).sum(2)
        dv = dv.view(B, Hk, H // Hk, Tk, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
):
    """dq, dk, dv of :func:`flash_attention_forward` (no ``q_offset``: the
    causal mask sits at ``Tk - Tq``), from its output ``o`` and ``lse``.

    CUDA: ``csrc/flash_bwd.cu`` (bf16, D in {64, 128}, any Tq/Tk): a delta
    pre-pass, a dK/dV kernel with the GQA fold in registers and a dQ kernel.
    CPU: :func:`flash_attention_backward_plain`.

    Replaces the backward of ``merv_tpu/ops/attention.py::_flash_attention``
    (``_flash_bwd_rule``, :791-814) and the library flash backward the TPU
    ran on the LLM's training shape (``_library_flash_call``, :693-718).
    Bound on the H100 by operations at that shape ([1, 32, 3072, 128]
    causal). Design: see the source."""
    B, H, Tq, D = q.shape
    if (k.dim() != 4 or k.shape[0] != B or k.shape[3] != D or v.shape != k.shape or o.shape != q.shape
            or do.shape != q.shape or tuple(lse.shape) != (B, H, Tq)):
        raise ValueError(f"flash_attention_backward: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"o {tuple(o.shape)}, do {tuple(do.shape)}, lse {tuple(lse.shape)}")
    Hk, Tk = k.shape[1], k.shape[2]
    if kv_mask is not None and tuple(kv_mask.shape) != (B, Tk):
        raise ValueError(f"flash_attention_backward: kv_mask {tuple(kv_mask.shape)} != {(B, Tk)}")
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, o, lse, do, causal=causal, kv_mask=kv_mask, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward: unsupported device {q.device}")
    _check_cuda("flash_attention_backward", q, k, v, o, do)
    if D not in (64, 128) or H % Hk:
        raise ValueError(f"flash_attention_backward: the CUDA kernel takes D in (64, 128) and H % Hk == 0, got D={D} H={H} Hk={Hk}")
    if lse.dtype != torch.float32 or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError("flash_attention_backward: lse must be a contiguous float32 tensor on q's device")
    mask_ptr = None
    if kv_mask is not None:
        if kv_mask.device != q.device:
            raise ValueError("flash_attention_backward: kv_mask on another device")
        kv_mask = kv_mask.to(torch.bool).contiguous()
        mask_ptr = kv_mask.data_ptr()
    scale = D ** -0.5 if scale is None else scale
    lib = _kernel_lib("flash_bwd")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(), mask_ptr,
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, Hk, Tq, Tk, D, int(causal), Tk - Tq, float(scale), stream,
        )
    _build.check(lib, rc, "flash_attention_backward")
    _LAUNCHES["flash_attention_backward"] += 1
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Autograd Functions: what the model calls
# ---------------------------------------------------------------------------


class SmallAttentionKt(torch.autograd.Function):
    """:func:`small_attention_kt` (``impl="plain"``: its plain version) with
    the backward of ``merv_tpu``'s rule: a recompute through
    :func:`attention_reference` (K1 has no backward kernel, nor had the TPU's)."""

    @staticmethod
    def forward(ctx, q, kt, v, scale: float, impl: str):
        fn = small_attention_kt_plain if impl == "plain" else small_attention_kt
        ctx.save_for_backward(q, kt, v)
        ctx.scale = scale
        return fn(q, kt, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, kt, v = ctx.saved_tensors
        with torch.enable_grad():
            qq, kk, vv = (x.detach().requires_grad_() for x in (q, kt.transpose(-1, -2), v))
            out = attention_reference(qq, kk, vv, scale=ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, (qq, kk, vv), g)
        return dq, dk.transpose(-1, -2), dv, None, None


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention_forward` and :func:`flash_attention_backward`
    (``impl="plain"``: both plain versions). The forward computes and keeps
    the log-sum-exp only when the caller wants a gradient (``with_grad``:
    ``ctx.needs_input_grad`` does not see ``torch.no_grad``)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal: bool, scale: float, q_offset, impl: str, with_grad: bool):
        fwd = flash_attention_forward_plain if impl == "plain" else flash_attention_forward
        kw = dict(causal=causal, kv_mask=kv_mask, scale=scale, q_offset=q_offset)
        if not with_grad:
            return fwd(q, k, v, **kw)
        out, lse = fwd(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse, kv_mask)
        ctx.causal, ctx.scale, ctx.impl = causal, scale, impl
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kv_mask = ctx.saved_tensors
        bwd = flash_attention_backward_plain if ctx.impl == "plain" else flash_attention_backward
        dq, dk, dv = bwd(q, k, v, out, lse, do.contiguous(), causal=ctx.causal, kv_mask=kv_mask, scale=ctx.scale)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    q_offset: Optional[int] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Differentiable flash attention (:class:`FlashAttention`). A gradient
    through a ``q_offset`` call is refused, as ``merv_tpu`` refuses it."""
    with_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if q_offset is not None and with_grad:
        raise ValueError("flash_attention: the q_offset (KV-cache) path is inference-only and has no gradient")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return FlashAttention.apply(q, k, v, kv_mask, causal, scale, q_offset, impl, with_grad)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(_LAUNCHES)


_SIGNATURES = {
    "small_attention_kt": (
        "small_attention_kt_bf16",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p],
    ),
    "flash_fwd": (
        "flash_fwd_bf16",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p],
    ),
    "flash_bwd": (
        "flash_bwd_bf16",
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p],
    ),
}


def _kernel_lib(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    fn_name, argtypes = _SIGNATURES[name]
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def dispatch_plan(
    Tq: int,
    Tk: int,
    D: int,
    *,
    causal: bool,
    has_bias: bool,
    has_mask: bool = False,
    self_shaped: bool = False,
) -> str:
    """Static kernel choice: ``'small'`` | ``'flash'`` | ``'plain'``.

    - self-shaped, non-causal, unmasked tower frames with ``224 <= T <= 512``
      and D == 64 (DINOv2 261, LanguageBind spatial 257) -> small_attention_kt;
      only the towers' ``_mha`` passes ``self_shaped``, and it makes the kt
      layout the kernel takes;
    - every causal call with ``Tq > 1`` (the LLM's no-cache forward and cache
      prefill) and every call with ``min(Tq, Tk) >= 2048`` (ViViT's 3137
      tokens) -> flash_attention_forward;
    - the rest (SigLIP's 196-token frames, LanguageBind's temporal bias path,
      the T=1 decode, anything with an additive bias) -> plain torch, as these
      ran as plain XLA in ``merv_tpu``.

    These rules route the main path through the two kernels; no threshold
    here is a measured H100 crossover yet.
    """
    if has_bias:
        return "plain"
    if not causal and not has_mask and self_shaped and Tq == Tk and 224 <= Tq <= SMALL_KT_MAX_T and D == 64:
        return "small"
    if D in (64, 128) and ((causal and Tq > 1) or min(Tq, Tk) >= 2048):
        return "flash"
    return "plain"


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    q_offset: Optional[int] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Multi-head attention. q [B,H,Tq,D]; k/v [B,Hk,Tk,D]; kv_mask [B,Tk] bool.

    ``impl="auto"`` runs the plan of :func:`dispatch_plan` through the kernel
    wrappers; ``impl="plain"`` runs the same plan through the plain versions
    (for comparing the whole path on the card against its plain form). The
    ``'flash'`` plan goes through :class:`FlashAttention`, so it is
    differentiable (except with ``q_offset``, which raises).

    :func:`small_attention_kt` takes K transposed, which only the towers'
    frame attention produces (straight out of its k projection), so the
    towers call it themselves (:class:`SmallAttentionKt`) and this dispatcher never
    plans ``'small'``."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    D = q.shape[-1]
    scale_val = D ** -0.5 if scale is None else scale
    Tq, Tk = q.shape[2], k.shape[2]
    plan = dispatch_plan(Tq, Tk, D, causal=causal, has_bias=bias is not None, has_mask=kv_mask is not None)
    if plan == "flash":
        return flash_attention(q, k, v, causal=causal, kv_mask=kv_mask, scale=scale_val, q_offset=q_offset, impl=impl)
    return attention_reference(
        q, k, v, causal=causal, kv_mask=kv_mask, bias=bias, scale=scale_val, q_offset=q_offset
    )
