"""Attention ops: five hand-written Hopper kernels, their plain versions, the
autograd Functions around them, and the dispatcher (counterpart of
``merv_tpu/ops/attention.py``).

Shapes follow ``merv_tpu``: ``[batch, heads, seq, head_dim]``, GQA through
``num_kv_heads < num_heads``.

- :func:`small_attention_kt` (``csrc/small_attention_kt.cu``) replaces the
  Pallas ``small_attention_kt`` the towers' frame attention runs.
- :func:`small_attention` (``csrc/small_attention.cu``) replaces the Pallas
  ``_small_attention``, the ``"small"`` plan of :func:`attention` (the towers'
  ``MERV_TPU_TOWER_ATTN=xla`` route).
- :func:`packed_temporal_attention` (``csrc/packed_temporal.cu``) replaces the
  Pallas ``packed_temporal_attention`` (LanguageBind's temporal attention
  under ``MERV_TPU_TEMPORAL_KERNEL=1``).
- :func:`flash_attention_forward` (``csrc/flash_fwd.cu``) replaces the Pallas
  ``_flash_forward`` (and, at ViViT's shape, the forward of the library
  flash kernel the TPU used); it also returns the per-row log-sum-exp.
- :func:`flash_attention_backward` (``csrc/flash_bwd.cu``) replaces the
  backward of the ``_flash_attention`` custom VJP and of the library flash
  kernel the TPU trained through.

The sixth kernel, the fused ViT attention half-layer, is in
:mod:`merv_tpu_torch.ops.fused_vit_block`; its launches are counted here too.

Each wrapper takes its plain PyTorch version (``*_plain``) only for tensors on
the CPU; for a CUDA tensor it launches the kernel or raises. Each counts its
launches in a plain integer (:func:`launch_counts`), so a run can show it went
through the kernel. The two plain forwards differ on purpose where their JAX
counterparts do: the flash forward writes 0 for a row with no valid key,
:func:`attention_reference` (mask value ``-0.7 * fp32 max``) averages V
there; :class:`FlashAttention`'s gradient there is the reference's, as in
``merv_tpu``.

Gradients: :class:`SmallAttentionKt`, :class:`SmallAttention`,
:class:`PackedTemporalAttention` and :class:`FlashAttention` are the
``torch.autograd.Function`` s the model calls. The first three recompute
their backward through a reference, as ``merv_tpu``'s rules do; the last saves
``q, k, v, o, lse`` and runs :func:`flash_attention_backward`. The ``q_offset``
path is inference-only, as in ``merv_tpu``: asking for its gradient raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Union

import torch

from merv_tpu_torch.ops import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# kernel launches per wrapper, counted where each launches its kernel (the
# wrappers of fused_vit_attn_block, int8_linear, decode_attention and layer_norm live in
# ops/fused_vit_block.py, ops/int8_linear.py, ops/decode_attention.py and ops/layer_norm.py;
# fused_vit_attn_block counts head dims 64 and 72 apart, decode_attention its launches with an LSE output apart)
_LAUNCHES = {"small_attention_kt": 0, "flash_attention_forward": 0, "flash_attention_backward": 0,
             "small_attention": 0, "packed_temporal_attention": 0, "fused_vit_attn_block": 0,
             "fused_vit_attn_block_d72": 0, "int8_linear": 0, "decode_attention": 0, "decode_attention_lse": 0,
             "layer_norm": 0}


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
    q_offset: Optional[Union[int, torch.Tensor]] = None,
) -> torch.Tensor:
    """Materialized-scores attention. q [B,H,Tq,D], k/v [B,Hk,Tk,D], kv_mask [B,Tk] bool.

    Scores in fp32 (exact products of the inputs), masked entries set to
    ``DEFAULT_MASK_VALUE``, the softmax cast to the input dtype before PV.
    Causal masking is aligned to the right: query i sits at key ``q_offset + i``
    (default ``Tk - Tq``). ``q_offset`` is a host int, a 0-d tensor, or a [B]
    tensor (query i of row b at key ``q_offset[b] + i``: the serving engine's
    batched verify, each slot at its own cache length); a tensor is never read
    back to the host."""
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
        qi = torch.arange(Tq, device=q.device)[:, None]
        ki = torch.arange(Tk, device=q.device)[None, :]
        if isinstance(q_offset, torch.Tensor) and q_offset.dim() == 1:
            visible = (ki[None] <= qi[None] + q_offset.to(q.device)[:, None, None])[:, None]  # [B, 1, Tq, Tk]
        else:
            visible = ki <= qi + (Tk - Tq if q_offset is None else q_offset)
        logits = logits.masked_fill(~visible, DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# K1: small_attention_kt (tower frame attention)
# ---------------------------------------------------------------------------

SMALL_KT_MAX_T = 512  # K and V of one head fit the block's shared memory
# the head dims K1 and B3 are built for: 64 (DINOv2, LanguageBind, ViViT, SigLIP-B)
# and 72 (SigLIP so400m, 1152 / 16)
SMALL_HEAD_DIMS = (64, 72)


def small_attention_kt_plain(q: torch.Tensor, kt: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """The kernel's function in plain torch: fp32 scores, exact softmax, p cast
    to the value dtype for PV, output divided by the fp32 row sum after PV."""
    s = torch.matmul(q.float(), kt.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return (o / l).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The SMs of CUDA device ``index`` (the kernels' launch plans read it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


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

    CUDA: ``csrc/small_attention_kt.cu`` (bf16, D in :data:`SMALL_HEAD_DIMS`, T <= 512).
    CPU: :func:`small_attention_kt_plain`.

    Replaces ``merv_tpu/ops/attention.py::small_attention_kt`` (Pallas,
    ``pallas_call`` at :540). Bound on the H100 by bytes at the towers' T of
    257/261 (~T/2 flops per byte, under the bf16 balance point). Design
    (``csrc/small_attn_hopper.cuh``): a persistent grid of one block per SM
    walks the heads; a producer warpgroup brings each head's kt in with one
    bulk copy, rewrites it into swizzled slabs that wgmma reads MN-major, and
    loads V by TMA into a ring of two stages; two consumer warpgroups run
    Q K^T and P V by wgmma on 64-row query tiles with a whole row of scores
    in registers for T <= 272 and the TPU kernel's exact softmax order (see
    the source). At D = 72 the head dims 64-71 take a fifth k step and an
    m64n16 P V product from 32-byte-wide slabs. Every base pointer must be
    16-byte aligned."""
    B, H, T, D = q.shape
    if kt.shape != (B, H, D, T) or v.shape != q.shape:
        raise ValueError(f"small_attention_kt: q {tuple(q.shape)}, kt {tuple(kt.shape)}, v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return small_attention_kt_plain(q, kt, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"small_attention_kt: unsupported device {q.device}")
    _check_cuda("small_attention_kt", q, kt, v)
    if D not in SMALL_HEAD_DIMS or not 0 < T <= SMALL_KT_MAX_T:
        raise ValueError(f"small_attention_kt: the CUDA kernel takes D in {SMALL_HEAD_DIMS} and T <= {SMALL_KT_MAX_T}, "
                         f"got D={D} T={T}")
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
# B3: small_attention (tower frame attention through attention())
# ---------------------------------------------------------------------------


def small_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """The kernel's function in plain torch, in ``merv_tpu``'s
    ``_small_attn_kernel`` order: fp32 scores, p cast to the value dtype for
    PV, the output divided by the fp32 row sum after PV (that is
    :func:`small_attention_kt_plain` on K transposed). GQA by repeat. The TPU
    kernel's key-side pad mask hides only the keys it padded on; nothing is
    padded here."""
    k, v = _repeat_kv(k, v, q.shape[1])
    return small_attention_kt_plain(q, k.transpose(-1, -2), v, scale)


def small_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Whole-sequence, non-causal, unmasked attention: q [B,H,T,D],
    k/v [B,Hk,T,D] (GQA through the kv-head index, nothing repeated).

    CUDA: ``csrc/small_attention.cu`` (bf16, D in :data:`SMALL_HEAD_DIMS`, T <= 512, H % Hk == 0).
    CPU: :func:`small_attention_plain`.

    Replaces ``merv_tpu/ops/attention.py::_small_attention`` (Pallas,
    ``pallas_call`` at :473). Bound on the H100 by bytes at the towers' T.
    Design: K1's (``csrc/small_attn_hopper.cuh``: persistent grid, K and V of
    the kv head loaded by TMA into a ring of two stages, wgmma with a whole
    row of scores in registers, the exact softmax order) with K read K-major
    as it lies. Every base pointer must be 16-byte aligned."""
    B, H, T, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[2:] != q.shape[2:] or v.shape != k.shape:
        raise ValueError(f"small_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    Hk = k.shape[1]
    if q.device.type == "cpu":
        return small_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"small_attention: unsupported device {q.device}")
    _check_cuda("small_attention", q, k, v)
    if D not in SMALL_HEAD_DIMS or not 0 < T <= SMALL_KT_MAX_T or H % Hk:
        raise ValueError(f"small_attention: the CUDA kernel takes D in {SMALL_HEAD_DIMS}, T <= {SMALL_KT_MAX_T} and "
                         f"H % Hk == 0, got D={D} T={T} H={H} Hk={Hk}")
    lib = _kernel_lib("small_attention")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.small_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Hk, T, D, float(scale), stream
        )
    _build.check(lib, rc, "small_attention")
    _LAUNCHES["small_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# B5: packed_temporal_attention (LanguageBind temporal attention, opt-in)
# ---------------------------------------------------------------------------


def _same_head(R: int, heads: int, device) -> torch.Tensor:
    """[R, R] bool: packed row r may attend row r' (r % heads == r' % heads)."""
    idx = torch.arange(R, device=device) % heads
    return idx[:, None] == idx[None, :]


def packed_temporal_attention_plain(
    q: torch.Tensor, kt: torch.Tensor, v: torch.Tensor, scale: float, heads: int
) -> torch.Tensor:
    """The kernel's function in plain torch, step by step as ``merv_tpu``'s
    ``_packed_temporal_kernel``: fp32 scores, other heads' rows set to
    ``DEFAULT_MASK_VALUE`` (their p underflows to exactly 0), fp32 softmax
    statistics, p cast to the value dtype for PV, output divided by l after PV."""
    s = torch.matmul(q.float(), kt.float()) * scale
    s = s.masked_fill(~_same_head(q.shape[1], heads, q.device), DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return (o / l).to(q.dtype)


def packed_temporal_reference(
    q: torch.Tensor, kt: torch.Tensor, v: torch.Tensor, scale: float, heads: int
) -> torch.Tensor:
    """``merv_tpu``'s ``_packed_temporal_reference``: what the backward
    recomputes through (softmax, then PV in the value dtype)."""
    s = torch.matmul(q.float(), kt.float()) * scale
    s = s.masked_fill(~_same_head(q.shape[1], heads, q.device), DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v).to(q.dtype)


def packed_temporal_attention(
    q: torch.Tensor, kt: torch.Tensor, v: torch.Tensor, scale: float, heads: int
) -> torch.Tensor:
    """Head-interleaved packed attention: q/v [Bn,R,D], kt [Bn,D,R], rows
    ordered (frame, head); row r attends the rows r' with
    ``r % heads == r' % heads``, a mask the kernel builds itself.

    CUDA: ``csrc/packed_temporal.cu`` (bf16, D == 64, R <= 512).
    CPU: :func:`packed_temporal_attention_plain`.

    Replaces ``merv_tpu/ops/attention.py::packed_temporal_attention``
    (Pallas, ``pallas_call`` at :622). Bound on the H100 by bytes at
    LanguageBind's [514, 128, 64]. Design: a persistent grid bringing each
    window in by three 1-D bulk copies, and only the live scores (each row's
    own head's keys, R / heads of R) in fp32 on the CUDA cores, with the
    TPU kernel's exact softmax order (see the source)."""
    Bn, R, D = q.shape
    if kt.shape != (Bn, D, R) or v.shape != q.shape:
        raise ValueError(f"packed_temporal_attention: q {tuple(q.shape)}, kt {tuple(kt.shape)}, v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return packed_temporal_attention_plain(q, kt, v, scale, heads)
    if q.device.type != "cuda":
        raise ValueError(f"packed_temporal_attention: unsupported device {q.device}")
    _check_cuda("packed_temporal_attention", q, kt, v)
    if D != 64 or not 0 < R <= SMALL_KT_MAX_T or heads <= 0:
        raise ValueError(f"packed_temporal_attention: the CUDA kernel takes D == 64, R <= {SMALL_KT_MAX_T} and "
                         f"heads > 0, got D={D} R={R} heads={heads}")
    lib = _kernel_lib("packed_temporal")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.packed_temporal_bf16(
            q.data_ptr(), kt.data_ptr(), v.data_ptr(), out.data_ptr(), Bn, R, D, int(heads), float(scale), stream
        )
    _build.check(lib, rc, "packed_temporal_attention")
    _LAUNCHES["packed_temporal_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: flash_attention_forward (ViViT frames, LLM prefill)
# ---------------------------------------------------------------------------


def _visible(B: int, Tq: int, Tk: int, causal: bool, kv_mask, offset, device) -> torch.Tensor:
    """[B or 1, 1, Tq, Tk] bool: the (query, key) pairs the flash function lets
    through. ``offset``: query 0's key position, an int or a 0-d or [B] tensor."""
    valid = torch.ones((1, 1, Tq, Tk), dtype=torch.bool, device=device)
    if kv_mask is not None:
        valid = valid & kv_mask[:, None, None, :].bool()
    if causal:
        qi = torch.arange(Tq, device=device)[:, None]
        ki = torch.arange(Tk, device=device)[None, :]
        if isinstance(offset, torch.Tensor) and offset.dim() == 1:
            offset = offset.to(device)[:, None, None, None]
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
    q_offset: Optional[Union[int, torch.Tensor]] = None,
    return_lse: bool = False,
):
    """The flash kernel's function in plain torch: fp32 scores, right-aligned
    causal mask, exact zeros for masked keys, 0 for a row with no valid key,
    p cast to the value dtype for PV, division by the fp32 row sum after PV.
    ``return_lse`` also returns the fp32 log-sum-exp ``m + log l`` [B, H, Tq]
    of the scaled scores (+inf for a row with no valid key). ``q_offset`` may
    also be a 0-d or [B] tensor (K5's plain version with its LSE)."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    k, v = _repeat_kv(k, v, H)
    scale = D ** -0.5 if scale is None else scale
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    offset = Tk - Tq if q_offset is None else q_offset if isinstance(q_offset, torch.Tensor) else int(q_offset)
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
    block per (batch, head, 128 query rows); a producer warp streams 128-key
    K/V tiles by TMA through a ring of shared-memory stages, two consumer
    warpgroups run wgmma with an fp32 online softmax, masks (key mask,
    right-aligned causal, ragged edges) applied in the kernel on the tiles
    that need them, and causal tiles past the block's last visible key
    skipped (see the source)."""
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


class SmallAttention(torch.autograd.Function):
    """:func:`small_attention` (``impl="plain"``: its plain version) with the
    backward of ``merv_tpu``'s ``_small_attention_bwd_rule``: a recompute
    through :func:`attention_reference` (GQA folded by autograd)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, impl: str):
        fn = small_attention_plain if impl == "plain" else small_attention
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return fn(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
            out = attention_reference(qq, kk, vv, scale=ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, (qq, kk, vv), g)
        return dq, dk, dv, None, None


class PackedTemporalAttention(torch.autograd.Function):
    """:func:`packed_temporal_attention` (``impl="plain"``: its plain version)
    with the backward of ``merv_tpu``'s ``_packed_temporal_bwd_rule``: a
    recompute through :func:`packed_temporal_reference`."""

    @staticmethod
    def forward(ctx, q, kt, v, scale: float, heads: int, impl: str):
        fn = packed_temporal_attention_plain if impl == "plain" else packed_temporal_attention
        ctx.save_for_backward(q, kt, v)
        ctx.scale, ctx.heads = scale, heads
        return fn(q, kt, v, scale, heads)

    @staticmethod
    def backward(ctx, g):
        q, kt, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = tuple(x.detach().requires_grad_() for x in (q, kt, v))
            out = packed_temporal_reference(*leaves, ctx.scale, ctx.heads)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None, None)


def _empty_row_dv(lse: torch.Tensor, do: torch.Tensor, Hk: int, Tk: int) -> torch.Tensor:
    """[B, Hk, 1, D] fp32: what ``merv_tpu``'s reference backward gives every
    key's dV from the query rows with no valid key (``lse == +inf``): the
    reference averages V there, so each key receives ``round(1/Tk) * dO_row``
    (1/Tk rounded to the input dtype, as its probabilities are), summed over
    the rows and over each GQA group. Tensor ops only: no host sync, and no
    copy of dO (the rows are summed by one [1, Tq] @ [Tq, D] product per head)."""
    B, H, _, D = do.shape
    empty = torch.isposinf(lse).to(do.dtype)[:, :, None, :]  # [B, H, 1, Tq]
    rows = torch.matmul(empty, do).float()  # [B, H, 1, D]
    w = torch.tensor(1.0 / Tk, dtype=do.dtype).item()
    return w * rows.view(B, Hk, H // Hk, 1, D).sum(2)


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention_forward` and :func:`flash_attention_backward`
    (``impl="plain"``: both plain versions). The forward computes and keeps
    the log-sum-exp only when the caller wants a gradient (``with_grad``:
    ``ctx.needs_input_grad`` does not see ``torch.no_grad``). A query row
    with no valid key outputs 0, but its gradient is ``merv_tpu``'s
    (``_flash_bwd_rule`` takes the VJP of :func:`attention_reference`, which
    averages V there): dq = dk = 0 and every key's dv gains
    :func:`_empty_row_dv`. Only a key mask or ``Tq > Tk`` under the causal
    mask can leave such a row, so only those calls pay for the check."""

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
        Tq, Tk = q.shape[2], k.shape[2]
        if kv_mask is not None or (ctx.causal and Tq > Tk):  # only these can leave a row with no valid key
            dv = dv + _empty_row_dv(lse, do, k.shape[1], Tk).to(dv.dtype)
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


def add_launch_counts(delta: dict) -> None:
    """Add launches the wrappers did not count themselves: a CUDA graph's
    replay launches what its capture recorded, and calls no wrapper."""
    for name, n in delta.items():
        _LAUNCHES[name] += n


def launches_since(before: dict) -> dict:
    """The launches counted since ``before`` (a :func:`launch_counts`), the kernels that ran only."""
    return {name: n - before[name] for name, n in _LAUNCHES.items() if n != before[name]}


_SIGNATURES = {
    "small_attention_kt": (
        "small_attention_kt_bf16",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p],
    ),
    "small_attention": (
        "small_attention_bf16",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p],
    ),
    "packed_temporal": (
        "packed_temporal_bf16",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p],
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
    return _build.bind(name, *_SIGNATURES[name])


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
      (DINOv2 261, LanguageBind spatial 257) -> ``'small'``: the towers'
      ``_mha`` runs it as small_attention_kt (K1) on its kt layout, and
      :func:`attention` (``self_shaped`` is ``q.shape == k.shape``) as
      small_attention (B3). ``merv_tpu`` plans this for D <= 128; the port
      for the head dims its kernels are built for, :data:`SMALL_HEAD_DIMS`
      (64, and SigLIP so400m's 72): no tower ``merv_tpu`` registers reaches
      another head dim at 224-512 tokens, and any other D stays plain;
    - every causal call with ``Tq > 1`` (the LLM's no-cache forward and cache
      prefill) and every call with ``min(Tq, Tk) >= 2048`` (ViViT's 3137
      tokens) -> flash_attention_forward;
    - the rest (SigLIP's 196-token frames, LanguageBind's temporal bias path,
      anything with an additive bias) -> plain torch, as these
      ran as plain XLA in ``merv_tpu``.

    The decoder sends its cached calls of at most 16 query rows (decode, the
    verify) to ``ops/decode_attention.py`` (K5) before this plan is asked.

    These rules route the main path through the kernels; no threshold here
    is a measured H100 crossover yet.
    """
    if has_bias:
        return "plain"
    if (not causal and not has_mask and self_shaped and Tq == Tk and 224 <= Tq <= SMALL_KT_MAX_T
            and D in SMALL_HEAD_DIMS):
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
    q_offset: Optional[Union[int, torch.Tensor]] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Multi-head attention. q [B,H,Tq,D]; k/v [B,Hk,Tk,D]; kv_mask [B,Tk] bool.

    ``impl="auto"`` runs the plan of :func:`dispatch_plan` through the kernel
    wrappers; ``impl="plain"`` runs the same plan through the plain versions
    (for comparing the whole path on the card against its plain form). The
    ``'flash'`` plan goes through :class:`FlashAttention`, so it is
    differentiable (except with ``q_offset``, which raises); the ``'small'``
    plan (self-shaped tower frames, as ``merv_tpu``'s ``attention()`` plans
    it) through :class:`SmallAttention`. The towers reach it on the
    ``MERV_TPU_TOWER_ATTN=xla`` route; their default route calls
    :class:`SmallAttentionKt` itself on its kt layout. A ``q_offset`` held
    in a tensor (the serving engine's per-slot verify gives a [B] vector)
    takes the plain path, as ``merv_tpu`` routes a vector offset to XLA: the
    kernels take a host int."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    D = q.shape[-1]
    scale_val = D ** -0.5 if scale is None else scale
    Tq, Tk = q.shape[2], k.shape[2]
    plan = dispatch_plan(Tq, Tk, D, causal=causal, has_bias=bias is not None, has_mask=kv_mask is not None,
                         self_shaped=q.shape == k.shape and q_offset is None)
    if isinstance(q_offset, torch.Tensor):
        plan = "plain"
    if plan == "small":
        return SmallAttention.apply(q, k, v, scale_val, impl)
    if plan == "flash":
        return flash_attention(q, k, v, causal=causal, kv_mask=kv_mask, scale=scale_val, q_offset=q_offset, impl=impl)
    return attention_reference(
        q, k, v, causal=causal, kv_mask=kv_mask, bias=bias, scale=scale_val, q_offset=q_offset
    )
