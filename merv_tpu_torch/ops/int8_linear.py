"""The weight-only int8 product (K4) and its plain version.

``y = x @ dequant(W).T`` for a Linear stored as int8 ``weight_q [N, K]``
(the port's ``(out, in)`` layout) with fp32 per-output-channel ``scale [N]``
(:mod:`merv_tpu_torch.nn.quantization`), in ``merv_tpu``'s order and
roundings (``merv_tpu/nn/core.py:126-133``): ``x @ q.astype(x.dtype)``
rounded to the compute dtype, times ``scale.astype(x.dtype)`` rounded again,
then the bias.

- :func:`int8_linear` (``csrc/int8_linear.cu``) computes it for at most
  ``INT8_KERNEL_MAX_ROWS`` rows of x, the decode and verify steps' row counts,
  reading each weight byte once. It replaces no Pallas kernel: ``merv_tpu``
  computes this product as XLA, which fuses the int8 upcast into the matmul.
- :func:`quantized_linear` is what ``Linear`` calls: x of at most
  ``INT8_KERNEL_MAX_ROWS`` rows goes to :func:`int8_linear`; more rows (a
  prefill) to the plain form, a ``torch.matmul`` on the weight cast to the
  compute dtype, as ``merv_tpu`` leaves this large product to XLA. That split
  is by shape, and each side is counted (:func:`matmul_dispatches`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from merv_tpu_torch.ops import _build
from merv_tpu_torch.ops.attention import _LAUNCHES, _check_cuda, _sm_count

INT8_KERNEL_MAX_ROWS = 64  # rows of x the kernel takes (8 mma tiles of 8)
INT8_KERNEL_K_MULTIPLE = 64  # K must be a multiple of this (the tensor maps' 16-byte rows, half a k step)
INT8_COLS = 128  # output columns a block owns
INT8_STEP_K = 128  # k per ring stage
INT8_MAX_SPLITS = 8  # K splits of a column tile: one portable thread block cluster
INT8_MIN_STEPS = 2  # k steps a split walks at least

# calls of quantized_linear that took the plain matmul form (more than INT8_KERNEL_MAX_ROWS rows)
_MATMUL = {"int8_linear_matmul": 0}


def int8_linear_plan(M: int, N: int, K: int, sms: int, blocks_per_sm: int, max_clusters=None) -> int:
    """The K splits s of each 128-column tile (one cluster of s blocks): as
    many as one wave holds, so that every SM runs as many warps as it can. The
    tiles fit the device's residency for clusters of s blocks
    (``max_clusters[s - 1]``, the kernel's own figure at M's row tile;
    without it ``sms * blocks_per_sm // s``); s <= 8 (portable) and a split
    walks at least ``INT8_MIN_STEPS`` of the 128-wide k steps. Among those, the
    s with the fewest steps a block, the smaller on a tie. More tiles than one
    wave holds take s = 1."""
    tiles, steps = -(-N // INT8_COLS), -(-K // INT8_STEP_K)
    best, best_work = 1, steps
    for s in range(2, INT8_MAX_SPLITS + 1):
        clusters = max_clusters[s - 1] if max_clusters is not None else sms * blocks_per_sm // s
        if tiles > clusters or steps // s < INT8_MIN_STEPS:
            continue
        if -(-steps // s) < best_work:
            best, best_work = s, -(-steps // s)
    return best


def int8_linear_steps(split: int, splits: int, K: int) -> range:
    """The 128-wide k steps that split ``split`` of ``splits`` walks, as the
    kernel's ``s_begin`` / ``s_end``."""
    steps = -(-K // INT8_STEP_K)
    return range(split * steps // splits, (split + 1) * steps // splits)


@functools.lru_cache(maxsize=None)
def _residency(index: int, row_tiles: int) -> tuple:
    """Clusters of 1..8 blocks of the kernel for ``8 * row_tiles`` rows of x the device holds at once."""
    lib = _build.bind("int8_linear", "int8_linear_residency", [ctypes.c_int, ctypes.c_void_p])
    out = (ctypes.c_int * INT8_MAX_SPLITS)()
    with torch.cuda.device(index):
        rc = lib.int8_linear_residency(8 * row_tiles, ctypes.cast(out, ctypes.c_void_p))
    _build.check(lib, rc, "int8_linear_residency")
    return tuple(out)


def int8_linear_plain(x: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``merv_tpu``'s ``apply_quantized`` plus bias on the ``(out, in)`` layout:
    x [..., K], weight_q int8 [N, K], scale fp32 [N], bias [N] -> [..., N] in x's dtype."""
    y = torch.matmul(x, weight_q.to(x.dtype).T)
    y = y * scale.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def int8_linear(x: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., K] (at most ``INT8_KERNEL_MAX_ROWS`` rows) -> [..., N].

    CUDA: ``csrc/int8_linear.cu`` (bf16 x, int8 weight_q, fp32 scale, K a
    multiple of 64, contiguous 16-byte-aligned tensors). CPU:
    :func:`int8_linear_plain`.

    Bound on the H100 by bytes: N*K weight bytes against at most 128
    operations a byte. Design: 128 output columns a block, K split over the
    blocks of one thread block cluster (:func:`int8_linear_plan`); a producer
    warp streams weights and x by TMA into a 4-stage ring; eight warps run the
    m16n8k16 bf16 tensor-core product with the weights as A; the splits' sums
    meet through distributed shared memory in split order (see the source)."""
    K = x.shape[-1]
    N = weight_q.shape[0]
    if weight_q.dim() != 2 or weight_q.shape[1] != K or tuple(scale.shape) != (N,):
        raise ValueError(f"int8_linear: x {tuple(x.shape)}, weight_q {tuple(weight_q.shape)}, scale {tuple(scale.shape)}")
    if x.device.type == "cpu":
        return int8_linear_plain(x, weight_q, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"int8_linear: unsupported device {x.device}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    _check_cuda("int8_linear", x2)
    if not 0 < M <= INT8_KERNEL_MAX_ROWS or K % INT8_KERNEL_K_MULTIPLE:
        raise ValueError(f"int8_linear: the CUDA kernel takes 1..{INT8_KERNEL_MAX_ROWS} rows and K a multiple of "
                         f"{INT8_KERNEL_K_MULTIPLE}, got M={M} K={K}")
    for name, t, dtype in (("weight_q", weight_q, torch.int8), ("scale", scale, torch.float32)):
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int8_linear: {name} must be a contiguous, 16-byte-aligned {dtype} tensor on {x.device}")
    if bias is not None:
        bias = bias.to(torch.bfloat16).contiguous()
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    sms, residency = _sm_count(index), _residency(index, -(-M // 8))
    splits = int8_linear_plan(M, N, K, sms, residency[0] // sms, residency)
    lib = _build.bind("int8_linear", "int8_linear_bf16", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.int8_linear_bf16(x2.data_ptr(), weight_q.data_ptr(), scale.data_ptr(),
                                  None if bias is None else bias.data_ptr(), y.data_ptr(), M, N, K, splits, stream)
    _build.check(lib, rc, "int8_linear")
    _LAUNCHES["int8_linear"] += 1
    return y.reshape(*lead, N)


def quantized_linear(x: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """An int8 Linear's forward: :func:`int8_linear` for at most
    ``INT8_KERNEL_MAX_ROWS`` rows of x, the plain form above that (counted in
    :func:`matmul_dispatches`)."""
    rows = x.numel() // max(x.shape[-1], 1)
    if rows <= INT8_KERNEL_MAX_ROWS:
        return int8_linear(x, weight_q, scale, bias)
    _MATMUL["int8_linear_matmul"] += 1
    return int8_linear_plain(x, weight_q, scale, bias)


def matmul_dispatches() -> dict:
    return dict(_MATMUL)


def reset_matmul_dispatches() -> None:
    _MATMUL["int8_linear_matmul"] = 0
