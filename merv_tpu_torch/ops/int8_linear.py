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
from typing import Optional

import torch

from merv_tpu_torch.ops import _build
from merv_tpu_torch.ops.attention import _LAUNCHES, _check_cuda

INT8_KERNEL_MAX_ROWS = 64  # rows of x the kernel takes (8 mma tiles of 8)
INT8_KERNEL_K_MULTIPLE = 64  # the kernel's K chunk

# calls of quantized_linear that took the plain matmul form (more than INT8_KERNEL_MAX_ROWS rows)
_MATMUL = {"int8_linear_matmul": 0}


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
    operations a byte. Design: 16 output columns a block, 8 warps splitting K,
    16-byte weight loads past L1, the m16n8k16 bf16 tensor-core product with
    the weights as A and x as B (see the source)."""
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
    lib = _build.bind("int8_linear", "int8_linear_bf16", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.int8_linear_bf16(x2.data_ptr(), weight_q.data_ptr(), scale.data_ptr(),
                                  None if bias is None else bias.data_ptr(), y.data_ptr(), M, N, K, stream)
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
