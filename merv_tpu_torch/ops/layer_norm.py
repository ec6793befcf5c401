"""LayerNorm in one pass (K6) and its plain version.

``y = (x - mean) * rsqrt(var + eps) * w + b`` over the last dimension, with
fp32 statistics and the output in x's dtype, as ``merv_tpu``'s LayerNorm
computes it (``merv_tpu/nn/core.py:168-178``).

- :func:`layer_norm_plain` is that formula in eager PyTorch.
- :func:`layer_norm_one_pass` (``csrc/layer_norm.cu``) computes it in one
  read of x and one write of y, for bf16 x of ``LAYER_NORM_WIDTHS`` columns.
- :func:`layer_norm` is what :class:`~merv_tpu_torch.nn.core.LayerNorm`
  calls: the kernel where :func:`takes_kernel` says so (a bf16 CUDA tensor of
  one of those widths, fp32 or bf16 w and b, no gradient needed: the frozen
  towers, which run under ``torch.no_grad``), the plain version for every
  other call (the CPU, other dtypes and widths, anything autograd must
  differentiate).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from merv_tpu_torch.ops import _build
from merv_tpu_torch.ops.attention import _LAUNCHES, _sm_count

LAYER_NORM_WIDTHS = (768, 1024, 1152)  # the kernel's instances: ViT-B / SigLIP-B, ViT-L, SigLIP so400m
LAYER_NORM_WARPS = 4  # rows a block works on at once (one warp a row)
_WEIGHT_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_DEVICE = "cuda"  # the device type of the calls the kernel takes


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics; output in the input dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def takes_kernel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> bool:
    """Whether the kernel takes the call: bf16 x on CUDA with one of
    ``LAYER_NORM_WIDTHS`` columns, w and b both fp32 or both bf16, and no
    gradient to compute (the kernel has no backward)."""
    needs_grad = torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad)
    return (x.device.type == _KERNEL_DEVICE and x.dtype == torch.bfloat16 and x.shape[-1] in LAYER_NORM_WIDTHS
            and weight.dtype == bias.dtype and weight.dtype in _WEIGHT_DTYPES and not needs_grad)


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(index: int, width: int, w_bf16: bool) -> int:
    """Blocks of the kernel for ``width`` one SM of CUDA device ``index`` holds at once."""
    lib = _build.bind("layer_norm", "layer_norm_residency", [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = lib.layer_norm_residency(width, int(w_bf16), ctypes.byref(out))
    _build.check(lib, rc, "layer_norm_residency")
    return out.value


def layer_norm_one_pass(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """x [..., D] bf16 -> [..., D] bf16, D in ``LAYER_NORM_WIDTHS``; weight and
    bias [D], both fp32 or both bf16: the calls :func:`takes_kernel` holds
    for (``csrc/layer_norm.cu``); raises on any other.

    Bound on the H100 by bytes: 4 bytes an element (x read once, y written
    once). Design: one warp a row held in registers, 16-byte loads and
    stores, warp-shuffle sums, a persistent grid whose warps load the rows two
    strides on before reducing the current one (see the source)."""
    D = x.shape[-1]
    if tuple(weight.shape) != (D,) or tuple(bias.shape) != (D,):
        raise ValueError(f"layer_norm: x {tuple(x.shape)}, weight {tuple(weight.shape)}, bias {tuple(bias.shape)}")
    if not takes_kernel(x, weight, bias):
        raise ValueError(f"layer_norm: the kernel takes bfloat16 CUDA x of {LAYER_NORM_WIDTHS} columns, float32 or "
                         f"bfloat16 weight and bias of one dtype, and nothing to differentiate; got x {x.dtype} on "
                         f"{x.device} of {D} columns, weight {weight.dtype}, bias {bias.dtype}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"layer_norm: {name} must be a contiguous tensor on {x.device}")
    x2 = x.reshape(-1, D).contiguous()
    if x2.data_ptr() % 16:
        raise ValueError("layer_norm: the CUDA kernel needs a 16-byte aligned x")
    y = torch.empty_like(x2)
    rows = x2.shape[0]
    if rows == 0:
        return y.reshape(x.shape)
    w_bf16 = weight.dtype == torch.bfloat16
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    blocks = min(-(-rows // LAYER_NORM_WARPS), _sm_count(index) * _blocks_per_sm(index, D, w_bf16))
    lib = _build.bind("layer_norm", "layer_norm_bf16", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                      + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.layer_norm_bf16(x2.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), rows, D, eps,
                                 int(w_bf16), blocks, stream)
    _build.check(lib, rc, "layer_norm")
    _LAUNCHES["layer_norm"] += 1
    return y.reshape(x.shape)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm's forward: :func:`layer_norm_one_pass` where
    :func:`takes_kernel` holds for the call, :func:`layer_norm_plain`
    otherwise."""
    if takes_kernel(x, weight, bias):
        return layer_norm_one_pass(x, weight, bias, eps)
    return layer_norm_plain(x, weight, bias, eps)
