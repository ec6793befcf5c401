"""Primitive layers (counterpart of ``merv_tpu/nn/core.py``).

``nn.Module``s whose parameter names follow the JAX trees, so
:mod:`merv_tpu_torch.bridge` maps a ``merv_tpu`` tree onto them by name:
``Linear.weight`` is the JAX ``kernel`` transposed to torch's ``(out, in)``,
norm ``weight`` is the JAX ``scale``.

Mixed precision follows ``merv_tpu``: parameters live in their ``param_dtype``
and are cast to the activation dtype at use; LayerNorm takes fp32 statistics.
Random init draws from an explicit ``torch.Generator`` through
:func:`init_weights`, never from the global RNG.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from merv_tpu_torch.ops import int8_linear
from merv_tpu_torch.ops.layer_norm import layer_norm

# ---------------------------------------------------------------------------
# Initializers (all draw from an explicit generator, in place)
# ---------------------------------------------------------------------------


@torch.no_grad()
def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    return t.normal_(0.0, std, generator=generator)


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """Normal clipped at +-2 sigma (a cheap stand-in for JAX's truncated normal)."""
    return t.normal_(0.0, 1.0, generator=generator).clamp_(-2.0, 2.0).mul_(std)


@torch.no_grad()
def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> torch.Tensor:
    return t.uniform_(-bound, bound, generator=generator)


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random-init every submodule that defines ``reset_parameters(generator)``,
    children before their parent (so a parent may override its children's
    defaults), in a fixed order: deterministic for a given seed and device."""
    for child in module.children():
        init_weights(child, generator)
    fn = getattr(module, "reset_parameters", None)
    if fn is not None:
        fn(generator)
    return module


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------


class Linear(nn.Module):
    """``y = x @ W.T + b`` with ``W`` stored ``(out, in)``; ``init_std`` selects a
    (clipped) normal init, otherwise torch's default bound ``1/sqrt(in)``.

    :meth:`quantize_` turns it into ``merv_tpu``'s weight-only int8 serving
    layout (``merv_tpu/nn/core.py:126-133``): buffers ``weight_q`` int8
    ``(out, in)`` and ``scale`` fp32 ``(out,)`` in place of ``weight``, and a
    forward through :func:`~merv_tpu_torch.ops.int8_linear.quantized_linear`
    (the product rounded to the compute dtype, times the scale in the compute
    dtype rounded again, then the bias)."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        use_bias: bool = True,
        param_dtype: torch.dtype = torch.float32,
        device: Optional[torch.device] = None,
        init_std: Optional[float] = None,
        init_trunc: bool = False,
    ) -> None:
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.init_std, self.init_trunc = init_std, init_trunc
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, dtype=param_dtype, device=device), requires_grad=False)
        self.bias = (
            nn.Parameter(torch.empty(out_dim, dtype=param_dtype, device=device), requires_grad=False)
            if use_bias else None
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.in_dim)
        if self.init_std is None:
            uniform_(self.weight, bound, generator)
        elif self.init_trunc:
            trunc_normal_(self.weight, self.init_std, generator)
        else:
            normal_(self.weight, self.init_std, generator)
        if self.bias is not None:
            uniform_(self.bias, bound, generator)

    @torch.no_grad()
    def quantize_(self) -> "Linear":
        """Replace ``weight`` by its int8 copy and per-output-channel scales
        (:func:`merv_tpu_torch.nn.quantization.quantize_kernel`), on its device,
        freeing the float weight."""
        from merv_tpu_torch.nn.quantization import quantize_kernel

        q, scale = quantize_kernel(self.weight)
        del self.weight
        self.weight = None
        self.register_buffer("weight_q", q)
        self.register_buffer("scale", scale)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        if self.weight is None:
            return int8_linear.quantized_linear(x, self.weight_q, self.scale, b)
        return F.linear(x, self.weight.to(x.dtype), b)


class Embed(nn.Module):
    def __init__(
        self, vocab_size: int, embed_dim: int, param_dtype: torch.dtype = torch.float32,
        device: Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab_size, embed_dim, dtype=param_dtype, device=device), requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.weight, 1.0, generator)

    def forward(self, ids: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        out = self.weight[ids]
        return out.to(dtype) if dtype is not None else out


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics; output in the input dtype
    (:func:`~merv_tpu_torch.ops.layer_norm.layer_norm`: one kernel where no
    gradient is needed on the card, the plain formula elsewhere)."""

    def __init__(
        self, dim: int, eps: float = 1e-5, param_dtype: torch.dtype = torch.float32,
        device: Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, dtype=param_dtype, device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(dim, dtype=param_dtype, device=device), requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class RMSNorm(nn.Module):
    """Llama RMSNorm: fp32 normalisation, scale applied after the cast back."""

    def __init__(
        self, dim: int, eps: float = 1e-6, param_dtype: torch.dtype = torch.float32,
        device: Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, dtype=param_dtype, device=device), requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps)
        return y.to(x.dtype) * self.weight.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU in fp32. ``merv_tpu`` evaluates erf by a polynomial whose
    error (1.2e-7) is below fp32 test tolerance; torch's erf is used as is."""
    return F.gelu(x.float()).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: x * sigmoid(1.702 x) (LanguageBind towers)."""
    return x * torch.sigmoid(1.702 * x)


ACT2FN: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu": gelu,
    "gelu_tanh": gelu_tanh,
    "gelu_new": gelu_tanh,
    "gelu_pytorch_tanh": gelu_tanh,
    "quick_gelu": quick_gelu,
    "silu": F.silu,
    "relu": F.relu,
}
