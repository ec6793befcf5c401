"""Weight-only int8 quantization for frozen serving weights (counterpart of
``merv_tpu/nn/quantization.py``).

Decode streams every decoder weight each step, so storing each Linear as int8
plus one fp32 scale per output channel halves the bytes it reads; the int8
product runs as :func:`merv_tpu_torch.ops.int8_linear.quantized_linear` (K4
for decode's row counts). Symmetric per output channel, bit for bit
``merv_tpu``'s as it serves: ``amax`` of ``|w|`` in fp32 over the input
dimension, ``scale = amax / 127`` (1.0 where ``amax == 0``), ``round`` half to
even, clipped to +-127. ``merv_tpu`` runs this under ``jit`` (``load_vid``'s
assemble program, the decoder's cache writes), where XLA turns the division by
the constant 127 into a product with fp32 ``1/127``; the port computes that
product (:data:`INV_127`), so its scales are the ones ``merv_tpu`` serves
with. An eager call of ``merv_tpu``'s function divides, and differs from it in
the last bit of some scales.

The port keeps torch's ``(out, in)`` layout: ``weight_q`` int8 ``[out, in]``
and ``scale`` fp32 ``[out]``, where ``merv_tpu`` stores ``kernel_q`` ``[in, out]``
and ``scale`` ``[1, out]`` (:mod:`merv_tpu_torch.bridge` maps one onto the
other). No quality claims: an opt-in serving mode, and training always runs
in full precision.

Under tensor parallelism the whole weights are quantized first and the
shards cut after (``merv_tpu``'s order: its ``load_vid`` quantizes, then
places): a row-split shard (``o_proj``, ``down_proj``) keeps its rows' scales,
computed over the whole input dim, and a column-split one its output
channels' (:func:`merv_tpu_torch.parallel.sharding.shard_decoder`).
Quantizing a shard would change the row-split scales.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import torch
from torch import nn

from merv_tpu_torch.ops.int8_linear import int8_linear_plain

# XLA's folded reciprocal of the divisor: torch multiplies an fp32 tensor by a
# Python float in fp32, the scalar rounded to fp32 first, as XLA's product is
INV_127 = 1.0 / 127.0


def quantize_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., out, in] float -> (int8 ``weight_q`` [..., out, in], fp32 ``scale`` [..., out])."""
    wf = w.float()
    amax = wf.abs().amax(dim=-1, keepdim=True)  # per output channel
    scale = torch.where(amax > 0, amax * INV_127, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def dequantize_kernel(weight_q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (weight_q.float() * scale[..., None]).to(dtype)


def apply_quantized(x: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x @ dequant(W).T in ``merv_tpu``'s roundings (the plain form; no bias)."""
    return int8_linear_plain(x, weight_q, scale)


def quantize_tree(
    tree: Union[nn.Module, Dict[str, torch.Tensor]], skip_keys: Sequence[str] = ("embed_tokens",)
) -> Union[nn.Module, Dict[str, torch.Tensor]]:
    """Quantize every Linear outside ``skip_keys`` subtrees.

    A module: each :class:`~merv_tpu_torch.nn.core.Linear` is quantized in
    place, one at a time, its float weight freed as its int8 copy is made
    (``Linear.quantize_``); returns the module. A state dict: every 2-D
    ``<name>.weight`` (a Linear's; norms are 1-D) becomes ``<name>.weight_q``
    and ``<name>.scale``; returns a new dict. Embeddings stay as they are."""
    from merv_tpu_torch.nn.core import Linear

    def skipped(name: str) -> bool:
        return any(part in skip_keys for part in name.split("."))

    if isinstance(tree, nn.Module):
        for name, module in tree.named_modules():
            if isinstance(module, Linear) and not skipped(name) and module.weight is not None:
                module.quantize_()
        return tree
    out: Dict[str, torch.Tensor] = {}
    for name, t in tree.items():
        if name.endswith(".weight") and t.dim() == 2 and not skipped(name):
            q, s = quantize_kernel(t)
            out[name[: -len("weight")] + "weight_q"], out[name[: -len("weight")] + "scale"] = q, s
        else:
            out[name] = t
    return out
