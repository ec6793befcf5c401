"""The model's weights, drawn from the run's seed on the device.

Both sides get the same numbers: :func:`draw` fills whatever tensors a
``sink`` returns, by name, from one seeded ``torch.Generator`` in a few large
``normal_`` calls (each at most ``CHUNK`` values, bf16, the type the model is
served in). Every weight is N(0, 0.02); a norm's scale is 1 + N(0, 0.02),
rounded to bf16. The program's parameters are filled in place; the
reference draws the same values again after the program is gone.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

CHUNK = 1 << 28  # values per normal_ call (512 MiB of bf16)
STD = 0.02


def is_norm_scale(name: str) -> bool:
    module, _, leaf = name.rpartition(".")
    return leaf == "weight" and "norm" in module.rsplit(".", 1)[-1]


@torch.no_grad()
def draw(spec: Sequence[Tuple[str, Tuple[int, ...]]], seed: int, device: torch.device,
         sink: Callable[[str, Tuple[int, ...]], torch.Tensor]) -> None:
    """Fill ``sink(name, shape)`` for every (name, shape) of ``spec``, in order, from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    total = sum(_numel(s) for _, s in spec)
    it = iter(spec)
    name, shape = next(it)
    dest = sink(name, shape).view(-1)
    filled = 0
    done = 0
    while done < total:
        n = min(CHUNK, total - done)
        buf = torch.empty(n, dtype=torch.bfloat16, device=device).normal_(0.0, STD, generator=g)
        at = 0
        while at < n:
            take = min(n - at, dest.numel() - filled)
            piece = buf[at:at + take]
            if is_norm_scale(name):
                piece = (piece.float() + 1.0).to(torch.bfloat16)
            dest[filled:filled + take].copy_(piece)
            at += take
            filled += take
            if filled == dest.numel():
                nxt = next(it, None)
                if nxt is None:
                    break
                name, shape = nxt
                dest = sink(name, shape).view(-1)
                filled = 0
        done += n
        del buf


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def draw_dict(spec, seed: int, device: torch.device, dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The weights as new tensors of ``dtype`` (the reference's copy)."""
    out: Dict[str, torch.Tensor] = {}

    def sink(name, shape):
        out[name] = torch.empty(shape, dtype=dtype, device=device)
        return out[name]

    draw(spec, seed, device, sink)
    return out
