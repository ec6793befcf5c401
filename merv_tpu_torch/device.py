"""Device resolution for the port's entry points.

Entry points take ``device=None`` to mean "the card": they run on ``cuda`` and
raise when there is none. The CPU is used only when the caller asks for it
(``device="cpu"``), as the CPU tests do — a missing GPU never silently turns a
chip run into a CPU run.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a GPU); anything else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "merv_tpu_torch runs on a CUDA device by default and none is available; "
                "pass device='cpu' to run on the CPU explicitly"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() is False")
    return dev


def make_generator(device: torch.device, seed: int) -> torch.Generator:
    """A seeded generator on ``device`` (init and sampling never touch the global RNG)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g
