"""Optimizer and LR schedule (counterpart of ``merv_tpu/training/optimizers.py``).

``merv_tpu`` chains ``optax.clip_by_global_norm`` and ``optax.adamw`` under
``optax.masked``. The port gives the same updates with ``torch.optim.AdamW``
over param groups of the trainable parameters only (frozen ones get no state)
and three points written out where torch's defaults differ from optax:

- the schedule is evaluated at the update count, so the first update uses
  ``schedule(0)``, which is 0 under linear warmup from 0;
- the global-norm clip has no epsilon: gradients become ``g / norm * max``
  when ``norm >= max`` (``clip_grad_norm_`` would add 1e-6 to the norm);
- weight decay is decoupled and applies only to >=2-D, non-bias parameters.

On a mesh the parameters may be FSDP2's sharded ones (``DTensor``): the
global norm sums each rank's squares of its own shards, then over the groups
whose ranks hold different parts (``norm_groups``, set by the strategy from
``TrainSharding.sq_norm_groups``), so that it is the norm of the whole
gradient, and the clip scales each local shard by it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional

import torch
from torch import nn

Schedule = Callable[[int], float]


def build_schedule(
    lr_scheduler_type: str,
    learning_rate: float,
    total_steps: int,
    warmup_ratio: float = 0.03,
) -> Schedule:
    """step -> learning rate: ``optax.warmup_cosine_decay_schedule`` (from 0,
    ``max(int(total * ratio), 1)`` warmup steps, cosine to 0 at
    ``max(total, warmup + 1)``) or a constant."""
    if lr_scheduler_type == "linear-warmup+cosine-decay":
        warmup = max(int(total_steps * warmup_ratio), 1)
        decay = max(total_steps, warmup + 1) - warmup

        def schedule(step: int) -> float:
            if step < warmup:
                return learning_rate * step / warmup
            frac = min(step - warmup, decay) / decay
            return learning_rate * 0.5 * (1.0 + math.cos(math.pi * frac))

        return schedule
    if lr_scheduler_type == "constant":
        return lambda step: learning_rate
    raise ValueError(f"Learning Rate Schedule with type `{lr_scheduler_type}` is not supported!")


def local_shard(t: torch.Tensor) -> torch.Tensor:
    """A sharded tensor's local shard (the tensor itself otherwise)."""
    return t.to_local() if hasattr(t, "to_local") else t


def decay_mask(named_params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """Weight decay only on >=2-D parameters that are not biases."""
    return {name: p.dim() > 1 and name.rsplit(".", 1)[-1] != "bias" for name, p in named_params.items()}


class ClippedAdamW:
    """Global-norm clip, then AdamW (b1 0.9, b2 0.999, eps 1e-8), on the
    parameters ``trainable_mask`` marks (all when it is None).
    :meth:`step` consumes their ``.grad`` and returns the pre-clip global norm."""

    def __init__(
        self,
        named_params: Mapping[str, nn.Parameter],
        schedule: Schedule,
        weight_decay: float,
        max_grad_norm: float,
        trainable_mask: Optional[Mapping[str, bool]] = None,
    ) -> None:
        self.named_params = {n: p for n, p in named_params.items() if trainable_mask is None or trainable_mask[n]}
        self.params = list(self.named_params.values())
        self.schedule, self.max_grad_norm = schedule, max_grad_norm
        decays = decay_mask(self.named_params) if weight_decay > 0 else {n: False for n in self.named_params}
        groups = [
            {"params": [p for n, p in self.named_params.items() if decays[n]], "weight_decay": weight_decay},
            {"params": [p for n, p in self.named_params.items() if not decays[n]], "weight_decay": 0.0},
        ]
        groups = [g for g in groups if g["params"]]
        self.adamw = torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8, foreach=False)
        self.count = 0  # updates applied, as optax counts them
        # parameter -> the process groups over which its gradient's squares add up (None: one device), and
        # every value it can take, in the order all ranks sum them
        self.norm_groups: Optional[Callable[[torch.Tensor], tuple]] = None
        self.norm_keys: List[tuple] = []

    def global_norm(self) -> torch.Tensor:
        grads = [(p, local_shard(p.grad)) for p in self.params if p.grad is not None]
        if not grads:
            return torch.zeros((), dtype=torch.float32)
        if self.norm_groups is None:
            return torch.sqrt(sum(g.float().square().sum() for _, g in grads))
        dev = grads[0][1].device
        by_groups = {key: torch.zeros((), dtype=torch.float32, device=dev) for key in self.norm_keys}
        for p, g in grads:
            by_groups[self.norm_groups(p)] += g.float().square().sum()
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for key in self.norm_keys:
            part = by_groups[key]
            for group in key:
                torch.distributed.all_reduce(part, group=group)
            total += part
        return torch.sqrt(total)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        for p in self.params:
            if p.grad is None:  # a parameter the loss did not reach: optax sees a zero gradient
                p.grad = torch.zeros_like(p)
        norm = self.global_norm()
        for p in self.params:
            g = local_shard(p.grad)
            g.copy_(torch.where(norm < self.max_grad_norm, g, g / norm * self.max_grad_norm))
        lr = self.schedule(self.count)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.count += 1
        return norm

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        return {"count": self.count, "adamw": self.adamw.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.adamw.load_state_dict(state["adamw"])


def build_optimizer(
    named_params: Mapping[str, nn.Parameter],
    schedule: Schedule,
    weight_decay: float,
    max_grad_norm: float,
    trainable_mask: Optional[Mapping[str, bool]] = None,
) -> ClippedAdamW:
    return ClippedAdamW(named_params, schedule, weight_decay, max_grad_norm, trainable_mask)
