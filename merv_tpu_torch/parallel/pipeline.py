"""Pipeline parallelism: microbatched GPipe over the ``pp`` mesh axis
(counterpart of ``merv_tpu/parallel/pipeline.py``).

The design is ``merv_tpu``'s. The decoder's layers split into ``pp``
contiguous stages of ``L / pp`` layers (each rank keeps only its stage's
layers on the card). The batch splits into ``M`` micro-batches, and over
``M + pp - 1`` ticks stage 0 injects micro-batch ``t`` together with its rope
tables, every stage runs its layers on the micro-batch it holds, and hands
the result (with the tables) to the next stage. The last stage's outputs are
broadcast to every stage at the end. The activation crosses the pipeline's
boundary in fp32 and is cast to the compute dtype inside, as ``merv_tpu``
does (``pipeline.py:118-129``): the gradient that reaches the input is fp32.

What ``merv_tpu`` gets from ``shard_map`` and ``ppermute``'s transpose, the
port writes out:

- a stage computes only on the ticks where it holds a real micro-batch
  (``merv_tpu`` also runs the warm-up and drain ticks on zeros and discards
  them), so each rank launches its layers' kernels ``M`` times a step;
- a hand-off is an explicit send and receive between neighbouring stages
  (:class:`ProcessGroupStages`), each an ``autograd.Function`` whose backward
  is the reverse hand-off. Every hand-off of a rank also threads a 0-d token
  from the one before; the last token enters the final broadcast. So every
  hand-off's backward runs on every rank, in the exact reverse of the
  forward's order, and a rank that waits in a backward waits only on the
  stage after it: the last stage never waits, so no rank deadlocks, and the
  blocking receives of one stage meet its neighbour's sends in the same order;
- the broadcast's backward keeps the last stage's gradient, times ``pp``,
  and gives the other stages none: every stage computes the same loss from
  the broadcast output and backpropagates ``1/pp`` of it (the train step's
  ``TrainSharding.backward_scale``), so the sum of the stages' gradients
  (the broadcast's transpose) is ``pp`` times the last stage's;
- the input's gradient reaches stage 0 alone; the train step sums what the
  stages share (everything outside their layers) over the ``pp`` group, as
  ``merv_tpu``'s psum at the ``shard_map`` boundary does.

:class:`VirtualStages` runs every stage in one process, in turn, handing
blocks over in memory: a :class:`~merv_tpu_torch.parallel.mesh.VirtualMesh`
with ``pipe`` above 1, ``merv_tpu``'s virtual CPU devices.

Under gloo a CUDA tensor's hand-off goes through the host (gloo's send and
receive take CPU tensors); the broadcast takes it as it is, as NCCL does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from merv_tpu_torch.parallel.mesh import PIPE_AXIS, VirtualMesh, axis_size

# hand-offs and broadcasts issued (forward and backward)
COLLECTIVES = {"stage_send": 0, "stage_recv": 0, "broadcast": 0}


def reset_collective_counts() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0


def resolve_microbatches(batch: int, pp: int, requested: int = 0) -> Optional[int]:
    """The GPipe micro-batch count M (``merv_tpu``'s rules and messages).

    ``requested`` > 0 must divide the batch: a mismatch raises instead of
    quietly running the plain loop. With no request, ``min(2 * pp, batch)``
    rounded down to a divisor of ``batch`` (a bubble of at most 1/3); a batch
    of 1 still pipelines with M = 1."""
    if batch <= 0:
        return None
    if requested > 0:
        if batch % requested != 0:
            raise ValueError(
                f"pp_microbatches={requested} does not divide the per-step "
                f"batch {batch}; pick a divisor (or 0 for the default)"
            )
        return requested
    m = min(2 * pp, batch)
    while m > 1 and batch % m != 0:
        m -= 1
    return m


# ---------------------------------------------------------------------------
# Exchanges
# ---------------------------------------------------------------------------


class VirtualStages:
    """``n`` stages in one process; ``stages`` are all of them."""

    def __init__(self, n: int) -> None:
        self.n = n
        self.stages = tuple(range(n))

    def hand_off(self, sent: Dict[int, Tuple], receivers: Sequence[int], template: Tuple, tick: int,
                 token: torch.Tensor) -> Tuple[Dict[int, Tuple], torch.Tensor]:
        return {s: sent[s - 1] for s in receivers}, token

    def broadcast_last(self, outs: torch.Tensor, tokens: Sequence[torch.Tensor]) -> torch.Tensor:
        return outs


class ProcessGroupStages:
    """One stage of the ``pp`` process group."""

    def __init__(self, group) -> None:
        dist = torch.distributed
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.stages = (self.rank,)
        self.global_ranks = [dist.get_global_rank(group, r) for r in range(self.n)]
        self.backend = str(dist.get_backend(group))
        self.pending: List[Any] = []  # sends in flight (work, the tensor it reads), waited for at the end of a pass

    def wait_pending(self) -> None:
        while self.pending:
            work, _ = self.pending.pop()
            work.wait()

    def wait_after_backward(self) -> None:
        """Wait for the backward's sends once the whole backward pass is done."""
        torch.autograd.Variable._execution_engine.queue_callback(self.wait_pending)

    def staged(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.is_cuda

    def hand_off(self, sent: Dict[int, Tuple], receivers: Sequence[int], template: Tuple, tick: int,
                 token: torch.Tensor) -> Tuple[Dict[int, Tuple], torch.Tensor]:
        """Send this stage's (h, cos, sin) to the next stage where it produced
        one, then receive the previous stage's where it is due, each one
        differentiable in h and threaded on ``token``."""
        s = self.rank
        if s in sent:
            token = _Send.apply(token, self, sent[s][0], sent[s][1], sent[s][2], tick)
        got: Dict[int, Tuple] = {}
        if s in receivers:
            h, cos, sin, token = _Recv.apply(token, self, template, tick)
            got[s] = (h, cos, sin)
        return got, token

    def broadcast_last(self, outs: torch.Tensor, tokens: Sequence[torch.Tensor]) -> torch.Tensor:
        return _BroadcastLast.apply(outs, self, *tokens)

    # -- point to point ------------------------------------------------------

    def isend(self, xs: Sequence[torch.Tensor], dst_stage: int, tag: int) -> List[Any]:
        dist = torch.distributed
        works = []
        for i, x in enumerate(xs):
            x = x.detach().contiguous()
            if self.staged(x):
                x = x.cpu()
            COLLECTIVES["stage_send"] += 1
            works.append((dist.isend(x, self.global_ranks[dst_stage], group=self.group, tag=tag * 4 + i), x))
        return works

    def recv(self, templates: Sequence[torch.Tensor], src_stage: int, tag: int) -> List[torch.Tensor]:
        dist = torch.distributed
        out = []
        for i, tpl in enumerate(templates):
            buf = torch.empty(tpl.shape, dtype=tpl.dtype, device="cpu" if self.staged(tpl) else tpl.device)
            COLLECTIVES["stage_recv"] += 1
            dist.recv(buf, self.global_ranks[src_stage], group=self.group, tag=tag * 4 + i)
            out.append(buf.to(tpl.device) if buf.device != tpl.device else buf)
        return out


_BWD = 1 << 20  # the backward's tags, apart from the forward's


class _Send(torch.autograd.Function):
    @staticmethod
    def forward(ctx, token, ex, h, cos, sin, tick: int):
        ctx.ex, ctx.tick, ctx.h_meta = ex, tick, (h.shape, h.dtype, h.device)
        ex.pending.extend(ex.isend([h, cos, sin], ex.rank + 1, tick))
        return token.detach().clone()

    @staticmethod
    def backward(ctx, g_token):
        ex = ctx.ex
        ex.wait_after_backward()
        shape, dtype, device = ctx.h_meta
        (g_h,) = ex.recv([torch.empty(shape, dtype=dtype, device=device)], ex.rank + 1, _BWD + ctx.tick)
        return g_token, None, g_h, None, None, None


class _Recv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, token, ex, template, tick: int):
        ctx.ex, ctx.tick = ex, tick
        h, cos, sin = ex.recv(list(template), ex.rank - 1, tick)
        ctx.mark_non_differentiable(cos, sin)
        return h, cos, sin, token.detach().clone()

    @staticmethod
    def backward(ctx, g_h, g_cos, g_sin, g_token):
        ex = ctx.ex
        ex.wait_after_backward()
        ex.pending.extend(ex.isend([g_h], ex.rank - 1, _BWD + ctx.tick))
        return g_token, None, None, None


class _BroadcastLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, outs, ex, *tokens):
        dist = torch.distributed
        ctx.ex, ctx.n_tokens = ex, len(tokens)
        ex.wait_pending()  # the forward's sends
        buf = outs.detach().contiguous().clone()
        COLLECTIVES["broadcast"] += 1
        dist.broadcast(buf, ex.global_ranks[ex.n - 1], group=ex.group)
        return buf

    @staticmethod
    def backward(ctx, grad):
        ex = ctx.ex
        g = grad * ex.n if ex.rank == ex.n - 1 else None
        tokens = [torch.zeros((), device=grad.device) for _ in range(ctx.n_tokens)]
        return (g, None, *tokens)


def stage_exchange(mesh, axis: str = PIPE_AXIS):
    """The exchange of ``mesh``'s ``axis``: :class:`VirtualStages` on a
    :class:`VirtualMesh`, the process group's stages on a device mesh; None
    where the axis is absent or 1."""
    n = axis_size(mesh, axis)
    if n <= 1:
        return None
    if isinstance(mesh, VirtualMesh):
        return VirtualStages(n)
    return ProcessGroupStages(mesh.get_group(axis))


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------


def pipeline_layer_scan(
    layer_fn: Callable[[Any, torch.Tensor, Tuple[torch.Tensor, torch.Tensor]], torch.Tensor],
    h: torch.Tensor,
    cos_sin: Tuple[torch.Tensor, torch.Tensor],
    layers: Sequence[Any],
    mesh,
    *,
    microbatches: int,
    remat: bool = False,
    axis: str = PIPE_AXIS,
    num_layers: Optional[int] = None,
) -> torch.Tensor:
    """Run ``h`` [B, T, D] through ``layers`` as a GPipe pipeline over ``axis``.

    ``layer_fn(layer, h, cos_sin) -> h`` runs one decoder layer; ``cos_sin``
    are [B, T, Dh] rope tables (they travel with their micro-batch).
    ``layers`` are the layers this process holds, in order: all ``L`` under a
    :class:`VirtualMesh` (the stages run in turn), this stage's ``L / pp``
    under a device mesh (``num_layers`` then gives ``L``). ``remat``
    recomputes each layer in the backward. Returns [B, T, D] in ``h``'s
    dtype: the last stage's output, on every stage."""
    ex = stage_exchange(mesh, axis)
    if ex is None:
        raise ValueError("pipeline_layer_scan requires a pp axis > 1 on the mesh")
    pp = ex.n
    B, T, D = h.shape
    L = len(layers) if num_layers is None else num_layers
    M = microbatches
    if L % pp != 0:
        raise ValueError(f"num_layers {L} not divisible by pp={pp}")
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by microbatches={M}")
    per = L // pp
    if len(layers) != per * len(ex.stages):
        raise ValueError(f"{len(layers)} layers held for stages {ex.stages} of {L} layers over pp={pp}")
    mb = B // M

    if remat:
        from torch.utils.checkpoint import checkpoint

        def run_layer(layer, x, cs):
            return checkpoint(layer_fn, layer, x, cs, use_reentrant=False)
    else:
        run_layer = layer_fn

    def stage(s: int, x: torch.Tensor, cs) -> torch.Tensor:
        i = ex.stages.index(s)
        for layer in layers[i * per:(i + 1) * per]:
            x = run_layer(layer, x, cs)
        return x

    compute_dtype = h.dtype
    boundary_dtype = torch.float32 if h.is_floating_point() else compute_dtype
    h_mb = h.to(boundary_dtype).reshape(M, mb, T, D)
    cos, sin = cos_sin
    cos_mb, sin_mb = cos.reshape(M, mb, *cos.shape[1:]), sin.reshape(M, mb, *sin.shape[1:])
    template = (torch.empty((mb, T, D), dtype=compute_dtype, device=h.device), cos_mb[0], sin_mb[0])

    token = torch.zeros((), device=h.device, requires_grad=True)
    held: Dict[int, Tuple] = {}  # stage -> (h, cos_sin) it holds at this tick
    outs: List[Optional[torch.Tensor]] = [None] * M
    for t in range(M + pp - 1):
        sent: Dict[int, Tuple] = {}
        for s in ex.stages:
            m = t - s
            if not 0 <= m < M:
                continue
            x, cs = (h_mb[m].to(compute_dtype), (cos_mb[m], sin_mb[m])) if s == 0 else held[s]
            y = stage(s, x, cs)
            if s == pp - 1:
                outs[m] = y
            else:
                sent[s] = (y, cs[0], cs[1])
        receivers = [s for s in ex.stages if s > 0 and 0 <= t - (s - 1) < M]
        got, token = ex.hand_off(sent, receivers, template, t, token)
        held = {s: (v[0], (v[1], v[2])) for s, v in got.items()}
    if ex.stages[-1] == pp - 1:
        out = torch.stack(outs)
    else:
        out = torch.zeros((M, mb, T, D), dtype=compute_dtype, device=h.device)
    out = ex.broadcast_last(out.to(boundary_dtype), [token])
    return out.reshape(B, T, D).to(compute_dtype)
