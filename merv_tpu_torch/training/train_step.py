"""The training step and its sharding (counterpart of ``merv_tpu/training/train_step.py``).

``merv_tpu`` compiles one XLA program per step: a ``lax.scan`` over
micro-batches that sums gradients, then the clipped AdamW update, with the
collectives GSPMD derives from the state's shardings. The port runs the same
sequence eagerly: for each micro-batch a forward and ``backward()`` that
accumulates into ``.grad``, then the mean over the micro-batches and
:class:`~merv_tpu_torch.training.optimizers.ClippedAdamW`.

Frozen parameters are the ones with ``requires_grad`` False
(:meth:`MERV.freeze_backbones`): autograd gives them no ``.grad`` buffer and
skips their weight-gradient products, the counterpart of ``stop_gradient``
on the masked leaves.

On a mesh (one process a rank, ``torchrun``), :func:`shard_train_state`
applies the strategy to the model and returns the :class:`TrainSharding` the
step runs under, inside ``activation_mesh(mesh)`` as ``jit_train_step``
scopes it:

- ``fsdp-full-shard``: FSDP2 ``fully_shard`` with ``reshard_after_forward=True``
  on every tower layer, every decoder layer this rank holds, each projector,
  the fusion and the root, every parameter on its dim 0 (FSDP2's default
  placement, on every device; ``merv_tpu``'s own dims are
  :func:`~merv_tpu_torch.parallel.sharding.fsdp_specs`'); grads and the AdamW
  moments are sharded like the parameters;
- ``fsdp-shard-grad-op``: the same with ``reshard_after_forward=False``: the
  parameters stay gathered from the forward to the backward of the step;
- ``ddp``: ``DistributedDataParallel`` over the batch ranks.

How the ranks' gradients add up to ``merv_tpu``'s. Each rank's loss is its
share of the token mean over the whole micro-batch (the losses divide by
:func:`~merv_tpu_torch.parallel.sharding.global_token_count`), so the batch
ranks' gradients must be summed, where FSDP2 and DDP average them: the step
backpropagates the share times the batch ranks' count. Ranks that hold the
same examples in another part, ``sp`` rows or ``pp`` stages, all compute the
same loss; each backpropagates ``1 / (sp * pp)`` of it, the ops that join
their parts (the sp gather, the pipeline's broadcast) hand the gradient
back to the rank that owns it, and after the backward the step sums over the
``sp`` and ``pp`` groups every gradient those ranks share (under ``pp``,
everything outside the stage's layers). The global norm of the clip sums the
squares of every rank's shard once (:meth:`TrainSharding.sq_norm_groups`).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from merv_tpu_torch.parallel.mesh import DATA_AXIS, FSDP_AXIS, PIPE_AXIS, SEQ_AXIS, axis_size, batch_group, batch_size
from merv_tpu_torch.parallel.sharding import activation_mesh
from merv_tpu_torch.tracing import span
from merv_tpu_torch.training.optimizers import ClippedAdamW, local_shard

Batch = Dict[str, Any]
LossFn = Callable[..., torch.Tensor]


def make_loss_fn(
    model: Any,
    remat: bool = True,
    video_transforms: Optional[Sequence[Any]] = None,
    loss_chunk_size: Optional[int] = None,
    attn_impl: str = "auto",
) -> LossFn:
    """``loss_fn(batch, timings=None)``: the multimodal next-token loss of one
    micro-batch. With ``video_transforms``, ``batch["video_values"]`` holds
    uint8 frames at each tower's geometry ``[B, F, S, S, C]``, normalised on
    the card by ``VideoTransform.device_finish``. ``loss_chunk_size`` streams
    the loss over token blocks (:func:`chunked_causal_lm_loss`). ``attn_impl="plain"``
    runs every attention call through the kernels' plain versions. The
    frames' normalisation is the ``train.frames`` span."""

    def loss_fn(batch: Batch, timings: Optional[Dict[str, float]] = None) -> torch.Tensor:
        videos = batch["video_values"]
        if video_transforms is not None:
            with span("train.frames", device=True, timings=timings, key="towers_s"):
                videos = [tf.device_finish(v) for tf, v in zip(video_transforms, videos)]
        out = model(
            batch["input_ids"], batch["attention_mask"], videos, labels=batch["labels"],
            is_multimodal=batch.get("is_multimodal"), attn_impl=attn_impl, remat=remat,
            loss_chunk_size=loss_chunk_size, timings=timings,
        )
        return out["loss"]

    return loss_fn


def micro_batch(batch: Batch, i: int, n: int) -> Batch:
    """The i-th of n equal slices of every batch entry along dim 0 (lists of
    per-encoder videos are sliced entry by entry)."""

    def cut(x):
        if isinstance(x, (list, tuple)):
            return [cut(e) for e in x]
        m = x.shape[0] // n
        return x[i * m : (i + 1) * m]

    return {k: cut(v) for k, v in batch.items()}


def make_train_step(
    loss_fn: LossFn,
    tx: ClippedAdamW,
    grad_accumulation_steps: int = 1,
    sharding: Optional["TrainSharding"] = None,
) -> Callable[..., Dict[str, Any]]:
    """``train_step(batch, timings=None) -> {"loss", "grad_norm", "step"}``.

    ``batch`` holds the rank's batch (leading dim ``accum * micro``); the step
    takes ``grad_accumulation_steps`` equal micro-batches, sums their
    gradients, divides by their count (the plain mean ``merv_tpu`` takes,
    exact for equal micro-batches), clips and updates. ``loss`` is the mean
    of the micro-batch losses (over the whole batch under ``sharding``),
    ``grad_norm`` the global norm before the clip, both 0-d tensors on the
    device (read them when needed: reading syncs). Under ``sharding`` the
    step runs in its mesh's activation scope (see the module's text).

    ``timings`` (a dict) adds a device sync at each boundary and fills
    ``towers_s`` (frame normalisation and the towers), ``llm_s`` (projectors,
    fusion, LLM forward and backward, the loss) and ``optimizer_s``. Spans:
    ``train.step``; ``train.micro`` (with its index) over
    each micro-batch's forward (``train.frames``, ``towers``,
    ``train.forward``) and ``train.backward``; ``train.optimizer``."""
    n = grad_accumulation_steps
    if n < 1:
        raise ValueError(f"grad_accumulation_steps must be >= 1, got {n}")
    scale = 1.0 if sharding is None else sharding.backward_scale
    scope = (lambda: contextlib.nullcontext()) if sharding is None else (lambda: activation_mesh(sharding.mesh))

    def train_step(batch: Batch, timings: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
        device = tx.params[0].device
        if timings is not None:
            timings.update(towers_s=0.0, llm_s=0.0, optimizer_s=0.0)
        with span("train.step", device=device):
            tx.zero_grad()
            loss_sum = torch.zeros((), dtype=torch.float32, device=device)
            with scope():
                for i in range(n):
                    with span("train.micro", index=i, device=device, timings=timings, key="llm_s"):
                        loss = loss_fn(micro_batch(batch, i, n) if n > 1 else batch, timings)
                        with span("train.backward", device=device):
                            (loss * scale if scale != 1.0 else loss).backward()
                        loss_sum += loss.detach().float()
            if timings is not None:
                timings["llm_s"] -= timings["towers_s"]
            with span("train.optimizer", device=device, timings=timings, key="optimizer_s"):
                with torch.no_grad():
                    for p in tx.params:
                        if p.grad is not None and n > 1:
                            p.grad.div_(n)
                if sharding is not None:
                    sharding.sync_grads(tx.params)
                    loss_sum = sharding.batch_sum(loss_sum)
                grad_norm = tx.step()
        return {"loss": loss_sum / n, "grad_norm": grad_norm, "step": tx.count}

    return train_step


# ---------------------------------------------------------------------------
# Sharding the train state
# ---------------------------------------------------------------------------

STRATEGIES = ("fsdp-full-shard", "fsdp-shard-grad-op", "ddp")


class TrainSharding:
    """What a train step needs of its mesh (built by :func:`shard_train_state`):
    the loss scale, the sums over the batch, ``sp`` and ``pp`` groups, and
    the groups each parameter's squared norm sums over."""

    def __init__(self, mesh, strategy: str, module: nn.Module, stage_params: Sequence[torch.Tensor]) -> None:
        self.mesh, self.strategy, self.module = mesh, strategy, module
        self.batch = batch_size(mesh)
        self.sp, self.pp = axis_size(mesh, SEQ_AXIS), axis_size(mesh, PIPE_AXIS)
        # the batch ranks' sum (their shares) from FSDP2's / DDP's mean; 1/(sp pp) of the loss every such rank repeats
        self.backward_scale = self.batch / (self.sp * self.pp)
        self.batch_group = batch_group(mesh)
        self.sp_group = mesh.get_group(SEQ_AXIS) if self.sp > 1 else None
        self.pp_group = mesh.get_group(PIPE_AXIS) if self.pp > 1 else None
        self._stage = {id(p) for p in stage_params}  # the pp stage's own layers: not shared over pp
        self.shard_groups: tuple = ()  # the groups FSDP2 shards over (set by shard_train_state)

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the batch ranks (a loss share -> the loss)."""
        if self.batch_group is None:
            return x
        x = x.detach().clone()
        torch.distributed.all_reduce(x, group=self.batch_group)
        return x

    @torch.no_grad()
    def sync_grads(self, params: Sequence[torch.Tensor]) -> None:
        """Sum over ``sp`` every gradient, and over ``pp`` every gradient of a
        parameter outside the stage's layers (a rank the loss did not reach
        there adds zeros)."""
        for p in params:
            groups = [g for g in (self.sp_group, None if id(p) in self._stage else self.pp_group) if g is not None]
            if not groups:
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            g = local_shard(p.grad)
            for group in groups:
                torch.distributed.all_reduce(g, group=group)

    def sq_norm_groups(self, p: torch.Tensor) -> tuple:
        """The groups whose ranks hold different parts of ``p``'s gradient:
        the fsdp group where FSDP2 shards it, and ``pp`` for a stage's layer.
        One of :attr:`norm_keys`."""
        groups = self.shard_groups if hasattr(p, "placements") else ()
        if self.pp_group is not None and id(p) in self._stage:
            groups = groups + (self.pp_group,)
        return groups

    @property
    def norm_keys(self) -> List[tuple]:
        """Every value :meth:`sq_norm_groups` can take, in one order for every
        rank (each is summed, zeros where a rank has none of its kind)."""
        pp = () if self.pp_group is None else (self.pp_group,)
        keys = [(), self.shard_groups, pp, self.shard_groups + pp]
        return [k for i, k in enumerate(keys) if k not in keys[:i]]


def _fsdp_units(model: nn.Module) -> List[nn.Module]:
    """The modules that get a ``fully_shard`` of their own, children first: each
    tower layer, each decoder layer this rank holds, each projector, the fusion."""
    from merv_tpu_torch.models.backbones.llm.transformer import ForeignLayer

    units: List[nn.Module] = []
    for vb in getattr(model, "video_backbones", []):
        for name, mod in vb.named_modules():
            if isinstance(mod, nn.ModuleList) and name.rsplit(".", 1)[-1] in ("layers", "blocks"):
                units.extend(mod)
    llm = getattr(model, "llm_backbone", None)
    if llm is not None:
        units.extend(layer for layer in llm.decoder.layers if not isinstance(layer, ForeignLayer))
    units.extend(getattr(model, "projectors", []))
    if getattr(model, "feature_fusion", None) is not None:
        units.append(model.feature_fusion)
    return [u for u in units if any(True for _ in u.parameters())]


def shard_train_state(model: nn.Module, mesh, strategy: str = "fsdp-full-shard") -> TrainSharding:
    """Apply ``strategy`` to ``model`` on ``mesh`` in place (see the module's
    text) and return the :class:`TrainSharding` its step runs under. Build the
    optimizer after this: FSDP2 replaces the parameters by sharded ones.
    Under ``pp`` the decoder must hold only its stage's layers
    (:meth:`LlamaDecoder.keep_stage`)."""
    if strategy not in STRATEGIES:
        raise ValueError(f"Train Strategy `{strategy}` is not supported!")
    pp = axis_size(mesh, PIPE_AXIS)
    stage_names = set()
    if pp > 1:
        stage_names = {n for n, _ in model.named_parameters() if n.startswith("llm_backbone.decoder.layers.")}
    module = model
    if batch_size(mesh) > 1 and strategy == "ddp":
        if any(p.requires_grad for p in model.parameters()):
            module = torch.nn.parallel.DistributedDataParallel(
                model, process_group=batch_group(mesh), find_unused_parameters=True, broadcast_buffers=False)
    elif batch_size(mesh) > 1:
        from torch.distributed.fsdp import fully_shard

        fmesh = mesh[FSDP_AXIS] if axis_size(mesh, DATA_AXIS) == 1 else mesh[DATA_AXIS, FSDP_AXIS]
        kw = dict(mesh=fmesh, reshard_after_forward=strategy == "fsdp-full-shard")
        for unit in _fsdp_units(model):
            fully_shard(unit, **kw)
        fully_shard(model, **kw)
        shard_groups = (fmesh.get_group(fmesh.ndim - 1),)
    stage_params = [p for n, p in model.named_parameters() if n in stage_names]
    sharding = TrainSharding(mesh, strategy, module, stage_params)
    if strategy != "ddp" and batch_size(mesh) > 1:
        sharding.shard_groups = shard_groups
    return sharding
