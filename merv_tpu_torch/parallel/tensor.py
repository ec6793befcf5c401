"""Tensor parallelism's collectives: what ``merv_tpu``'s GSPMD places for its
Megatron splits (``llm_tensor_parallel_rules``), written out for one process
a rank.

A decoder cut to its rank's shards (:func:`merv_tpu_torch.parallel.sharding.shard_decoder`)
carries a :class:`TensorShards`: its process group over the mesh's
``tensor`` axis and the sizes of its shards. Three collectives follow from
the splits, and each counts its calls in :data:`COUNTS`:

- :func:`reduce_sum`: the sum of the row-split Linears' partial outputs
  (``o_proj``, ``down_proj``) before the residual add: one all-reduce each,
  two a layer;
- :func:`embed_lookup`: the vocab-split embedding. A rank looks up the ids in
  its range of rows and gives 0 for the others, then one all-reduce sums the
  ranks' rows (exact: one rank holds each id);
- :func:`gather_logits`: the vocab-split head's logits gathered to the whole
  vocabulary before any sampling, one all-gather, so every rank draws the
  same token from the same generator.

A decode step thus makes 2 L + 1 sums and 1 gather. Every rank holds the same
hidden states after each sum, so every rank runs the same requests and
computes the same tokens. NCCL's collectives can be captured in a CUDA
graph; gloo's cannot (:attr:`TensorShards.capturable`), and the decode step
runs eagerly there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

# collectives issued by the tensor-parallel decoder: partial-output sums (with the embedding's) and logit gathers
COUNTS = {"sum": 0, "gather": 0}


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def split_range(size: int, n: int, rank: int) -> Tuple[int, int]:
    """[lo, hi) of shard ``rank`` of ``size`` over ``n`` ranks: ``ceil(size / n)``
    each, the last one short where ``n`` does not divide ``size`` (GSPMD's padded shards)."""
    per = -(-size // n)
    return min(rank * per, size), min((rank + 1) * per, size)


@dataclasses.dataclass(frozen=True)
class TensorShards:
    """This rank's part of a decoder split over the ``tensor`` axis."""

    group: Any  # the process group over the mesh's tensor axis
    n: int
    rank: int
    num_heads: int  # this rank's query heads
    kv_heads: int  # the key/value heads it computes and caches: num_kv_heads / n, or all of them
    kv_attend: Optional[Tuple[int, int]]  # where k/v stay whole: [lo, hi) of the kv heads its queries attend
    vocab: int  # the whole vocabulary
    vocab_range: Tuple[int, int]  # [lo, hi) of its embedding rows and head columns

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture the collectives: NCCL's, not gloo's."""
        return str(torch.distributed.get_backend(self.group)) == "nccl"


def tensor_shards(cfg: Any, group: Any, n: int, rank: int) -> TensorShards:
    """The shards of a decoder of config ``cfg`` at rank ``rank`` of ``n``.
    Query heads split evenly (``num_heads % n != 0`` raises). Key/value heads
    split where ``num_kv_heads % n == 0``; otherwise they stay whole on every
    rank, as ``merv_tpu``'s engine keeps its cache, and each rank's queries
    attend the kv heads of their group, which must be one contiguous group
    pattern (``num_heads / n`` heads within one kv head's group)."""
    H, Hk = cfg.num_heads, cfg.num_kv_heads
    if H % n != 0:
        raise ValueError(f"tensor parallelism over {n} ranks needs the query heads to split evenly: "
                         f"num_heads={H} (head_dim {cfg.head_dim}) is not a multiple of {n}")
    h = H // n
    if Hk % n == 0:
        kv_heads, attend = Hk // n, None
    else:
        group_size = H // Hk
        if group_size % h != 0:
            raise ValueError(f"tensor parallelism over {n} ranks: {h} query heads a rank straddle the key/value "
                             f"groups of num_heads={H}, num_kv_heads={Hk}")
        lo = rank * h // group_size
        kv_heads, attend = Hk, (lo, lo + 1)
    return TensorShards(group, n, rank, h, kv_heads, attend, cfg.vocab_size, split_range(cfg.vocab_size, n, rank))


def reduce_sum(x: torch.Tensor, tp: Optional[TensorShards]) -> torch.Tensor:
    """The sum over the tensor group of each rank's partial ``x`` (in place, returned)."""
    if tp is None:
        return x
    COUNTS["sum"] += 1
    x = x.contiguous()
    torch.distributed.all_reduce(x, group=tp.group)
    return x


def embed_lookup(weight: torch.Tensor, ids: torch.Tensor, tp: TensorShards,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The vocab-split embedding: this rank's rows ``weight`` [hi - lo, E]
    looked up where an id lies in its range, 0 elsewhere, summed over the group."""
    lo, hi = tp.vocab_range
    local = ids - lo
    own = (local >= 0) & (local < hi - lo)
    rows = weight[torch.where(own, local, torch.zeros_like(local))]
    out = torch.where(own[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return reduce_sum(out.to(dtype) if dtype is not None else out, tp)


def gather_logits(x: torch.Tensor, tp: Optional[TensorShards]) -> torch.Tensor:
    """[..., hi - lo] vocab-split logits -> [..., vocab] on every rank (the
    shards padded to the first's width where the vocabulary does not split evenly)."""
    if tp is None:
        return x
    COUNTS["gather"] += 1
    per = -(-tp.vocab // tp.n)
    x = x.contiguous()
    if x.shape[-1] < per:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (per - x.shape[-1],))], dim=-1)
    buf = x.new_empty((tp.n * x.shape[0],) + tuple(x.shape[1:]))
    torch.distributed.all_gather_into_tensor(buf, x, group=tp.group)
    buf = buf.view((tp.n,) + tuple(x.shape))
    return buf.movedim(0, -2).reshape(x.shape[:-1] + (tp.n * per,))[..., : tp.vocab]
