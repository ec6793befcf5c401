"""Sequence-parallel attention over the mesh's ``sp`` axis (counterpart of
``merv_tpu/ops/ring_attention.py``): the ring for the no-cache forward and
its backward, and attention over a KV cache sharded on its rows for serving.

Ranks and exchanges. The body of each rank is written once and takes the
blocks that reach it from an exchange:

- :class:`ProcessGroupRing`, one rank a process over the mesh's ``sp``
  process group: a ring step is one ``batch_isend_irecv`` (send to rank + 1,
  receive from rank - 1), the cache merge three ``all_reduce`` s. A call on a
  :class:`~torch.distributed.device_mesh.DeviceMesh` always takes it;
- :class:`VirtualRanks`, the ``sp`` ranks of a
  :class:`~merv_tpu_torch.parallel.mesh.VirtualMesh` run in turn in one
  process, their blocks exchanged in memory: ``merv_tpu``'s virtual CPU
  devices, for the tests and the card's kernel checks.

A tensor a rank function receives is "this process's part": the whole
sequence (all virtual ranks' shards, in order) under :class:`VirtualRanks`,
the rank's own shard under :class:`ProcessGroupRing`; ``split`` and ``join``
turn it into the list of shards this process runs and back.

Kernels. Each ring block is one K2 call (:func:`~merv_tpu_torch.ops.attention.flash_attention_forward`
with its log-sum-exp), and the partials merge by their LSE in fp32. Under
the causal mask a block is fully visible, diagonal (causal, ``Tq == Tk``) or
empty; ``merv_tpu`` computes the empty ones and throws them away, the port
skips them (the result is the same). The zigzag layout splits its first step
into (early q, early k) causal, (late q, early k) full and (late q, late k)
causal, and each later step is one full block (see
:func:`_ring_blocks`). The backward (:class:`RingAttention`) replays the
ring with K3 (:func:`~merv_tpu_torch.ops.attention.flash_attention_backward`)
on each block from the final output and the global LSE; each block's dK / dV
accumulate in fp32 and travel with it around the ring back to their owner.
``merv_tpu``'s ring is differentiable by construction (``lax.scan`` and
``ppermute`` transpose); this is its explicit form.

The sharded cache (:func:`sharded_cache_attention`): queries are replicated,
every rank attends its own rows of the cache with the route the unsharded
call takes (K5 at <= 16 query rows, K2 with a host-int offset for longer
prefills, the plain version where that route is plain), each with its LSE
and 0 for a row with no valid key, and the partials merge by one all-reduce
MAX and two all-reduce SUMs, as ``merv_tpu``'s ``pmax`` / ``psum``. GQA goes
to the kernels as grouped heads.

Under a ``tensor x sp`` mesh (``merv_tpu`` splits the ring's and the merge's
heads over ``tensor`` where both head counts divide it) a tensor-parallel
decoder hands each rank's ring and merge its own heads only: a rank's
queries and its key/value heads (or, where those stay whole, the ones its
queries attend), and ``sp_exchange`` gives the mesh's ``sp`` group of the
rank, the ranks that share its tensor coordinate.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

import merv_tpu_torch.ops.attention as A
from merv_tpu_torch.ops import decode_attention as K5
from merv_tpu_torch.parallel.mesh import SEQ_AXIS, VirtualMesh, axis_size

# collectives issued (every exchange counts into these): ring steps and all-reduces
COLLECTIVES = {"ring_shift": 0, "all_reduce": 0, "all_gather": 0}


def reset_collective_counts() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0


# ---------------------------------------------------------------------------
# Exchanges
# ---------------------------------------------------------------------------


class VirtualRanks:
    """``n`` ranks in one process. ``ranks`` are all of them, in order."""

    capturable = True  # an in-memory exchange can be captured in a CUDA graph

    def __init__(self, n: int) -> None:
        self.n = n
        self.ranks = tuple(range(n))

    def split(self, x: torch.Tensor, dim: int) -> List[torch.Tensor]:
        return list(x.chunk(self.n, dim))

    def join(self, xs: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        return torch.cat(list(xs), dim)

    def local(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This process's part of a sequence every rank holds whole: all of it."""
        return x

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole sequence from this process's part: it is the whole."""
        return x

    def shift(self, *groups: List[torch.Tensor]) -> Tuple[List[torch.Tensor], ...]:
        """Every rank's block to rank + 1: rank i receives rank i - 1's."""
        COLLECTIVES["ring_shift"] += 1
        return tuple([xs[(i - 1) % self.n] for i in range(self.n)] for xs in groups)

    def all_reduce(self, xs: List[torch.Tensor], op: str) -> List[torch.Tensor]:
        COLLECTIVES["all_reduce"] += 1
        out = xs[0]
        for x in xs[1:]:
            out = torch.maximum(out, x) if op == "max" else out + x
        return [out] * self.n


class ProcessGroupRing:
    """One rank of the ``sp`` process group. Under gloo a CUDA tensor's ring
    step goes through the host (gloo's send and receive take CPU tensors);
    its all-reduce takes CUDA tensors as they are."""

    def __init__(self, group) -> None:
        dist = torch.distributed
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.ranks = (self.rank,)
        self.next = dist.get_global_rank(group, (self.rank + 1) % self.n)
        self.prev = dist.get_global_rank(group, (self.rank - 1) % self.n)
        self.backend = str(dist.get_backend(group))

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture this exchange's collectives: NCCL's, not gloo's."""
        return self.backend == "nccl"

    def split(self, x: torch.Tensor, dim: int) -> List[torch.Tensor]:
        return [x]

    def join(self, xs: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        return xs[0]

    def local(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x.chunk(self.n, dim)[self.rank].contiguous()

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's rows, in rank order; differentiable (:class:`GatherRows`)."""
        if torch.is_grad_enabled() and x.requires_grad:
            return GatherRows.apply(x, self, dim)
        return self._all_gather(x, dim)

    def _all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        COLLECTIVES["all_gather"] += 1
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.n)]
        torch.distributed.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim)

    def shift(self, *groups: List[torch.Tensor]) -> Tuple[List[torch.Tensor], ...]:
        dist = torch.distributed
        COLLECTIVES["ring_shift"] += 1
        sends = [xs[0].contiguous() for xs in groups]
        stage = self.backend == "gloo" and sends[0].is_cuda
        if stage:
            sends = [x.cpu() for x in sends]
        recvs = [torch.empty_like(x) for x in sends]
        ops = [dist.P2POp(dist.isend, x, self.next, self.group) for x in sends]
        ops += [dist.P2POp(dist.irecv, x, self.prev, self.group) for x in recvs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        dev = groups[0][0].device
        return tuple([r.to(dev) if stage else r] for r in recvs)

    def all_reduce(self, xs: List[torch.Tensor], op: str) -> List[torch.Tensor]:
        dist = torch.distributed
        COLLECTIVES["all_reduce"] += 1
        x = xs[0].contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM, group=self.group)
        return [x]


class GatherRows(torch.autograd.Function):
    """The decoder's gather of the sp ranks' rows before its final norm, as a
    differentiable op. Its transpose hands each rank the gradient of its own
    rows summed over the sp ranks. Every sp rank computes the same loss on
    the gathered rows and backpropagates 1/sp of it (the train step's
    ``TrainSharding.backward_scale``), so every rank holds the same incoming
    gradient, and that sum is sp times the rank's own rows of it: the rows'
    whole gradient, once, with no collective. (``torch.distributed.nn``'s
    all-gather sums the ranks' gradients by a reduce-scatter; on a loss that
    every rank backpropagates in full that is sp times too much.)"""

    @staticmethod
    def forward(ctx, x, ex, dim: int):
        ctx.ex, ctx.dim = ex, dim
        return ex._all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        ex = ctx.ex
        return grad.chunk(ex.n, ctx.dim)[ex.rank] * ex.n, None, None


_RINGS: dict = {}


def sp_exchange(mesh, sp_axis: str = SEQ_AXIS):
    """The exchange of ``mesh``'s ``sp_axis``: :class:`VirtualRanks` for a
    :class:`VirtualMesh`, the process-group ring for a device mesh; None where
    the axis is absent or 1."""
    n = axis_size(mesh, sp_axis)
    if n <= 1:
        return None
    if isinstance(mesh, VirtualMesh):
        return VirtualRanks(n)
    group = mesh.get_group(sp_axis)
    ring = _RINGS.get(id(group))
    if ring is None or ring.group is not group:
        ring = _RINGS[id(group)] = ProcessGroupRing(group)
    return ring


# ---------------------------------------------------------------------------
# The ring
# ---------------------------------------------------------------------------


def _ring_q_block(sq: int, target: int) -> int:
    """Largest divisor of ``sq`` <= target (``merv_tpu``'s q chunk; K2 tiles
    its queries itself, so the port only validates ``block_q`` with it)."""
    return next(b for b in range(min(target, sq), 0, -1) if sq % b == 0)


def zigzag_perm(seq: int, n: int) -> np.ndarray:
    """Gather indices mapping natural token order -> zigzag layout: the
    sequence splits into ``2n`` chunks and ring position ``d`` owns chunks
    ``d`` and ``2n-1-d`` (one early, one late), which evens out the causal
    work across the ring. ``x_zigzag = x[..., perm, :]``; invert with
    ``np.argsort(perm)``."""
    assert seq % (2 * n) == 0, (seq, n)
    c = seq // (2 * n)
    chunks = np.arange(seq).reshape(2 * n, c)
    order = [i for d in range(n) for i in (d, 2 * n - 1 - d)]
    return chunks[order].reshape(-1)


_ALL = slice(None)


def _ring_blocks(idx: int, src: int, S: int, causal: bool, zigzag: bool) -> List[Tuple[slice, slice, bool]]:
    """The K2 calls rank ``idx`` makes on the kv block of rank ``src`` (its
    local rows ``S``): (query rows, key rows, causal) for each.

    Natural layout: every block is full without the causal mask; under it,
    block ``src < idx`` is full, the own block diagonal, ``src > idx`` empty.
    Zigzag (rank ``d`` holds chunks ``d`` and ``2n-1-d`` of ``c = S / 2``
    rows): the own block is (early q, early k) causal, (late q, early k) full
    and (late q, late k) causal; for ``src < idx`` every local query sees the
    incoming early chunk, for ``src > idx`` the late queries see all of the
    incoming block (``merv_tpu``'s ``no_wrap`` / ``wrap`` branches)."""
    if zigzag:
        c = S // 2
        early, late = slice(0, c), slice(c, S)
        if src == idx:
            return [(early, early, True), (late, early, False), (late, late, True)]
        return [(_ALL, early, False)] if src < idx else [(late, _ALL, False)]
    if not causal or src < idx:
        return [(_ALL, _ALL, False)]
    return [(_ALL, _ALL, True)] if src == idx else []


def ring_block_count(n: int, causal: bool, zigzag: bool) -> int:
    """K2 launches of one ring forward over ``n`` ranks (and K3 launches of its backward)."""
    return sum(len(_ring_blocks(i, (i - j) % n, 2, causal, zigzag)) for i in range(n) for j in range(n))


def _rows(x: torch.Tensor, sl: slice) -> torch.Tensor:
    return x if sl == _ALL else x[:, :, sl]


def _merge_into(o_acc: torch.Tensor, lse_acc: torch.Tensor, sl: slice, o: torch.Tensor, lse: torch.Tensor) -> None:
    """Merge a block's (o, lse) into the running fp32 (o, lse) of rows ``sl``, in place."""
    oa, la = _rows(o_acc, sl), lse_acc[..., sl]
    lse = torch.where(torch.isposinf(lse), torch.full_like(lse, float("-inf")), lse)  # K2's empty row weighs 0
    m = torch.maximum(la, lse)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    a, b = torch.exp(la - m), torch.exp(lse - m)
    l = a + b
    oa.copy_((oa * a[..., None] + o.float() * b[..., None]) / torch.where(l == 0, torch.ones_like(l), l)[..., None])
    la.copy_(torch.where(l == 0, torch.full_like(l, float("-inf")), m + torch.log(l)))


def _ring_forward(qs, ks, vs, ex, *, causal: bool, zigzag: bool, scale: float, impl: str):
    """Every local rank's (output in q's dtype, fp32 LSE) of the ring."""
    fwd = A.flash_attention_forward_plain if impl == "plain" else A.flash_attention_forward
    n, S = ex.n, qs[0].shape[2]
    o_acc = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    lse_acc = [torch.full(q.shape[:3], float("-inf"), dtype=torch.float32, device=q.device) for q in qs]
    kc, vc = list(ks), list(vs)
    for j in range(n):
        for i, idx in enumerate(ex.ranks):
            for qr, kr, blk_causal in _ring_blocks(idx, (idx - j) % n, S, causal, zigzag):
                o, lse = fwd(_rows(qs[i], qr).contiguous(), _rows(kc[i], kr).contiguous(),
                             _rows(vc[i], kr).contiguous(), causal=blk_causal, scale=scale, return_lse=True)
                _merge_into(o_acc[i], lse_acc[i], qr, o, lse)
        if j < n - 1:
            kc, vc = ex.shift(kc, vc)
    return [o.to(q.dtype) for o, q in zip(o_acc, qs)], lse_acc


def _ring_backward(qs, ks, vs, os_, lses, dos, ex, *, causal: bool, zigzag: bool, scale: float, impl: str):
    """(dq, dk, dv) lists of the ring: K3 on every block the forward ran, from
    the final output and LSE; dK / dV accumulate in fp32 beside their block
    and reach their owner after the n-th step."""
    bwd = A.flash_attention_backward_plain if impl == "plain" else A.flash_attention_backward
    n, S = ex.n, qs[0].shape[2]
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    dk = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for k in ks]
    dv = [torch.zeros(v.shape, dtype=torch.float32, device=v.device) for v in vs]
    kc, vc = list(ks), list(vs)
    for j in range(n):
        for i, idx in enumerate(ex.ranks):
            for qr, kr, blk_causal in _ring_blocks(idx, (idx - j) % n, S, causal, zigzag):
                gq, gk, gv = bwd(
                    _rows(qs[i], qr).contiguous(), _rows(kc[i], kr).contiguous(), _rows(vc[i], kr).contiguous(),
                    _rows(os_[i], qr).contiguous(), lses[i][..., qr].contiguous(), _rows(dos[i], qr).contiguous(),
                    causal=blk_causal, scale=scale,
                )
                _rows(dq[i], qr).add_(gq.float())
                _rows(dk[i], kr).add_(gk.float())
                _rows(dv[i], kr).add_(gv.float())
        if j < n - 1:
            kc, vc, dk, dv = ex.shift(kc, vc, dk, dv)
        else:
            dk, dv = ex.shift(dk, dv)
    return dq, dk, dv


class RingAttention(torch.autograd.Function):
    """The ring forward (K2 a block) and its backward (K3 a block). Takes and
    returns this process's part of the sequence."""

    @staticmethod
    def forward(ctx, q, k, v, ex, causal: bool, zigzag: bool, scale: float, impl: str):
        qs, ks, vs = (ex.split(t, 2) for t in (q, k, v))
        outs, lses = _ring_forward(qs, ks, vs, ex, causal=causal, zigzag=zigzag, scale=scale, impl=impl)
        o = ex.join(outs, 2)
        ctx.save_for_backward(q, k, v, o, ex.join(lses, 2))
        ctx.ex, ctx.causal, ctx.zigzag, ctx.scale, ctx.impl = ex, causal, zigzag, scale, impl
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        ex = ctx.ex
        parts = [ex.split(t, 2) for t in (q, k, v, o, lse, do.contiguous())]
        dq, dk, dv = _ring_backward(*parts, ex, causal=ctx.causal, zigzag=ctx.zigzag, scale=ctx.scale,
                                    impl=ctx.impl)
        return (ex.join(dq, 2).to(q.dtype), ex.join(dk, 2).to(k.dtype), ex.join(dv, 2).to(v.dtype),
                None, None, None, None, None)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    sp_axis: str = SEQ_AXIS,
    block_q: int = 512,
    zigzag: bool = False,
    impl: str = "auto",
) -> torch.Tensor:
    """Sequence-parallel attention over ``mesh``'s ``sp_axis``: q [B, H, S, D],
    k/v [B, Hk, S, D] as this process holds them (see the module's text; S is
    the process's rows), output likewise. Off-mesh, or with the axis at 1,
    plain :func:`~merv_tpu_torch.ops.attention.attention`.

    ``zigzag=True`` (causal only, global length % 2n == 0): the inputs are
    already in :func:`zigzag_perm` order (the decoder permutes once for its
    whole stack) and the output returns in that order. ``block_q`` is
    ``merv_tpu``'s query chunk: checked, but K2 tiles its queries itself.
    Right padding needs no key mask, as in ``merv_tpu``: positions travel with
    the tokens, so pad keys stay after every valid query. Differentiable
    (:class:`RingAttention`); ``impl="plain"`` runs the plain versions of
    K2 and K3."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    scale = float(q.shape[-1] ** -0.5) if scale is None else scale
    ex = sp_exchange(mesh, sp_axis)
    if ex is None:
        return A.attention(q, k, v, causal=causal, scale=scale, impl=impl)
    n = ex.n
    B, H, S_here, D = q.shape
    Hk = k.shape[1]
    S = S_here * n // len(ex.ranks)
    if S_here % len(ex.ranks) != 0 or S % n != 0:
        raise ValueError(f"sequence length {S} not divisible by sp={n}")
    if H % Hk != 0:
        raise ValueError(f"num_heads {H} not a multiple of kv heads {Hk}")
    _ring_q_block(S // n, block_q)
    if zigzag:
        if not causal:
            raise ValueError("zigzag layout only applies to causal ring attention")
        if S % (2 * n) != 0:
            raise ValueError(f"sequence length {S} not divisible by 2*sp={2 * n} (zigzag)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return RingAttention.apply(q, k, v, ex, causal, zigzag, scale, impl)
    qs, ks, vs = (ex.split(t, 2) for t in (q, k, v))
    outs, _ = _ring_forward(qs, ks, vs, ex, causal=causal, zigzag=zigzag, scale=scale, impl=impl)
    return ex.join(outs, 2)


# ---------------------------------------------------------------------------
# Attention over a sharded KV cache
# ---------------------------------------------------------------------------


def cache_shard_attention(
    q: torch.Tensor,
    shards: Sequence[Tuple[torch.Tensor, ...]],
    masks: Sequence[Optional[torch.Tensor]],
    ex,
    rows: int,
    *,
    causal: bool,
    q_offset: Optional[Union[int, torch.Tensor]],
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """The sharded-cache body: ``shards[i]`` = (k, v, k_scale, v_scale) of
    local rank ``ex.ranks[i]``, whose buffer row 0 is global row
    ``rank * rows``; ``masks[i]`` its [B, Tk_i] key mask. ``q_offset`` is
    global (None, a host int, a 0-d or [B] tensor); each shard sees it less
    its first row. Each shard call returns (o, LSE) with 0 and -inf for a row
    with no valid key there; the merge is one all-reduce MAX and two SUMs in
    fp32. Returns [B, H, T, D] in q's dtype."""
    T, D = q.shape[2], q.shape[3]
    outs, lses = [], []
    for (k, v, ks, vs), mask, r in zip(shards, masks, ex.ranks):
        off = q_offset - r * rows if causal and q_offset is not None else None
        tensor_off = isinstance(off, torch.Tensor)
        if T <= K5.DECODE_MAX_ROWS:
            fn = K5.decode_attention_plain if impl == "plain" else K5.decode_attention
            args = (q, k.contiguous(), v.contiguous(), None if ks is None else ks.contiguous(),
                    None if vs is None else vs.contiguous())
            o, lse = fn(*args, kv_mask=mask, causal=causal, q_offset=off, scale=scale, return_lse=True)
        else:
            plan = A.dispatch_plan(T, k.shape[2], D, causal=causal, has_bias=False, has_mask=mask is not None)
            if plan == "flash" and not tensor_off:
                if ks is not None:  # dequantize on read, as the unsharded call does
                    kk, vv = K5.dequantize_kv(k, ks, q.dtype), K5.dequantize_kv(v, vs, q.dtype)
                else:
                    kk, vv = k.to(q.dtype), v.to(q.dtype)
                fwd = A.flash_attention_forward_plain if impl == "plain" else A.flash_attention_forward
                o, lse = fwd(q, kk.contiguous(), vv.contiguous(), causal=causal, kv_mask=mask, scale=scale,
                             q_offset=off, return_lse=True)
            else:
                o, lse = K5.decode_attention_plain(q, k, v, ks, vs, kv_mask=mask, causal=causal, q_offset=off,
                                                   scale=scale, return_lse=True)
        outs.append(o)
        lses.append(torch.where(torch.isposinf(lse), torch.full_like(lse, float("-inf")), lse))
    m = ex.all_reduce([x.clone() for x in lses], "max")
    w = [torch.exp(x - torch.where(torch.isneginf(mi), torch.zeros_like(mi), mi)) for x, mi in zip(lses, m)]
    l = ex.all_reduce([x.clone() for x in w], "sum")[0]
    o = ex.all_reduce([x.float() * wi[..., None] for x, wi in zip(outs, w)], "sum")[0]
    return (o / l.clamp(min=1e-30)[..., None]).to(q.dtype)


def sharded_cache_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    mesh,
    *,
    q_offset: Union[int, torch.Tensor],
    scale: Optional[float] = None,
    sp_axis: str = SEQ_AXIS,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Serving attention against a KV cache sharded on its rows over
    ``sp_axis`` (``merv_tpu``'s API): q [B, H, T, D] replicated; k/v
    [B, Hk, L, D] (int8 with ``k_scale`` / ``v_scale`` [B, Hk, L, 1]) and
    kv_mask [B, L] as this process holds them (the whole cache under
    :class:`VirtualRanks`, the rank's L/n rows under a process group);
    ``q_offset`` (a host int, or a [B] tensor for per-slot caches) is each
    row's query-0 position in the global cache: key j is visible to query i
    of row b iff ``j <= q_offset[b] + i`` and the mask admits it. A row with
    no valid key anywhere gives 0, as in ``merv_tpu``'s sharded body. Off
    mesh: the unsharded attention (whose rule for such a row is the mean of V)."""
    B, H, T, D = q.shape
    Hk, L = k.shape[1], k.shape[2]
    ex = sp_exchange(mesh, sp_axis)
    if ex is None:
        if k_scale is not None:
            k, v = K5.dequantize_kv(k, k_scale, q.dtype), K5.dequantize_kv(v, v_scale, q.dtype)
        return A.attention(q, k.to(q.dtype), v.to(q.dtype), causal=True, kv_mask=kv_mask, scale=scale,
                           q_offset=q_offset, impl=impl)
    n = ex.n
    L_glob = L * n // len(ex.ranks)
    if L % len(ex.ranks) != 0 or L_glob % n != 0:
        raise ValueError(f"cache length {L_glob} not divisible by sp={n}")
    if H % Hk != 0:
        raise ValueError(f"num_heads {H} not a multiple of kv heads {Hk}")
    if kv_mask is None:
        kv_mask = torch.ones((B, L), dtype=torch.bool, device=q.device)
    split = lambda t: [None] * len(ex.ranks) if t is None else ex.split(t, 2)  # noqa: E731
    shards = list(zip(split(k), split(v), split(k_scale), split(v_scale)))
    return cache_shard_attention(q, shards, ex.split(kv_mask, 1), ex, L_glob // n, causal=True, q_offset=q_offset,
                                 scale=scale, impl=impl)


def constrain_seq_dim(x: torch.Tensor, mesh, *, seq_dim: int = 1) -> torch.Tensor:
    """This process's part of ``x``'s sequence dim under the ``sp`` axis
    (``merv_tpu`` pins the dim's sharding; a process here keeps its rows):
    the rank's shard under a process group, all of it under virtual ranks,
    off mesh, or where the dim does not tile the axis."""
    ex = sp_exchange(mesh)
    if ex is None or x.ndim <= seq_dim or x.shape[seq_dim] % ex.n != 0:
        return x
    return ex.local(x, seq_dim)


def constrain_cache_seq(buf: Optional[torch.Tensor], mesh, *, seq_dim: int = 3) -> Optional[torch.Tensor]:
    """This process's shards of a whole cache buffer (``[L, B, Hkv, max_len,
    D]`` by default): each rank's ``max_len / sp`` rows followed by one
    scratch row (zeros), the layout of a sharded :class:`KVCache`. A no-op off
    mesh or where the dim does not tile the axis."""
    ex = sp_exchange(mesh)
    if buf is None or ex is None or buf.shape[seq_dim] % ex.n != 0:
        return buf
    parts = buf.chunk(ex.n, seq_dim)
    pad_shape = list(buf.shape)
    pad_shape[seq_dim] = 1
    scratch = torch.zeros(pad_shape, dtype=buf.dtype, device=buf.device)
    return torch.cat([t for r in ex.ranks for t in (parts[r], scratch)], dim=seq_dim)
