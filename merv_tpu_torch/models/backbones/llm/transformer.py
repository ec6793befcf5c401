"""Llama-family causal decoder (counterpart of
``merv_tpu/models/backbones/llm/transformer.py``) for every family
``merv_tpu`` registers (Llama-2 7B / 13B, Vicuna-1.5, Llama-3 / 3.1,
Qwen-2.5: GQA, q/k/v biases, tied embeddings): the no-cache forward (with per-layer activation checkpointing, ``remat``, and the
post-norm hidden states, ``return_hidden``, for training), the cache prefill
with a scalar write pointer, and T=1 decode, with RoPE, GQA and a KV cache in
the compute dtype or in int8 with per-position scales (``merv_tpu``'s
``KVCache(dtype=int8)``: quantized on write, dequantized on read).

Differences from ``merv_tpu``, all in idiom, not in function:
- layers are an ``nn.ModuleList`` run in a Python loop (``lax.scan`` there);
- the KV cache is written IN PLACE (``index_copy_`` into the preallocated
  ``[L, B, H_kv, max_len, D]`` buffers), where JAX returns a new buffer. The
  returned :class:`KVCache` shares the tensors, with ``length`` advanced.
  ``length`` is a host int; or, for the captured decode step, a 0-d tensor on
  the device, so that one CUDA graph serves every step; or a [B] tensor of
  per-slot write pointers (the serving engine: row b writes its T new tokens
  at ``length[b]``, ``merv_tpu``'s scatter with ``mode="drop"``);
- attention: a call with a cache and at most ``DECODE_MAX_ROWS`` query rows
  (decode, the speculative verify, short cached prefills) runs
  :func:`merv_tpu_torch.ops.decode_attention.decode_attention` (K5) on the
  layer's cache buffers as they lie, int8 or not; every other call goes
  through :func:`merv_tpu_torch.ops.attention.attention` (the flash kernel for
  T > 1 with a host-int offset), over the layer's cache dequantized first when
  it is int8, as ``merv_tpu`` does. At T = 1 the causal bound is part of the
  key mask (``kv_pos < length + 1``, as ``merv_tpu`` builds it), so no host
  value enters the step. The no-cache forward is differentiable through the
  flash backward kernel;
- ``remat`` is ``torch.utils.checkpoint`` (non-reentrant) around each layer,
  where ``merv_tpu`` wraps its layer scan body in ``jax.checkpoint``.

:func:`pack_serving_params` is ``merv_tpu``'s serving layout: each layer's
q/k/v Linears become one ``attn.qkv_proj`` (``[q_dim + 2 kv_dim, hidden]``,
with the bias where the family has one) and gate/up one ``mlp.gate_up_proj``
(``[2 intermediate, hidden]``), whose output the layer splits by ``q_dim`` /
``kv_dim`` / ``intermediate_size`` as ``merv_tpu``'s ``_layer`` does. It is
applied in place to a serving decoder (``load_vid``'s default); training keeps
the unpacked layers.

Sequence parallelism (``merv_tpu``'s ``DecoderConfig.sequence_parallel``,
taken only where the activation-mesh scope,
:func:`merv_tpu_torch.parallel.activation_mesh`, holds an ``sp`` axis above 1):
- the no-cache forward permutes its tokens once into the zigzag layout
  (``sp_zigzag``, where the sequence tiles ``2 sp``), keeps this process's
  rows, runs every layer's attention as the ring
  (:func:`merv_tpu_torch.ops.ring_attention.ring_attention`) and gathers the
  rows back before the final norm; a sequence that does not tile ``sp`` runs
  unsharded, as in ``merv_tpu``;
- a cache made with ``KVCache.create(..., mesh=...)`` whose length tiles
  ``sp`` is sharded on its rows (:class:`CacheShards`): each rank holds its
  ``max_len / sp`` rows (keys, values and int8 scales alike) and a scratch
  row; a token at global position p is written by the rank that owns p, at
  ``p - rank * rows``, and every other rank writes it to its scratch row,
  which no key mask admits; attention is
  :func:`merv_tpu_torch.ops.ring_attention.cache_shard_attention` (each
  rank's rows with its LSE, merged by all-reduces).
Pipeline parallelism (``merv_tpu``'s ``DecoderConfig.pipeline_parallel``,
taken only where the activation mesh holds a ``pp`` axis above 1, the layers
tile it and a micro-batch count exists; otherwise the plain loop runs, as in
``merv_tpu``): the no-cache forward runs its layers as a GPipe schedule
(:func:`merv_tpu_torch.parallel.pipeline.pipeline_layer_scan`) over
``pp_microbatches`` micro-batches. On a device mesh a rank keeps only its
stage's layers (:meth:`LlamaDecoder.keep_stage`; the others are
:class:`ForeignLayer` placeholders that hold no weights). Both axes at once
raise ``merv_tpu``'s ``ValueError``. The cached path never takes GPipe: under
a pp axis serving runs the plain loop on whole weights, as ``merv_tpu`` does.
Tensor parallelism (``merv_tpu``'s Megatron splits,
``llm_tensor_parallel_rules``): a decoder cut to its rank's shards by
:func:`merv_tpu_torch.parallel.sharding.shard_decoder` carries a
:class:`~merv_tpu_torch.parallel.tensor.TensorShards` (``decoder.tp``, and
each layer's ``tp``) and takes its path on any mesh or none, since its
weights are its rank's: each layer runs its ``num_heads / tp`` query heads
and ``num_kv_heads / tp`` key/value heads (all of them, kept whole on every
rank, where ``num_kv_heads`` does not split; its queries then attend their
group's heads), sums ``o_proj``'s and ``down_proj``'s partial outputs over
the tensor group before each residual add, looks its ids up in its vocab
shard of the embedding, and gathers the head's vocab-split logits to the
whole vocabulary (:mod:`merv_tpu_torch.parallel.tensor`). Its caches
(``KVCache.create(..., tp=decoder.tp)``) hold its key/value heads, and they
compose with the ``sp`` row split (``merv_tpu``'s ``P(None, None, tensor,
sp, None)``). A decoder that is not cut (on a :class:`VirtualMesh`, whose
ranks share one process) runs whole: the replicated layout, the same
function.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from merv_tpu_torch.nn.core import Embed, Linear, RMSNorm
from merv_tpu_torch.nn.quantization import INV_127
from merv_tpu_torch.ops import decode_attention as K5
from merv_tpu_torch.ops.attention import attention
from merv_tpu_torch.parallel.mesh import PIPE_AXIS, SEQ_AXIS, axis_size
from merv_tpu_torch.parallel.sharding import constrain_batch_dim, get_activation_mesh
from merv_tpu_torch.parallel.tensor import TensorShards, embed_lookup, gather_logits, reduce_sum

# the global position of a shard's scratch row: past every key mask's bound
_SCRATCH_POS = 2 ** 62


@dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    attention_bias: bool = False
    tie_word_embeddings: bool = False
    initializer_range: float = 0.02
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # sequence parallelism: taken only under an activation mesh with sp > 1 (see the module's text)
    sequence_parallel: bool = False
    # the load-balanced causal ring (zigzag token layout), where the sequence tiles 2 sp
    sp_zigzag: bool = True
    # GPipe over the mesh's pp axis (see the module's text); 0 micro-batches = min(2 pp, batch)
    pipeline_parallel: bool = False
    pp_microbatches: int = 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclass(frozen=True)
class CacheShards:
    """The layout of a cache sharded on its rows over the ``sp`` axis: each
    rank holds ``rows`` consecutive global positions (rank r from
    ``r * rows``) followed by one scratch row; the buffer holds this
    process's ranks (``ex.ranks``) one after another."""

    ex: Any  # the sp exchange (ops/ring_attention.py)
    rows: int

    @property
    def capacity(self) -> int:
        """Global positions the cache holds."""
        return self.ex.n * self.rows

    @property
    def buffer_rows(self) -> int:
        return len(self.ex.ranks) * (self.rows + 1)

    def slices(self) -> List[slice]:
        """Each local rank's buffer rows, its scratch row included."""
        w = self.rows + 1
        return [slice(i * w, (i + 1) * w) for i in range(len(self.ex.ranks))]

    def positions(self, device) -> torch.Tensor:
        """[buffer_rows] the global position of each buffer row (a scratch row: past every bound)."""
        pos = [torch.cat([torch.arange(self.rows, device=device) + r * self.rows,
                          torch.full((1,), _SCRATCH_POS, device=device)]) for r in self.ex.ranks]
        return torch.cat(pos)

    def targets(self, pos: torch.Tensor) -> List[torch.Tensor]:
        """For each local rank, the buffer row global positions ``pos`` land in: the
        rank's own row where it owns the position, else its scratch row."""
        out = []
        for i, r in enumerate(self.ex.ranks):
            local = pos - r * self.rows
            own = (local >= 0) & (local < self.rows)
            out.append(i * (self.rows + 1) + torch.where(own, local, torch.full_like(local, self.rows)))
        return out

    def copy_rows(self, dst: torch.Tensor, src: torch.Tensor, n: int, dim: int) -> None:
        """Copy global rows [0, n) of a whole (replicated) buffer ``src`` into
        this process's shards of ``dst``, both indexed on ``dim``."""
        for i, r in enumerate(self.ex.ranks):
            lo, hi = r * self.rows, min((r + 1) * self.rows, n)
            if hi > lo:
                base = i * (self.rows + 1)
                dst.narrow(dim, base, hi - lo).copy_(src.narrow(dim, lo, hi - lo))


def cache_shards(cfg: "DecoderConfig", max_len: int, mesh) -> Optional[CacheShards]:
    """The row sharding of a ``max_len``-position cache on ``mesh``: None
    unless ``cfg.sequence_parallel``, an ``sp`` axis above 1 and a length that
    tiles it (``merv_tpu``'s ``_sp_serve_mesh``: otherwise the cache stays whole)."""
    from merv_tpu_torch.ops.ring_attention import sp_exchange

    n = axis_size(mesh, SEQ_AXIS)
    if not cfg.sequence_parallel or n <= 1 or max_len % n != 0:
        return None
    return CacheShards(sp_exchange(mesh), max_len // n)


@dataclass
class KVCache:
    """Preallocated cache for all layers. ``length`` is the write pointer: a
    host int or a 0-d long tensor on the cache's device (shared by every row;
    a 0-d tensor takes T = 1 steps only, as the captured decode step reads and
    advances it there), or a [B] long tensor of per-slot pointers.

    A per-slot cache keeps its LAST buffer row as a scratch row: a write at or
    past it lands there, and no key mask admits it, so a slot whose pointer
    walks past the end (it keeps stepping until the host retires it) neither
    raises, nor asserts on the device, nor wraps. It holds ``max_len - 1``
    positions.

    ``dtype=torch.int8`` stores keys and values quantized per (batch, head,
    position) over D, with fp32 scales ``k_scale`` / ``v_scale``
    ``[L, B, H_kv, max_len, 1]`` created as ones (:func:`_quantize_kv`): decode
    reads the whole cache every step, so halving its bytes trims the per-token
    time; the scales add 4 bytes a row.

    ``sp`` (:class:`CacheShards`): a cache sharded on its rows over the
    ``sp`` axis; its buffers hold this process's shards, each with its own
    scratch row, and ``max_len`` global positions. A tensor-parallel
    decoder's cache holds its rank's key/value heads (``create``'s ``tp``)."""

    k: torch.Tensor  # [L, B, H_kv, max_len, D] (sharded: [L, B, H_kv, sp.buffer_rows, D])
    v: torch.Tensor  # [L, B, H_kv, max_len, D]
    length: Union[int, torch.Tensor]
    k_scale: Optional[torch.Tensor] = None  # [L, B, H_kv, max_len, 1] fp32 (int8 mode)
    v_scale: Optional[torch.Tensor] = None
    sp: Optional[CacheShards] = None

    @classmethod
    def create(
        cls, cfg: DecoderConfig, batch: int, max_len: int, dtype: torch.dtype, device: torch.device, mesh=None,
        tp: Optional[TensorShards] = None,
    ) -> "KVCache":
        """Zeros (int8 scales: ones) for ``max_len`` positions; on ``mesh``,
        sharded on its rows where :func:`cache_shards` says so; for a
        tensor-parallel decoder (``tp``, its ``decoder.tp``), its rank's
        key/value heads."""
        sp = None if mesh is None else cache_shards(cfg, max_len, mesh)
        rows = max_len if sp is None else sp.buffer_rows
        heads = cfg.num_kv_heads if tp is None else tp.kv_heads
        shape = (cfg.num_layers, batch, heads, rows, cfg.head_dim)
        k, v = (torch.zeros(shape, dtype=dtype, device=device) for _ in range(2))
        if dtype != torch.int8:
            return cls(k, v, 0, sp=sp)
        ks, vs = (torch.ones(shape[:-1] + (1,), dtype=torch.float32, device=device) for _ in range(2))
        return cls(k, v, 0, ks, vs, sp)

    @property
    def max_len(self) -> int:
        """Positions the cache holds (its buffer rows, or the sharded cache's global length)."""
        return self.k.shape[3] if self.sp is None else self.sp.capacity

    def at(self, length: Union[int, torch.Tensor]) -> "KVCache":
        """The same buffers (and scales) with write pointer ``length``."""
        return KVCache(self.k, self.v, length, self.k_scale, self.v_scale, self.sp)

    def layer(self, li: int) -> Tuple[Optional[torch.Tensor], ...]:
        """Layer ``li``'s (K, V, K scales, V scales, write pointer, shards); the scales are None unless int8."""
        scales = (None, None) if self.k_scale is None else (self.k_scale[li], self.v_scale[li])
        return (self.k[li], self.v[li], *scales, self.length, self.sp)


def cache_dtype(kv_cache_dtype: Optional[str], compute_dtype: torch.dtype) -> torch.dtype:
    """A generation config's ``kv_cache_dtype`` ("int8", or None for the
    decoder's compute dtype) as the cache's torch dtype."""
    if kv_cache_dtype not in (None, "int8"):
        raise ValueError(f"unsupported kv_cache_dtype {kv_cache_dtype!r}")
    return torch.int8 if kv_cache_dtype == "int8" else compute_dtype


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, H, T, D] float -> (int8 values, [B, H, T, 1] fp32 scales), bit for
    bit ``merv_tpu``'s inside its jitted decoder: per-position ``amax / 127``
    as XLA computes it (times fp32 ``1/127``, see
    :mod:`merv_tpu_torch.nn.quantization`; 1.0 where 0), round half to even,
    clipped to +-127."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax * INV_127, torch.ones_like(amax))
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def require_right_padding(am: torch.Tensor) -> None:
    """Raise unless every row of the [B, T] mask is [1]*n + [0]*pad (the no-cache forward's contract: it takes
    positions from the mask and applies no key mask). Reads a bool back to the host."""
    if not bool((am[:, 1:] <= am[:, :-1]).all()):
        raise ValueError(
            "decoder no-cache forward requires a right-padding prefix attention_mask "
            "([1]*n + [0]*pad per row); other masks would silently attend masked keys"
        )


def _rope(cos_sin: Tuple[torch.Tensor, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Rotary embedding (HF half-split). x [B, H, T, D]; cos/sin [B, T, D]."""
    cos, sin = cos_sin[0][:, None], cos_sin[1][:, None]
    d2 = x.shape[-1] // 2
    rotated = torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)
    return x * cos + rotated * sin


def _rope_tables(cfg: DecoderConfig, positions: torch.Tensor, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for positions [B, T] -> ([B, T, D], [B, T, D])."""
    d2 = cfg.head_dim // 2
    inv_freq = 1.0 / (cfg.rope_theta ** (torch.arange(0, d2, dtype=torch.float32, device=positions.device) / d2))
    freqs = positions[..., None].float() * inv_freq[None, None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _linear(c: DecoderConfig, i: int, o: int, bias: bool, device) -> Linear:
    return Linear(i, o, use_bias=bias, param_dtype=c.param_dtype, device=device, init_std=c.initializer_range)


class _Attn(nn.Module):
    def __init__(self, c: DecoderConfig, device) -> None:
        super().__init__()
        self.cfg = c
        self.q_proj = _linear(c, c.hidden_size, c.q_dim, c.attention_bias, device)
        self.k_proj = _linear(c, c.hidden_size, c.kv_dim, c.attention_bias, device)
        self.v_proj = _linear(c, c.hidden_size, c.kv_dim, c.attention_bias, device)
        self.o_proj = _linear(c, c.q_dim, c.hidden_size, False, device)

    def qkv(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x [B, T, hidden] -> q [B, T, q_dim], k and v [B, T, kv_dim]: one GEMM when packed."""
        c = self.cfg
        if "qkv_proj" in self._modules:
            return self.qkv_proj(x).split([c.q_dim, c.kv_dim, c.kv_dim], dim=-1)
        return self.q_proj(x), self.k_proj(x), self.v_proj(x)


def _heads(t: torch.Tensor, span: Optional[Tuple[int, int]]) -> torch.Tensor:
    """[B, H, ...] -> its heads [lo, hi) (``span``, contiguous), or the tensor as it is."""
    return t if t is None or span is None else t[:, span[0]:span[1]].contiguous()


class _MLP(nn.Module):
    def __init__(self, c: DecoderConfig, device) -> None:
        super().__init__()
        self.gate_proj = _linear(c, c.hidden_size, c.intermediate_size, False, device)
        self.up_proj = _linear(c, c.hidden_size, c.intermediate_size, False, device)
        self.down_proj = _linear(c, c.intermediate_size, c.hidden_size, False, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if "gate_up_proj" in self._modules:
            gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        else:
            gate, up = self.gate_proj(x), self.up_proj(x)
        return self.down_proj(F.silu(gate) * up)


class DecoderLayer(nn.Module):
    def __init__(self, c: DecoderConfig, device=None) -> None:
        super().__init__()
        self.cfg = c
        self.attn = _Attn(c, device)
        self.mlp = _MLP(c, device)
        self.input_norm = RMSNorm(c.hidden_size, eps=c.rms_norm_eps, param_dtype=c.param_dtype, device=device)
        self.post_attn_norm = RMSNorm(c.hidden_size, eps=c.rms_norm_eps, param_dtype=c.param_dtype, device=device)
        self.tp: Optional[TensorShards] = None  # this rank's shards where the decoder is cut (shard_decoder)

    def forward(
        self,
        h: torch.Tensor,
        cos_sin: Tuple[torch.Tensor, torch.Tensor],
        kv_mask: Optional[torch.Tensor],
        cache: Optional[Tuple[Optional[torch.Tensor], ...]],
        attn_impl: str,
        ring: Optional[Tuple[Any, bool]] = None,
    ) -> torch.Tensor:
        """``ring``: (mesh, zigzag) when the no-cache forward runs sequence-parallel."""
        c, tp = self.cfg, self.tp
        B, T, _ = h.shape
        nh, nkv = (c.num_heads, c.num_kv_heads) if tp is None else (tp.num_heads, tp.kv_heads)
        span = None if tp is None else tp.kv_attend  # whole k/v: the heads this rank's queries attend
        q, k, v = self.attn.qkv(self.input_norm(h))
        q = q.view(B, T, nh, c.head_dim).transpose(1, 2)
        k = k.view(B, T, nkv, c.head_dim).transpose(1, 2)
        v = v.view(B, T, nkv, c.head_dim).transpose(1, 2)
        q = _rope(cos_sin, q).contiguous()
        k = _rope(cos_sin, k)
        if cache is None and ring is not None:
            from merv_tpu_torch.ops.ring_attention import ring_attention

            out = ring_attention(q, _heads(k, span).contiguous(), _heads(v, span).contiguous(), ring[0], causal=True,
                                 zigzag=ring[1], impl=attn_impl)
        elif cache is None:
            out = attention(q, _heads(k, span).contiguous(), _heads(v, span).contiguous(), causal=True, impl=attn_impl)
        else:
            # this layer's [B, H_kv, max_len, D] buffers, and [B, H_kv, max_len, 1] scales in int8 mode
            ck, cv, cks, cvs, start, sp = cache
            if cks is not None:  # quantize on write
                (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
            if sp is not None:
                # sharded rows: each local rank writes the positions it owns, the rest to its scratch row
                per_slot = isinstance(start, torch.Tensor) and start.dim() == 1
                pos = (start[:, None] if per_slot else start) + torch.arange(T, device=h.device)
                pos = pos.expand(B, T) if pos.dim() == 2 else pos[None].expand(B, T)
                slot = torch.arange(B, device=h.device)[:, None].expand(B, T)
                targets = sp.targets(pos)

                def put(buf, val):
                    for rows in targets:
                        buf[slot, :, rows] = val.transpose(1, 2).to(buf.dtype)
            elif isinstance(start, torch.Tensor) and start.dim() == 1:
                # per-slot pointers: row b writes at start[b] + t; at or past the scratch row (the last) it
                # writes there, so an out-of-range write is dropped (the scales follow the same rows)
                rows = (start[:, None] + torch.arange(T, device=h.device)).clamp(max=ck.shape[2] - 1)
                slot = torch.arange(B, device=h.device)[:, None].expand(B, T)

                def put(buf, val):
                    buf[slot, :, rows] = val.transpose(1, 2).to(buf.dtype)
            else:
                rows = torch.arange(T, device=h.device) + start

                def put(buf, val):
                    buf.index_copy_(2, rows, val.to(buf.dtype))
            put(ck, k)
            put(cv, v)
            if cks is not None:
                put(cks, ks)
                put(cvs, vs)
            # T = 1: kv_mask already bounds the keys at kv_pos <= start, so the causal mask adds nothing
            causal, q_offset = (False, None) if T == 1 else (True, start)
            ck, cv, cks, cvs = (_heads(t, span) for t in (ck, cv, cks, cvs))
            if sp is not None:
                from merv_tpu_torch.ops.ring_attention import cache_shard_attention

                shards = [tuple(None if t is None else t[:, :, sl] for t in (ck, cv, cks, cvs)) for sl in sp.slices()]
                out = cache_shard_attention(q, shards, [kv_mask[:, sl] for sl in sp.slices()], sp.ex, sp.rows,
                                            causal=causal, q_offset=q_offset, impl=attn_impl)
            elif T <= K5.DECODE_MAX_ROWS:
                fn = K5.decode_attention if attn_impl == "auto" else K5.decode_attention_plain
                out = fn(q, ck, cv, cks, cvs, kv_mask=kv_mask, causal=causal, q_offset=q_offset)
            else:
                if cks is not None:  # dequantize on read: int8 -> fp32, times the scale, one rounding
                    k, v = K5.dequantize_kv(ck, cks, q.dtype), K5.dequantize_kv(cv, cvs, q.dtype)
                else:
                    k, v = ck.to(q.dtype), cv.to(q.dtype)
                out = attention(q, k.contiguous(), v.contiguous(), causal=causal, kv_mask=kv_mask, q_offset=q_offset,
                                impl=attn_impl)
        # tensor parallel: o_proj and down_proj are row-split, their partial outputs summed over the ranks
        h = h + reduce_sum(self.attn.o_proj(out.transpose(1, 2).reshape(B, T, nh * c.head_dim)), tp)
        return h + reduce_sum(self.mlp(self.post_attn_norm(h)), tp)


class ForeignLayer(nn.Module):
    """The place of a decoder layer that another pipeline stage holds: no weights."""

    def forward(self, *args, **kwargs):
        raise RuntimeError("this decoder layer belongs to another pipeline stage")


class LlamaDecoder(nn.Module):
    def __init__(self, cfg: DecoderConfig, device=None) -> None:
        super().__init__()
        c = self.cfg = cfg
        self.embed_tokens = Embed(c.vocab_size, c.hidden_size, param_dtype=c.param_dtype, device=device)
        self.layers = nn.ModuleList([DecoderLayer(c, device) for _ in range(c.num_layers)])
        self.final_norm = RMSNorm(c.hidden_size, eps=c.rms_norm_eps, param_dtype=c.param_dtype, device=device)
        if not c.tie_word_embeddings:
            self.lm_head = _linear(c, c.hidden_size, c.vocab_size, False, device)
        self.tp: Optional[TensorShards] = None  # this rank's shards where the decoder is cut (shard_decoder)

    def embed_input_ids(self, input_ids: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:  # the vocab-split embedding
            return embed_lookup(self.embed_tokens.weight, input_ids, self.tp, self.cfg.compute_dtype)
        return self.embed_tokens(input_ids, dtype=self.cfg.compute_dtype)

    def forward(
        self,
        *,
        input_ids: Optional[torch.Tensor] = None,
        inputs_embeds: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,  # [B, T_kv] valid kv positions
        positions: Optional[torch.Tensor] = None,  # [B, T]
        kv_cache: Optional[KVCache] = None,
        attn_impl: str = "auto",
        logits_indices: Optional[torch.Tensor] = None,  # [B] positions to project
        remat: bool = False,
        return_hidden: bool = False,
    ) -> Tuple[torch.Tensor, Optional[KVCache]]:
        """Causal decoder forward -> (logits, new cache), or (the post-norm
        hidden states, new cache) with ``return_hidden``.

        Without cache, ``attention_mask`` must be a right-padding prefix mask:
        it gives positions only, and no kv mask is applied (causality already
        keeps every valid query off the padded keys). With a cache, the T new
        keys/values are written at ``kv_cache.length`` and attention spans the
        whole buffer with ``kv_pos < length + T`` AND ``attention_mask`` as
        the key mask. A 0-d ``length`` held on the device takes T = 1 only; a
        [B] ``length`` (per-slot pointers) takes any T, with positions
        ``length[b] + arange(T)`` by default and row b's queries causal at
        offset ``length[b]``; neither reads anything back to the host.
        ``remat`` recomputes each layer in the backward instead of keeping its
        activations (no-cache forward only)."""
        c = self.cfg
        if remat and kv_cache is not None:
            raise ValueError(
                "remat=True is not supported with a kv_cache (training never runs a cache; serving never needs remat)"
            )
        if inputs_embeds is None:
            inputs_embeds = self.embed_input_ids(input_ids)
        h = constrain_batch_dim(inputs_embeds.to(c.compute_dtype))  # merv_tpu's batch-axis pin (a no-op here)
        B, T, _ = h.shape
        dev = h.device
        mesh = get_activation_mesh()
        pp_mesh = self._pp_mesh(B) if kv_cache is None else None

        ring = None
        if kv_cache is not None:
            start = kv_cache.length
            sp = kv_cache.sp
            max_len = kv_cache.max_len
            # each buffer row's global position (a sharded cache's scratch rows lie past every bound)
            kv_pos = (torch.arange(max_len, device=dev) if sp is None else sp.positions(dev))[None]
            if isinstance(start, torch.Tensor) and start.dim() == 1:
                if start.shape[0] != B:
                    raise ValueError(f"{start.shape[0]} per-slot write pointers for a batch of {B}")
                start_col = start[:, None]
                kv_mask = kv_pos < start_col + T
                if sp is None:
                    kv_mask = kv_mask & (kv_pos < max_len - 1)  # the last row is scratch
            else:
                if isinstance(start, torch.Tensor):
                    if T != 1:
                        raise ValueError(f"a shared write pointer on the device takes one token a step, got T={T}")
                elif start + T > max_len:
                    raise ValueError(f"KV cache overflow: {start} + {T} > {max_len}")
                start_col = start
                kv_mask = (kv_pos < start_col + T).expand(B, kv_pos.shape[1])
            if positions is None:
                positions = (start_col + torch.arange(T, device=dev)[None]).expand(B, T)
            if attention_mask is not None:
                am = attention_mask.bool()
                if am.shape[1] != max_len:
                    am = torch.cat([am, torch.ones((B, max_len - am.shape[1]), dtype=torch.bool, device=dev)], dim=1)
                if sp is not None:  # the mask of each buffer row's global position
                    am = am[:, kv_pos[0].clamp(max=max_len - 1)]
                kv_mask = kv_mask & am
            kv_mask = kv_mask.contiguous()  # one copy for every layer's attention
        else:
            if positions is None:
                if attention_mask is not None:
                    positions = (attention_mask.long().cumsum(dim=1) - 1).clamp(min=0)
                else:
                    positions = torch.arange(T, device=dev)[None].expand(B, T)
            if attention_mask is not None:
                require_right_padding(attention_mask.bool())
            kv_mask = None
            ex = None if pp_mesh is not None else self._sp_exchange(mesh, T)
            if ex is not None:
                # the zigzag layout once for the whole stack, then this process's rows; positions travel with
                # the tokens, so right padding keeps its pad keys after every valid query
                zigzag = c.sp_zigzag and T % (2 * ex.n) == 0
                if zigzag:
                    from merv_tpu_torch.ops.ring_attention import zigzag_perm

                    zperm = torch.as_tensor(zigzag_perm(T, ex.n), device=dev)
                    h, positions = h[:, zperm], positions.expand(B, T)[:, zperm]
                h, positions = ex.local(h, 1), ex.local(positions.expand(B, T), 1)
                ring = (mesh, zigzag)

        cos_sin = _rope_tables(c, positions, h.dtype)
        remat = remat and torch.is_grad_enabled()
        if pp_mesh is not None:
            from merv_tpu_torch.parallel.pipeline import pipeline_layer_scan, resolve_microbatches

            pp = axis_size(pp_mesh, PIPE_AXIS)
            h = pipeline_layer_scan(
                lambda layer, x, cs: layer(x, cs, None, None, attn_impl), h, cos_sin, self.held_layers(pp_mesh),
                pp_mesh, microbatches=resolve_microbatches(B, pp, c.pp_microbatches), remat=remat,
                num_layers=c.num_layers,
            )
        for li, layer in enumerate(self.layers if pp_mesh is None else ()):
            cache = None if kv_cache is None else kv_cache.layer(li)
            if remat:
                h = checkpoint(layer, h, cos_sin, kv_mask, cache, attn_impl, ring, use_reentrant=False)
            else:
                h = layer(h, cos_sin, kv_mask, cache, attn_impl, ring)
        if ring is not None:
            h = ex.gather(h, 1)
            if ring[1]:
                h = h[:, torch.argsort(zperm)]
        new_cache = None if kv_cache is None else kv_cache.at(kv_cache.length + T)

        h = self.final_norm(h)
        if return_hidden:
            return h, new_cache
        if logits_indices is not None:
            h = h[torch.arange(B, device=dev), logits_indices.long()][:, None]
        return self.lm_head_apply(h), new_cache

    def _pp_mesh(self, batch: int):
        """The activation mesh when the no-cache forward runs GPipe
        (``merv_tpu``'s ``_pp_mesh``): ``pipeline_parallel`` on, a pp axis
        above 1, layers that tile it and a micro-batch count; else None (the
        plain loop). With an sp axis above 1 under ``sequence_parallel`` too,
        ``merv_tpu``'s ValueError."""
        if not self.cfg.pipeline_parallel:
            return None
        from merv_tpu_torch.parallel.pipeline import resolve_microbatches

        mesh = get_activation_mesh()
        pp = axis_size(mesh, PIPE_AXIS)
        if pp <= 1 or self.cfg.num_layers % pp != 0:
            return None
        if resolve_microbatches(batch, pp, self.cfg.pp_microbatches) is None:
            return None
        if self.cfg.sequence_parallel and axis_size(mesh, SEQ_AXIS) > 1:
            raise ValueError(
                "pipeline_parallel and sequence_parallel cannot both be active "
                "on one mesh (pp>1 and sp>1): the GPipe shard_map cannot nest "
                "the sp ring shard_map. Pick one per run."
            )
        return mesh

    def stage_layers(self, pp: int, stage: int) -> range:
        """The layer indices pipeline stage ``stage`` of ``pp`` holds."""
        per = self.cfg.num_layers // pp
        return range(stage * per, (stage + 1) * per)

    def keep_stage(self, pp: int, stage: int) -> "LlamaDecoder":
        """Keep only stage ``stage``'s layers (of ``pp``); the others become
        :class:`ForeignLayer` placeholders and their weights are freed."""
        if self.cfg.num_layers % pp != 0:
            raise ValueError(f"num_layers {self.cfg.num_layers} not divisible by pp={pp}")
        mine = self.stage_layers(pp, stage)
        for i in range(self.cfg.num_layers):
            if i not in mine:
                self.layers[i] = ForeignLayer()
        return self

    def held_layers(self, mesh) -> List[nn.Module]:
        """The layers this process runs in the pipeline: all of them on a
        virtual mesh, its stage's on a device mesh."""
        from merv_tpu_torch.parallel.mesh import VirtualMesh, axis_rank

        if isinstance(mesh, VirtualMesh):
            return list(self.layers)
        layers = [self.layers[i] for i in self.stage_layers(axis_size(mesh, PIPE_AXIS), axis_rank(mesh, PIPE_AXIS))]
        if any(isinstance(layer, ForeignLayer) for layer in layers):
            raise RuntimeError("this rank does not hold its pipeline stage's layers")
        return layers

    def _sp_exchange(self, mesh, seq_len: int):
        """The sp exchange when the no-cache forward runs the ring (``merv_tpu``'s
        ``_sp_mesh``): ``sequence_parallel`` on, an sp axis above 1 and a
        sequence that tiles it; else None (plain attention)."""
        from merv_tpu_torch.ops.ring_attention import sp_exchange

        n = axis_size(mesh, SEQ_AXIS)
        if not self.cfg.sequence_parallel or n <= 1 or seq_len % n != 0:
            return None
        return sp_exchange(mesh)

    def lm_head_apply(self, h: torch.Tensor) -> torch.Tensor:
        """The head's logits over the whole vocabulary (a tensor-parallel
        decoder's vocab-split logits gathered; a tied head uses the
        embedding's shard)."""
        if self.cfg.tie_word_embeddings:
            return gather_logits(h @ self.embed_tokens.weight.to(h.dtype).T, self.tp)
        return gather_logits(self.lm_head(h), self.tp)


def _packed_linear(parts) -> Linear:
    """One Linear whose output columns are ``parts``' outputs in order (their
    weights and biases concatenated on the output dimension)."""
    w = parts[0].weight
    out = Linear(parts[0].in_dim, sum(p.out_dim for p in parts), use_bias=parts[0].bias is not None,
                 param_dtype=w.dtype, device=w.device)
    with torch.no_grad():
        torch.cat([p.weight for p in parts], dim=0, out=out.weight)
        if out.bias is not None:
            torch.cat([p.bias for p in parts], dim=0, out=out.bias)
    return out


def pack_serving_params(decoder: LlamaDecoder) -> LlamaDecoder:
    """``merv_tpu``'s ``pack_serving_params`` on a module, in place: in every
    layer, q/k/v become one ``attn.qkv_proj`` and gate/up one
    ``mlp.gate_up_proj``, so a step runs 4 Linears a layer where it ran 7.
    Float weights only (pack, then quantize, as ``merv_tpu``'s ``load_vid``
    does); a layer's parts are freed as its packed copy is made. Every output
    column keeps its weights, so the numbers change only by the order in which
    a wide and a narrow GEMM sum. Training keeps the unpacked layers: its
    optimizer states key on them, as ``merv_tpu``'s do."""
    from merv_tpu_torch.models.generation import release_decode_runners

    release_decode_runners(decoder)  # a captured step would keep reading the parts
    for layer in decoder.layers:
        a, m = layer.attn, layer.mlp
        if "qkv_proj" in a._modules:
            continue
        if a.q_proj.weight is None or m.gate_proj.weight is None:
            raise ValueError("pack_serving_params: pack the float weights, then quantize")
        a.qkv_proj = _packed_linear([a.q_proj, a.k_proj, a.v_proj])
        del a.q_proj, a.k_proj, a.v_proj
        m.gate_up_proj = _packed_linear([m.gate_proj, m.up_proj])
        del m.gate_proj, m.up_proj
    return decoder


def round_to_compute_dtype(decoder: LlamaDecoder) -> LlamaDecoder:
    """Every float parameter (weights, biases, norms, the embedding) rounded
    once to the compute dtype, in place; int8 weights and their fp32 scales
    (buffers) stay as they are. Each such parameter reaches the model only
    through a cast to the compute dtype (``Linear``, ``RMSNorm``, ``Embed``,
    the tied head), so the numbers are bit for bit those of the stored dtype,
    while a step no longer makes a compute-dtype copy of every weight it reads
    (fp16 storage, Qwen-2.5's, under bf16 compute)."""
    from merv_tpu_torch.models.generation import release_decode_runners

    release_decode_runners(decoder)  # a captured step would keep reading the replaced tensors
    dtype = decoder.cfg.compute_dtype
    with torch.no_grad():
        for p in decoder.parameters():
            if p.is_floating_point() and p.dtype != dtype:
                p.data = p.data.to(dtype)
    return decoder


# Registered decoder configs, with merv_tpu's values (HF config parity for weight import)
LLAMA2_7B = DecoderConfig(
    vocab_size=32064,  # 32000 + <PAD> resized to a multiple of 64
    hidden_size=4096, intermediate_size=11008, num_layers=32,
    num_heads=32, num_kv_heads=32, head_dim=128,
    max_position_embeddings=4096, rope_theta=10000.0, rms_norm_eps=1e-5,
)

LLAMA2_13B = DecoderConfig(
    vocab_size=32064,
    hidden_size=5120, intermediate_size=13824, num_layers=40,
    num_heads=40, num_kv_heads=40, head_dim=128,
    max_position_embeddings=4096, rope_theta=10000.0, rms_norm_eps=1e-5,
)

LLAMA3_8B = DecoderConfig(
    vocab_size=128320,  # 128256 + <PAD> resized to a multiple of 64
    hidden_size=4096, intermediate_size=14336, num_layers=32,
    num_heads=32, num_kv_heads=8, head_dim=128,
    max_position_embeddings=8192, rope_theta=500000.0, rms_norm_eps=1e-5,
)

LLAMA31_8B = dataclasses.replace(LLAMA3_8B, vocab_size=128256, max_position_embeddings=131072)

QWEN25_7B = DecoderConfig(
    vocab_size=152064,
    hidden_size=3584, intermediate_size=18944, num_layers=28,
    num_heads=28, num_kv_heads=4, head_dim=128,
    max_position_embeddings=32768, rope_theta=1000000.0, rms_norm_eps=1e-6,
    attention_bias=True,
)

QWEN25_3B = DecoderConfig(
    vocab_size=151936,
    hidden_size=2048, intermediate_size=11008, num_layers=36,
    num_heads=16, num_kv_heads=2, head_dim=128,
    max_position_embeddings=32768, rope_theta=1000000.0, rms_norm_eps=1e-6,
    attention_bias=True, tie_word_embeddings=True,
)


def tiny_decoder_config(**overrides) -> DecoderConfig:
    base = dict(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16, max_position_embeddings=512,
    )
    base.update(overrides)
    return DecoderConfig(**base)
