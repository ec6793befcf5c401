"""Continuous-batching serving engine with per-slot KV-cache pointers
(counterpart of ``merv_tpu/serving/engine.py``).

A fixed pool of decode slots stays live, where a group-synchronous loop pads
a batch to its longest prompt and decodes until every row is done:

- each slot owns one row of a shared cache whose ``length`` is a **[B]
  tensor** of per-slot write pointers (``transformer.py::KVCache``); a
  sequence occupies rows ``[0, length[b])`` of its row, so admission never
  re-lays-out memory;
- a new request prefills on its own or batched with others of its length
  bucket (prompt lengths pad to static buckets), and its small cache is
  copied into a free slot (:func:`_insert_into_slot`);
- decode runs ``steps_per_sync`` tokens for all slots as one program
  (:func:`_decode_chunk`, or :func:`_decode_chunk_spec` when speculating);
  the host syncs once per chunk to emit tokens, retire finished slots and
  admit queued requests into the freed rows;
- admission is asynchronous by default: prefill, slot insert and the next
  chunk are queued back to back, and the first sampled token is read at the
  next chunk's sync.

Decode as one program. ``merv_tpu`` compiles a chunk as one ``lax.scan``.
Here a chunk is a function of tensors the engine owns at fixed addresses
(:class:`_DecodeState`: the slot cache, ``length``, ``last_tok``, ``done``,
the draft history) and of its output window; it reads nothing back to the
host. On a CUDA device it is captured once per (slots, cache rows, config,
``steps_per_sync``, gamma) as a CUDA graph (:class:`_Chunk`) and replayed;
on the CPU the same function runs eagerly, which is its plain form. Admission
writes the captured tensors in place (a reassignment would leave the graphs
on stale storage). The two-way speculation monitor switches gamma among 2, 4
and 8 and plain decode, so at most ``MAX_CHUNK_GRAPHS`` chunk graphs stay
alive, least recently used evicted first.

The slot cache is in the compute dtype, or in int8 with per-position fp32
scales (``config.kv_cache_dtype == "int8"``), which follow the same rows and
the same scratch-row rule. Every chunk graph runs K5 (``decode_attention``)
on the slot cache as it lies and, with int8 weights, K4 (``int8_linear``); a
replay calls no wrapper, so :meth:`_Chunk.run` adds the launches the capture
recorded to the kernels' counts.

Sequence-parallel serving (``mesh`` with an ``sp`` axis above 1 and the
decoder's ``sequence_parallel``, ``merv_tpu``'s sp mode): every rank runs the
same engine on the same requests. The slot cache's rows are rounded up to a
multiple of sp and sharded on the rows (``CacheShards``: each rank its share
and a scratch row); per-slot pointers, tokens and the draft history are
replicated; an admission prefill stays whole on every rank and each rank
copies the rows it owns into the slot. Each step merges the ranks' attention
partials by all-reduces, so the chunk is captured only where the exchange can
be (NCCL; gloo's collectives run eagerly). Only rank 0 returns results and
calls ``result_callback``.

Tensor-parallel serving (a decoder cut by ``load_vid`` on a mesh with a
``tensor`` axis above 1, ``merv_tpu``'s Megatron splits): the slot cache
holds the rank's key/value heads (``KVCache.create(..., tp=)``: split where
``num_kv_heads`` tiles the axis, whole otherwise, as ``merv_tpu``'s
``P(None, None, tensor, sp, None)``, composing with the sp row split), and so
does a registered prefix, which the decoder prefills head-split. Every rank
runs the same requests (its sums and gathers give every rank the same logits
and tokens; the verify step included), and rank 0 returns the results. The
chunk is captured where the collectives can be (NCCL), and runs eagerly
under gloo. Under a ``pp`` axis the engine serves the plain cached loop on
whole weights, as ``merv_tpu``'s does.
"""

from __future__ import annotations

import inspect
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

import merv_tpu_torch.ops.attention as A
from merv_tpu_torch.models.backbones.llm.transformer import CacheShards, KVCache, LlamaDecoder, cache_dtype
from merv_tpu_torch.models.generation import (
    GenerationConfig,
    VideoPrefix,
    _ban_eos_below_min_length,
    _capture_stream,
    _capturing,
    _filter_logits,
    _graph_capturable,
    _ngram_propose,
    _sample_token,
    _spec_accept,
    prefill,
    prefill_with_prefix,
)
from merv_tpu_torch.overwatch import initialize_overwatch
from merv_tpu_torch.parallel.mesh import SEQ_AXIS, axis_size, world
from merv_tpu_torch.tracing import event, span

overwatch = initialize_overwatch(__name__)

# chunk graphs kept alive per engine: plain decode and the three gammas the monitor picks from
MAX_CHUNK_GRAPHS = 4


@dataclass
class Request:
    """One generation request. Provide ``input_ids`` (already tokenized) for
    LLM-level engines, or ``prompt_text`` (+ optional ``video``) for VidLM
    engines, which tokenize and preprocess through the model's own pipeline."""

    request_id: str
    input_ids: Optional[np.ndarray] = None  # [T] int
    prompt_text: Optional[str] = None
    video: Optional[Any] = None  # path / frame array; None = unimodal
    max_new_tokens: int = 128
    # name of a prefix registered with ``engine.register_prefix`` /
    # ``engine.register_prefix_video``: admission then prefills only the
    # suffix (``input_ids`` post-BOS at LLM level; ``prompt_text`` whose BOS
    # is checked against the prefix's at VidLM level) against the shared
    # prefix KV, so the towers and the prefix prefill serve many requests
    prefix_id: Optional[str] = None


@dataclass
class RequestResult:
    request_id: str
    token_ids: np.ndarray  # [max_new_tokens], pad after EOS (generate()'s layout)
    finish_reason: str  # "eos" | "budget" | "error"
    error: Optional[str] = None  # "<ExcType>: <message>" when finish_reason == "error"


@dataclass
class EngineStats:
    prefills: int = 0
    decode_chunks: int = 0
    decode_steps: int = 0
    slot_steps_active: int = 0  # slot-steps spent on live requests
    slot_steps_idle: int = 0  # slot-steps spent on empty or finished slots
    prefill_buckets: List[int] = field(default_factory=list)  # distinct post-fusion program buckets
    # one entry per admission: its pre-fusion (true prompt-length) bucket, the
    # distribution that length_bucket tuning reads
    admit_buckets: List[int] = field(default_factory=list)
    spec_steps: int = 0  # verify forwards run for live slots (speculative mode)
    spec_emitted: int = 0  # tokens those forwards produced (>= spec_steps)
    spec_disables: int = 0  # the monitor fell back to plain decode (below break-even)
    spec_reenables: int = 0  # the monitor re-enabled (trailing estimate recovered)
    prefetch_hits: int = 0  # admissions whose host prep overlapped a decode chunk
    errors: int = 0  # requests that failed (corrupt media / over-budget / prep error)
    # time to first token by request id: submit() -> the first sampled token on
    # the host (at placement when blocking, at the next chunk's sync when async)
    ttft_s: Dict[str, float] = field(default_factory=dict)
    batched_admissions: int = 0  # admissions that shared a prefill program with others
    prefix_admissions: int = 0  # admissions served suffix-only off a shared prefix
    admit_s: float = 0.0  # host wall time inside _admit (prefill stall: decode waits)
    decode_s: float = 0.0  # host wall time inside decode chunks (with the sync and any capture)
    suffix_prefills: int = 0  # of ``prefills``, the suffix-only programs (the rest ran a full prompt)
    capture_s: float = 0.0  # time spent capturing chunk graphs (inside decode_s)
    # decoder forwards the chunks ran (steps_per_sync a chunk run, and as many in each capture's warm-up)
    decode_forwards: int = 0
    # (rows, length) of each LLM prefill program, full and suffix-only: its Linears see rows x length rows of x
    prefill_shapes: List[Tuple[int, int]] = field(default_factory=list)
    prefix_rows: List[int] = field(default_factory=list)  # rows of each prefix registered

    @property
    def slot_utilization(self) -> float:
        total = self.slot_steps_active + self.slot_steps_idle
        return self.slot_steps_active / total if total else 0.0

    @property
    def prefill_stall_share(self) -> float:
        """Share of serving wall time the host spent inside admission (host
        prep the prefetcher did not hide, dispatch, and, with
        ``async_admission=False``, the blocking prefill readback). Under async
        admission the prefill's device time lands in ``decode_s``."""
        total = self.admit_s + self.decode_s
        return self.admit_s / total if total else 0.0

    @property
    def tokens_per_step(self) -> float:
        """Mean tokens per verify step (the speculative speed-up's proxy)."""
        return self.spec_emitted / self.spec_steps if self.spec_steps else 1.0


@dataclass
class _Slot:
    request: Optional[Request] = None
    emitted: List[int] = field(default_factory=list)
    done: bool = True  # no occupant
    # host mirror of the draft corpus (prompt ids), kept whenever the engine
    # can speculate, so that the monitor can estimate n-gram acceptance from
    # the plain-decode stream while speculation is off and rebuild the device
    # history on re-enable
    prompt_ids: Optional[List[int]] = None
    est_pos: int = 0  # next history index the acceptance estimator reads
    # async admission: (device first-token tensor [n], row) not read yet;
    # resolved at the next chunk's sync
    pending_first: Optional[Tuple[torch.Tensor, int]] = None


# Verify-chunk cost relative to a plain chunk, per step, at 4 slots of merv-full
# (Llama-2-7B, bf16, 32 layers) with a full-length cache of 2,058 rows, both
# replayed as CUDA graphs: plain 19.507 ms, gamma=2 23.953 ms, gamma=4 24.073 ms,
# gamma=8 25.690 ms (chip_smoke.py phase 4e; NVIDIA H100 80GB HBM3, 700.00 W).
# The verify program is static, so the ratio does not depend on acceptance; the
# monitor picks gamma = argmax est_tokens_per_step(g) / cost(g).
_SPEC_COST_RATIO = {2: 1.228, 4: 1.234, 8: 1.317}


def _spec_cost_ratio(gamma: int) -> float:
    """Interpolate / extrapolate the measured verify-cost table for other gammas."""
    if gamma in _SPEC_COST_RATIO:
        return _SPEC_COST_RATIO[gamma]
    xs = sorted(_SPEC_COST_RATIO)
    if gamma <= xs[0]:
        return _SPEC_COST_RATIO[xs[0]]
    for lo, hi in zip(xs, xs[1:]):
        if gamma <= hi:
            f = (gamma - lo) / (hi - lo)
            return _SPEC_COST_RATIO[lo] + f * (_SPEC_COST_RATIO[hi] - _SPEC_COST_RATIO[lo])
    # beyond the table: extend the last measured slope
    slope = (_SPEC_COST_RATIO[xs[-1]] - _SPEC_COST_RATIO[xs[-2]]) / (xs[-1] - xs[-2])
    return _SPEC_COST_RATIO[xs[-1]] + slope * (gamma - xs[-1])


def _ngram_propose_host(h: List[int], gamma: int, ngram: int, pad_id: int) -> List[int]:
    """Host mirror of :func:`merv_tpu_torch.models.generation._ngram_propose`
    (the same cascade: the most recent strictly-previous occurrence of the
    longest matching suffix wins; what followed it is the draft). Used only by
    the acceptance estimator, never on the decode path."""
    L = len(h)
    for n in range(min(ngram, L - 1), 0, -1):
        key = h[L - n :]
        for s in range(L - n - 1, -1, -1):
            if h[s : s + n] == key:
                d = h[s + n : s + n + gamma]
                return d + [pad_id] * (gamma - len(d))
    return [pad_id] * gamma


def _sim_spec_steps(h: List[int], start: int, gamma: int, ngram: int, pad_id: int) -> Tuple[int, int]:
    """Simulate prompt-lookup speculation over an already-emitted greedy
    stream: at each virtual verify step the drafter sees ``h[:i]`` and the
    actual continuation ``h[i:]`` decides acceptance. Greedy acceptance is
    exact-match, so the plain-decode stream is the counterfactual speculative
    stream: the estimate is unbiased and costs no device time. Returns
    (virtual verify steps, tokens those steps would have emitted)."""
    steps = emitted = 0
    i = max(start, ngram + 1)
    L = len(h)
    while i < L:
        draft = _ngram_propose_host(h[:i], gamma, ngram, pad_id)
        k = 0
        while k < gamma and i + k < L and draft[k] == h[i + k]:
            k += 1
        steps += 1
        emitted += min(k + 1, L - i)
        i += k + 1
    return steps, emitted


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _cache_gib(cache: KVCache) -> float:
    return sum(t.numel() * t.element_size() for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)
               if t is not None) / 2**30


# ---------------------------------------------------------------------------
# Device functions
# ---------------------------------------------------------------------------


@dataclass
class _DecodeState:
    """The tensors every chunk graph is captured over, at fixed addresses for
    the engine's lifetime. The cache ``[L, slots, H_kv, rows, D]`` keeps its
    last row as the per-slot path's scratch row."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor  # [slots] long: per-slot write pointers
    last_tok: torch.Tensor  # [slots] long
    done: torch.Tensor  # [slots] bool, set by the host before each chunk
    hist: Optional[torch.Tensor] = None  # [slots, Hc] long: per-slot draft corpus (speculation-capable engines)
    hist_len: Optional[torch.Tensor] = None  # [slots] long
    k_scale: Optional[torch.Tensor] = None  # [L, slots, H_kv, rows, 1] fp32 (int8 cache)
    v_scale: Optional[torch.Tensor] = None
    sp: Optional[CacheShards] = None  # the row sharding of a sequence-parallel engine's cache

    def cache(self, length: torch.Tensor) -> KVCache:
        return KVCache(self.k, self.v, length, self.k_scale, self.v_scale, self.sp)

    @property
    def capacity(self) -> int:
        """Positions a slot holds: the rows but the scratch row, or the sharded cache's global length."""
        return self.k.shape[3] - 1 if self.sp is None else self.sp.capacity

    def snapshot(self) -> Dict[str, torch.Tensor]:
        """Copies of everything but the cache (a chunk writes cache rows only
        at and past each slot's pointer, which no key mask admits until they
        are written again in order)."""
        names = ("length", "last_tok", "done", "hist", "hist_len")
        return {n: getattr(self, n).clone() for n in names if getattr(self, n) is not None}

    @torch.inference_mode()
    def restore(self, snap: Dict[str, torch.Tensor]) -> None:
        for name, t in snap.items():
            getattr(self, name).copy_(t)


@torch.inference_mode()
def _insert_into_slot(st: _DecodeState, small: Tuple[torch.Tensor, ...], row: int, slot: int,
                      n_valid: torch.Tensor, first: torch.Tensor) -> None:
    """Copy row ``row`` of a freshly prefilled cache ``small`` ([L, n, H, Tb, D]
    K and V, and their [L, n, H, Tb, 1] scales or None) into slot ``slot`` of
    the shared cache from row 0, and set the slot's pointer to ``n_valid[row]``
    and its last token to ``first[row]``, all in place and on the device.
    Stale rows past ``n_valid`` from an earlier occupant stay but are dead: the
    key masks never read past ``length[b]``, and decode overwrites them in
    order."""
    n = min(small[0].shape[3], st.capacity)  # rows past the real ones hold padding only
    for dst, src in zip((st.k, st.v, st.k_scale, st.v_scale), small):
        if dst is None:
            continue
        if st.sp is None:
            dst[:, slot, :, :n].copy_(src[:, row, :, :n])
        else:  # each rank copies the rows it owns
            st.sp.copy_rows(dst[:, slot], src[:, row], n, 2)
    st.length[slot : slot + 1].copy_(n_valid[row : row + 1])
    st.last_tok[slot : slot + 1].copy_(first[row : row + 1])


def _decode_chunk(decoder: LlamaDecoder, st: _DecodeState, cfg: GenerationConfig, num_steps: int,
                  generator: Optional[torch.Generator], toks: torch.Tensor) -> None:
    """Advance every slot ``num_steps`` tokens, in place on ``st``; ``toks``
    [num_steps, slots] receives the tokens. Finished or empty slots
    (``done``) still flow through the batched matmuls, but their pointers
    freeze, they emit ``pad_token_id``, and their cache row only overwrites
    its own dead position. Reads nothing back to the host."""
    pad = torch.full_like(st.last_tok, cfg.pad_token_id)
    for i in range(num_steps):
        logits, _ = decoder(input_ids=st.last_tok[:, None], kv_cache=st.cache(st.length))
        lg = _ban_eos_below_min_length(logits[:, 0].float(), st.length + 1, cfg)
        nxt = torch.where(st.done, pad, _sample_token(lg, cfg, generator))
        # finished slots' pointers freeze, so that they never walk off their row
        st.length.copy_(torch.where(st.done, st.length, st.length + 1))
        st.done |= nxt == cfg.eos_token_id
        st.last_tok.copy_(nxt)
        toks[i].copy_(nxt)


def _decode_chunk_spec(decoder: LlamaDecoder, st: _DecodeState, cfg: GenerationConfig, num_steps: int, gamma: int,
                       ngram: int, generator: Optional[torch.Generator], wins: torch.Tensor,
                       emits: torch.Tensor) -> None:
    """Batched speculative decode, in place on ``st``: every step drafts
    ``gamma`` tokens per slot from that slot's own history and verifies all
    slots' drafts in one ``[slots, gamma+1]`` forward (per-slot causal
    offsets, K5 on the slot cache); each slot's pointer advances by its own
    accepted count. Greedy acceptance is exact-match; sampled acceptance is
    rejection sampling (:func:`_spec_accept`). ``wins`` [num_steps, slots,
    gamma+1] and ``emits`` [num_steps, slots] receive each step's token
    windows and emit counts. Reads nothing back to the host."""
    dev = st.length.device
    B = st.length.shape[0]
    steps_v = torch.arange(gamma + 1, device=dev)
    max_rows = st.capacity  # the real rows: the scratch rows hold no position
    hc = st.hist.shape[1]
    for i in range(num_steps):
        draft = _ngram_propose(st.hist, st.hist_len, gamma, ngram, cfg.pad_token_id)  # [B, gamma]
        old_len = st.length.clone()
        logits, _ = decoder(input_ids=torch.cat([st.last_tok[:, None], draft], dim=1),
                            kv_cache=st.cache(old_len))
        V = logits.shape[-1]
        cur_len = (old_len[:, None] + 1 + steps_v[None]).reshape(-1)
        lg = _ban_eos_below_min_length(logits.float().reshape(B * (gamma + 1), V), cur_len, cfg)
        lg = lg.reshape(B, gamma + 1, V)
        if cfg.do_sample:
            y, emit_n = _spec_accept(torch.softmax(_filter_logits(lg, cfg), dim=-1), draft, generator,
                                     cfg.pad_token_id)
        else:
            y = lg.argmax(dim=-1)  # [B, gamma+1]
            emit_n = (draft == y[:, :gamma]).long().cumprod(dim=1).sum(dim=1) + 1  # leading accepted drafts + 1
        is_eos = (y == cfg.eos_token_id) & (steps_v[None] < emit_n[:, None])
        has_eos = is_eos.any(dim=1)
        emit_n = torch.where(has_eos, is_eos.to(torch.uint8).argmax(dim=1) + 1, emit_n)
        # frozen slots: finished, or a pointer about to walk off the buffer (the
        # host retires over-budget slots at the next sync; admission bounds
        # prompt + budget <= max_len, so a freeze means the budget is served)
        frozen = st.done | (old_len + gamma + 1 > max_rows)
        emit_n = torch.where(frozen, torch.zeros_like(emit_n), emit_n)
        window = torch.where(steps_v[None] < emit_n[:, None], y, torch.full_like(y, cfg.pad_token_id))
        st.length.copy_(torch.where(frozen, old_len, old_len + emit_n))
        nxt = window.gather(1, (emit_n - 1).clamp(min=0)[:, None])[:, 0]
        st.last_tok.copy_(torch.where(frozen, st.last_tok, nxt))
        st.done |= ~frozen & has_eos
        # merv_tpu's dynamic_update_slice clamps the start so that the window fits
        start = st.hist_len.clamp(max=hc - gamma - 1)
        st.hist.scatter_(1, start[:, None] + steps_v[None], window)
        st.hist_len += emit_n
        wins[i].copy_(window)
        emits[i].copy_(emit_n)


@torch.inference_mode()
def _prefix_suffix_prefill(decoder: LlamaDecoder, cfg: GenerationConfig, prefix_kv: KVCache,
                           suffix_ids: torch.Tensor, suffix_mask: torch.Tensor,
                           generator: Optional[torch.Generator]) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor,
                                                                          torch.Tensor]:
    """Suffix-only prefill against a shared prefix cache (B=1, exactly P rows)
    -> ([L, n, H, P+Tb, D] K and V whose rows each hold [prefix | suffix_b],
    first token [n], total valid rows P + n_valid [n]).

    The prefix-caching admission path: a request naming a registered prefix
    pays only its question suffix; the towers and the P-token prefix prefill
    serve every request on the same video. Several admissions of one (prefix,
    bucket) prefill together. Positions are offset by P, the key mask spans
    the whole cache, and the last valid suffix row gives the first token
    (:func:`~merv_tpu_torch.models.generation.prefill_with_prefix`, K2 at
    ``q_offset = P`` on the card)."""
    logits, cache, total, _ = prefill_with_prefix(decoder, prefix_kv, suffix_ids, suffix_mask, decode_rows=0)
    first = _sample_token(_ban_eos_below_min_length(logits, total, cfg), cfg, generator)
    return (cache.k, cache.v, cache.k_scale, cache.v_scale), first, total


@torch.inference_mode()
def _llm_prefill(decoder: LlamaDecoder, cfg: GenerationConfig, input_ids: torch.Tensor,
                 attention_mask: torch.Tensor,
                 generator: Optional[torch.Generator]) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]:
    """Prompt prefill -> ([L, n, H, Tb, D] K and V, first token [n], n_valid
    [n]): :func:`~merv_tpu_torch.models.generation.generate`'s prefill
    (positions from the mask's cumsum, the last valid row's logits, the
    min-length EOS ban). Several pending admissions of one length bucket
    prefill together: the weights stream once for all of them."""
    logits, cache, n_valid = prefill(decoder, decoder.embed_input_ids(input_ids), attention_mask,
                                     input_ids.shape[1], kv_cache_dtype=cfg.kv_cache_dtype)
    first = _sample_token(_ban_eos_below_min_length(logits, n_valid, cfg), cfg, generator)
    return (cache.k, cache.v, cache.k_scale, cache.v_scale), first, n_valid


class _Chunk:
    """One decode chunk program (plain decode, ``gamma == 0``, or the verify
    at ``gamma``) over the engine's :class:`_DecodeState`: its output window,
    its own generator and, on a CUDA device, the chunk captured as one CUDA
    graph. The graph's memory pool holds the chunk's activations (``pool_bytes``,
    measured at capture); the cache and the state belong to the engine."""

    def __init__(self, engine: "ContinuousBatchingEngine", gamma: int, seed: int) -> None:
        K, S, dev, pad = engine.steps_per_sync, engine.num_slots, engine.device, engine.config.pad_token_id
        self.gamma = gamma
        if gamma:
            self.wins = torch.full((K, S, gamma + 1), pad, dtype=torch.long, device=dev)
            self.emits = torch.zeros((K, S), dtype=torch.long, device=dev)
        else:
            self.toks = torch.full((K, S), pad, dtype=torch.long, device=dev)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches_per_run: Dict[str, int] = {}  # kernel launches one replay makes
        self.capture_s = 0.0
        self.pool_bytes = 0

    @torch.inference_mode()
    def run_eager(self, engine: "ContinuousBatchingEngine") -> None:
        """The chunk function itself: on the CPU the only form, on the card the
        graph's plain version."""
        if self.gamma:
            _decode_chunk_spec(engine.decoder, engine._state, engine.config, engine.steps_per_sync, self.gamma,
                               engine.spec_ngram, self.generator, self.wins, self.emits)
        else:
            _decode_chunk(engine.decoder, engine._state, engine.config, engine.steps_per_sync, self.generator,
                          self.toks)

    def run(self, engine: "ContinuousBatchingEngine") -> None:
        if self.graph is not None:
            self.graph.replay()
            A.add_launch_counts(self.launches_per_run)
        else:
            self.run_eager(engine)
        engine.stats.decode_forwards += engine.steps_per_sync

    def capture(self, engine: "ContinuousBatchingEngine") -> None:
        """Capture the chunk as a CUDA graph, after one warm-up run on a side
        stream. The warm-up writes cache rows only at and past each slot's
        pointer, which no key mask admits before they are written again; the
        state it advances and the generator's state are restored, so a capture
        in the middle of serving changes nothing. A capture that fails raises."""
        register = getattr(torch.cuda.CUDAGraph, "register_generator_state", None)
        if engine.config.do_sample and register is None:
            raise RuntimeError("this torch cannot register a custom generator with a CUDA graph: no sampled decode")
        t0 = time.perf_counter()
        dev = engine.device
        st = engine._state
        snap, gen_state = st.snapshot(), self.generator.get_state()
        side = _capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.run_eager(engine)
        engine.stats.decode_forwards += engine.steps_per_sync
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        st.restore(snap)
        self.generator.set_state(gen_state)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()  # as the capture's own entry does, so that the pool's growth is what remains
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        if engine.config.do_sample:
            graph.register_generator_state(self.generator)
        counted = A.launch_counts()
        with _capturing(graph, side):
            self.run_eager(engine)
        torch.cuda.synchronize(dev)
        # the capture recorded these launches; each replay makes them
        self.launches_per_run = A.launches_since(counted)
        A.add_launch_counts({k: -n for k, n in self.launches_per_run.items()})
        self.graph = graph
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_s = time.perf_counter() - t0

    def release(self) -> None:
        if self.graph is not None:
            self.graph.reset()
        self.graph = None


class ContinuousBatchingEngine:
    """Slot-based continuous batching over a :class:`LlamaDecoder` (or a whole
    MERV through :meth:`for_vidlm`). Submit requests, then :meth:`run`.

    One generation config and one decode program serve every request; the
    per-request knobs are prompt, media and ``max_new_tokens``. ``max_len``
    bounds prompt + output per slot; admission fails a request that cannot
    fit. The engine runs on the decoder's device.

    ``speculative_gamma > 0`` turns every decode step into a batched
    prompt-lookup verify: each slot drafts gamma tokens from its own history
    and one ``[slots, gamma+1]`` forward verifies them all; per-slot
    acceptance advances per-slot pointers independently
    (``stats.tokens_per_step`` reports the realized speed-up). Greedy
    acceptance is exact-match; sampling uses rejection acceptance.

    Host-side request preparation (video decode, tokenization) for the head of
    the queue overlaps the chunk the device is running (``_start_prefetch``).

    **Prefix caching** (:meth:`register_prefix`, ``register_prefix_video``):
    requests naming a registered shared prefix (the ``[BOS | visual]`` KV of
    a video) admit suffix-only.

    ``rng`` is a ``torch.Generator`` on the decoder's device (default: one
    seeded 0); it draws the prefills' first tokens and seeds each chunk's own
    generator. ``config.kv_cache_dtype == "int8"`` keeps the slot cache in
    int8 with per-position scales. ``mesh``: sequence- and tensor-parallel
    serving (see the module's text).
    """

    def __init__(
        self,
        decoder: LlamaDecoder,
        *,
        slots: int = 4,
        max_len: int = 1024,
        steps_per_sync: int = 8,
        config: GenerationConfig = GenerationConfig(),
        length_bucket: int = 64,
        prefill_fn: Optional[Callable[..., Tuple]] = None,
        rng: Optional[torch.Generator] = None,
        speculative_gamma: int = 0,
        speculative_ngram: int = 2,
        speculative_break_even: float = 1.2,
        speculative_autodisable: bool = True,
        batch_admissions: bool = True,
        fuse_admission_buckets: bool = True,
        fuse_max_bucket: int = 256,
        fuse_max_ratio: int = 4,
        async_admission: bool = True,
        mesh: Optional[Any] = None,
        result_callback: Optional[Callable[[RequestResult], None]] = None,
    ) -> None:
        if config.kv_cache_dtype not in (None, "int8"):
            raise ValueError(f"unsupported kv_cache_dtype {config.kv_cache_dtype!r}")
        self.mesh = mesh
        self.decoder = decoder
        self.device = next(decoder.parameters()).device
        self.num_slots = slots
        self.max_len = max_len
        self.steps_per_sync = steps_per_sync
        self.config = config
        self.length_bucket = length_bucket
        self.spec_gamma = speculative_gamma
        self.spec_ngram = speculative_ngram
        # realized tokens per verify step below this is a net loss (a verify
        # step costs _SPEC_COST_RATIO x a plain step). With autodisable=True the
        # monitor is two-way: a trailing window of realized tokens per verify
        # step below break-even turns speculation off (plain decode from the
        # next chunk), and while it is off a host simulation of the n-gram
        # drafter over the plain-decode stream estimates acceptance at no
        # device cost; when the trailing estimate clears break-even x a
        # hysteresis margin, speculation comes back with gamma picked from the
        # measured verify-cost table. Greedy speculation is exact-match, so a
        # switch never changes the tokens.
        self.spec_break_even = speculative_break_even
        self.spec_autodisable = speculative_autodisable
        self._spec_probe_steps = 128
        self._spec_warned = False
        self._spec_capable = speculative_gamma > 0
        self._spec_gamma0 = speculative_gamma
        self._spec_off_by_monitor = False
        self._spec_reenable_margin = 1.1
        self._spec_win_steps = 0  # trailing window while speculating (real verify steps)
        self._spec_win_emitted = 0
        self._est_win_steps = 0  # trailing window while the monitor has it off (simulated)
        self._est_win_emitted = 0
        if prefill_fn is not None:
            if len(inspect.signature(prefill_fn).parameters) == 1:
                # single-argument prefill fns: no prepared payload
                self._prefill_request = lambda req, prepared=None: prefill_fn(req)
            else:
                self._prefill_request = prefill_fn
        else:
            self._prefill_request = self._default_prefill
        # batched admission: only the default LLM prefill knows how to batch
        # same-bucket prompts into one program; custom prefill fns stay per
        # request. batch_admissions=False forces the per-request path.
        self._can_batch_prefill = prefill_fn is None and batch_admissions
        # cross-bucket fusion: a short-prompt prefill streams the weights
        # once whatever its length, so padding every pending admission to a
        # shared bucket is nearly free, one program per fused group instead
        # of one per bucket. A bucket joins a group only while the fused
        # length stays at most ``fuse_max_bucket``, below the point where a
        # prefill turns from weight-stream-bound to compute-bound: a GEMM over
        # T tokens does 2·T FLOPs per weight element of 2 bytes, so it crosses
        # at T ≈ peak / HBM rate = 989e12 / 3.35e12 ≈ 295 on the H100 SXM
        # (dense bf16 and HBM data-sheet figures), and 256 stays below it. The
        # pad spread is bounded too (group max <= fuse_max_ratio x group min),
        # so that a near-max_len prompt never drags short ones into its
        # compute-bound prefill, and so is the fused small cache's size.
        self._fuse_buckets = fuse_admission_buckets
        self._fuse_max_bucket = fuse_max_bucket
        self._fuse_max_ratio = fuse_max_ratio
        # async admission: placement queues prefill + insert and returns
        # without reading the first sampled token back; the next chunk queues
        # behind them, so the device does not drain while the host waits on a
        # prefill. The first token resolves at the next chunk's sync. This
        # needs a host-side sequence-length bound for the budget check, so a
        # custom prefill fn without a ``prepared_len`` hook places blocking.
        # The tokens are the same either way.
        self._async_admission = async_admission
        # host-side preparation hook (video decode / tokenization) that the
        # prefetcher runs while the device decodes a chunk; custom prefill fns
        # start without one (for_vidlm assigns its own)
        self._prepare: Optional[Callable[[Request], Any]] = self._prepare_llm if prefill_fn is None else None
        # host-side expected sequence length of a prepared payload: admission
        # rejects over-budget requests before paying the prefill; None (custom
        # prefill fns) falls back to the check after the prefill
        self._prepared_len: Optional[Callable[[Request, Any], int]] = (
            (lambda req, prepared: len(prepared[2])) if prefill_fn is None else None
        )
        self._prefetched: Optional[Tuple[str, Any, Dict[str, Any]]] = None
        self._submit_t: Dict[str, float] = {}  # request_id -> submit() wall time (TTFT)
        # shared-prefix registry: prefix_id -> (B=1 KVCache of exactly P rows,
        # P, BOS ids baked into the cache)
        self._prefixes: Dict[str, Tuple[KVCache, int, Tuple[int, ...]]] = {}
        # VidLM frontends assign a prompt_text -> post-BOS suffix ids hook (it
        # checks the prompt's BOS against the prefix's); LLM-level engines
        # take stripped input_ids directly
        self._suffix_tokenize: Optional[Callable[[Request, Tuple[int, ...]], np.ndarray]] = None
        if rng is None:
            rng = torch.Generator(device=self.device)
            rng.manual_seed(0)
        self._rng = rng

        # gamma+1 spare rows: a live slot's pointer may run up to gamma+1 past
        # its last in-budget token before the host syncs; the freeze guard in
        # _decode_chunk_spec fires only past them. Sized for the largest gamma
        # the monitor may pick (8). One more row is the per-slot scratch row.
        spare_gamma = max(speculative_gamma, 8) if speculative_gamma else 0
        rows = max_len + (spare_gamma + 1 if spare_gamma else 0) + 1
        c = decoder.cfg
        sp = axis_size(mesh, SEQ_AXIS) if c.sequence_parallel else 1
        if sp > 1:  # rows sharded over sp: rounded up to tile it, each rank's share with a scratch row of its own
            rows = -(-(rows - 1) // sp) * sp
        self._cache_dtype = cache_dtype(config.kv_cache_dtype, c.compute_dtype)
        cache = KVCache.create(c, slots, rows, self._cache_dtype, self.device, mesh=mesh, tp=decoder.tp)
        overwatch.info(f"engine KV cache: {slots} slots x {rows} rows = {_cache_gib(cache):.2f} GiB "
                       f"({_dtype_name(self._cache_dtype)})")
        state = dict(
            k=cache.k, v=cache.v, k_scale=cache.k_scale, v_scale=cache.v_scale, sp=cache.sp,
            length=torch.zeros(slots, dtype=torch.long, device=self.device),
            last_tok=torch.full((slots,), config.pad_token_id, dtype=torch.long, device=self.device),
            done=torch.ones(slots, dtype=torch.bool, device=self.device),
        )
        if speculative_gamma:
            hc = max_len + 2 * speculative_gamma + speculative_ngram + 8
            state.update(hist=torch.full((slots, hc), config.pad_token_id, dtype=torch.long, device=self.device),
                         hist_len=torch.zeros(slots, dtype=torch.long, device=self.device))
        self._state = _DecodeState(**state)
        self._chunks: "OrderedDict[int, _Chunk]" = OrderedDict()
        self._slots = [_Slot() for _ in range(slots)]
        self._queue: deque = deque()
        self._results: Dict[str, RequestResult] = {}
        # fires the moment a request finishes (errors too): frontends persist
        # results as they come, so a crash loses at most the in-flight slots
        self._result_callback = result_callback
        # every rank of a sequence- or tensor-parallel engine serves the same requests; rank 0 returns them
        self._returns_results = (cache.sp is None and decoder.tp is None) or world()[0] == 0
        self.stats = EngineStats()

    # ------------------------------------------------------------------ api
    def submit(self, request: Request) -> None:
        self._submit_t[request.request_id] = time.perf_counter()
        event("request.submit", request=request.request_id)
        self._queue.append(request)

    def register_prefix(self, prefix_id: str, prefix: Any) -> None:
        """Register a shared prompt prefix for suffix-only admission.

        ``prefix`` is a :class:`~merv_tpu_torch.models.generation.VideoPrefix`
        (from ``MERV.build_video_prefix``: its BOS ids and KV dtype are checked
        here) or a bare B=1 :class:`KVCache` whose buffer is exactly the prefix
        rows. Requests naming ``prefix_id`` then prefill only their suffix
        against it and copy ``[prefix | suffix]`` into their slot. The engine
        only reads the registered cache."""
        bos: Tuple[int, ...] = ()
        if isinstance(prefix, VideoPrefix):
            want = self.config.kv_cache_dtype
            if prefix.kv_cache_dtype != want:
                raise ValueError(
                    f"prefix {prefix_id!r} was built with kv_cache_dtype={prefix.kv_cache_dtype!r} but this engine "
                    f"serves {want!r}"
                )
            bos, prefix = prefix.bos_ids, prefix.cache
        if prefix.k.dtype != self._cache_dtype:
            raise ValueError(
                f"prefix {prefix_id!r} cache dtype {_dtype_name(prefix.k.dtype)} does not match "
                f"the engine's KV dtype {_dtype_name(self._cache_dtype)}"
            )
        if prefix.k.shape[1] != 1:
            raise ValueError(f"prefix caches are per-video (B=1), got B={prefix.k.shape[1]}")
        P = prefix.k.shape[3]
        if P + 1 + 1 > self.max_len:
            raise ValueError(
                f"prefix {prefix_id!r} is {P} rows: no room for a suffix token plus one generated token under "
                f"max_len {self.max_len}"
            )
        gib = _cache_gib(prefix)
        self._prefixes[prefix_id] = (prefix, P, bos)
        self.stats.prefix_rows.append(P)
        overwatch.info(
            f"registered prefix {prefix_id!r}: {P} rows = {gib:.2f} GiB ({len(self._prefixes)} prefixes live; "
            "unregister_prefix frees them)"
        )

    def unregister_prefix(self, prefix_id: str) -> None:
        """Drop a registered prefix (live slots hold copies, so in-flight
        decodes are unaffected; new requests naming it fail one by one).
        Frontends with many videos register and unregister in waves to bound
        memory (``cli/serve.py --prefix_budget``)."""
        self._prefixes.pop(prefix_id, None)

    def run(self, requests: Sequence[Request] = ()) -> Dict[str, RequestResult]:
        """Serve all queued (and given) requests to completion; returns the
        results keyed by request_id. Callable repeatedly: state persists."""
        for r in requests:
            self.submit(r)
        self._timed_admit()
        while any(s.request is not None for s in self._slots):
            t0 = time.perf_counter()
            with span("engine.chunk"):
                self._decode_one_chunk()
            self.stats.decode_s += time.perf_counter() - t0
            self._timed_admit()
        return dict(self._results) if self._returns_results else {}

    def _timed_admit(self) -> None:
        t0 = time.perf_counter()
        with span("engine.admit"):
            self._admit()
        self.stats.admit_s += time.perf_counter() - t0

    # ------------------------------------------------------------ internals
    def _chunk(self, gamma: int) -> _Chunk:
        """The chunk program for ``gamma`` (0 = plain), made (and on a CUDA
        device captured) on first use; at most ``MAX_CHUNK_GRAPHS`` alive."""
        chunk = self._chunks.get(gamma)
        if chunk is not None:
            self._chunks.move_to_end(gamma)
            return chunk
        while len(self._chunks) >= MAX_CHUNK_GRAPHS:
            self._chunks.popitem(last=False)[1].release()
        seed = int(torch.randint(0, 2**62, (1,), generator=self._rng, device=self._rng.device))
        chunk = _Chunk(self, gamma, seed)
        if _graph_capturable(self.device, self._state.sp, self.decoder.tp):
            chunk.capture(self)
            self.stats.capture_s += chunk.capture_s
        self._chunks[gamma] = chunk
        return chunk

    def _bucket(self, n: int) -> int:
        b = self.length_bucket
        return min(-(-n // b) * b, self.max_len) if b > 1 else n

    def _prepare_llm(self, req: Request):
        """Host-side request prep (pad to the bucket): prefetchable during decode."""
        if req.input_ids is None:
            raise ValueError("LLM-level engine requests need input_ids (tokenized prompt)")
        ids = np.asarray(req.input_ids, np.int64).reshape(-1)
        Tb = self._bucket(len(ids))
        if len(ids) > Tb:
            raise ValueError(f"prompt ({len(ids)} tokens) exceeds max_len {self.max_len}")
        padded = np.full((1, Tb), self.config.pad_token_id, np.int64)
        mask = np.zeros((1, Tb), np.int64)
        padded[0, : len(ids)] = ids
        mask[0, : len(ids)] = 1
        return padded, mask, ids

    def _repad(self, prepared: Tuple, Tb: int) -> Tuple:
        """Right-pad a prepared (ids [1, T], mask [1, T], raw) payload to bucket
        ``Tb``: cross-bucket fusion pads every pending admission to the largest
        bucket of its group so that they share one prefill program."""
        ids0, mask0 = prepared[0], prepared[1]
        T = ids0.shape[1]
        if T == Tb:
            return prepared
        if Tb < T:
            raise ValueError(f"_repad target {Tb} is smaller than payload length {T}")
        ids = np.full((1, Tb), self.config.pad_token_id, np.int64)
        mask = np.zeros((1, Tb), np.int64)
        ids[:, :T] = ids0
        mask[:, :T] = mask0
        return (ids, mask) + tuple(prepared[2:])

    def _fusion_targets(self, buckets: List[int]) -> Dict[int, int]:
        """Map each distinct pending bucket to the bucket its group fuses to.
        Greedy ascending merge: a bucket joins the current group only while it
        is at most ``fuse_max_bucket`` and at most ``fuse_max_ratio`` x the
        group's smallest bucket; others start their own group (same-bucket
        admissions still batch)."""
        distinct = sorted(set(buckets))
        targets: Dict[int, int] = {}
        group: List[int] = [distinct[0]]
        for Tb in distinct[1:]:
            if Tb <= self._fuse_max_bucket and Tb <= group[0] * self._fuse_max_ratio:
                group.append(Tb)
            else:
                for b in group:
                    targets[b] = group[-1]
                group = [Tb]
        for b in group:
            targets[b] = group[-1]
        return targets

    def _prepare_suffix(self, req: Request):
        """Host-side prep for a shared-prefix request: the suffix tokens
        (``input_ids`` directly, or ``prompt_text`` through the frontend's
        BOS-stripping hook), bucketed against the room the prefix leaves, and
        right-padded. Prefetchable like ``_prepare_llm``."""
        entry = self._prefixes.get(req.prefix_id)
        if entry is None:
            raise KeyError(
                f"request {req.request_id!r} names unregistered prefix {req.prefix_id!r}: call register_prefix first"
            )
        _, P, bos = entry
        if req.input_ids is not None:
            ids = np.asarray(req.input_ids, np.int64).reshape(-1)
        elif req.prompt_text is not None and self._suffix_tokenize is not None:
            ids = np.asarray(self._suffix_tokenize(req, bos), np.int64).reshape(-1)
        else:
            raise ValueError(
                "prefix requests need input_ids (post-BOS suffix tokens), or prompt_text on a frontend with a "
                "suffix tokenizer (for_vidlm)"
            )
        if len(ids) == 0:
            raise ValueError(
                f"request {req.request_id!r} has an empty suffix: the shared-prefix path needs at least one suffix "
                "token to anchor its first sampled position"
            )
        room = self.max_len - P
        b = self.length_bucket
        Tb = min(-(-len(ids) // b) * b, room) if b > 1 else len(ids)
        if len(ids) > Tb:
            raise ValueError(
                f"suffix ({len(ids)} tokens) exceeds the {room} rows prefix {req.prefix_id!r} ({P} rows) leaves "
                f"under max_len {self.max_len}"
            )
        padded = np.full((1, Tb), self.config.pad_token_id, np.int64)
        mask = np.zeros((1, Tb), np.int64)
        padded[0, : len(ids)] = ids
        mask[0, : len(ids)] = 1
        return padded, mask, ids

    def _llm_prefill(self, ids: np.ndarray, mask: np.ndarray):
        self.stats.prefill_shapes.append(tuple(ids.shape))
        return _llm_prefill(self.decoder, self.config, torch.as_tensor(ids, device=self.device),
                            torch.as_tensor(mask, device=self.device), self._rng)

    def _default_prefill(self, req: Request, prepared: Any = None):
        padded, mask, ids = prepared if prepared is not None else self._prepare_llm(req)
        if padded.shape[1] not in self.stats.prefill_buckets:
            self.stats.prefill_buckets.append(padded.shape[1])
        self.stats.admit_buckets.append(padded.shape[1])
        with span("admit.prefill", device=self.device):
            small, first, n_valid = self._llm_prefill(padded, mask)
        return small, first, n_valid, ids  # ids = the speculative draft corpus

    # ------------------------------------------------------- admission prefetch
    def _start_prefetch(self) -> None:
        """Start host-side preparation of the queue head on a worker thread
        while the device runs a decode chunk."""
        if self._prefetched is not None or not self._queue:
            return
        req = self._queue[0]
        # prefix requests always have engine-owned prep; others need the
        # frontend's hook (custom prefill fns without one are not prefetched)
        prep = self._prepare_suffix if req.prefix_id is not None else self._prepare
        if prep is None:
            return
        holder: Dict[str, Any] = {}

        def work():
            try:
                with span("prefetch.prepare", request=req.request_id):
                    holder["payload"] = prep(req)
            except Exception as e:  # surfaced at admission
                holder["error"] = e

        t = threading.Thread(target=work, daemon=True)
        t.start()
        self._prefetched = (req.request_id, t, holder)

    def _take_prefetch(self, req: Request) -> Any:
        if self._prefetched is None or self._prefetched[0] != req.request_id:
            return None
        _, t, holder = self._prefetched
        self._prefetched = None
        with span("admit.prefetch_wait", request=req.request_id):
            t.join()
        if "error" in holder:
            raise holder["error"]
        self.stats.prefetch_hits += 1
        return holder["payload"]

    def _fail(self, req: Request, exc: BaseException) -> None:
        """Per-request fault isolation: a corrupt video, an over-budget prompt
        or a tokenizer error fails that request with ``finish_reason="error"``;
        every in-flight slot and the rest of the queue keep serving."""
        overwatch.error(f"request {req.request_id} failed: {type(exc).__name__}: {exc}")
        self._submit_t.pop(req.request_id, None)
        self.stats.errors += 1
        event("request.finish", request=req.request_id)
        res = RequestResult(
            req.request_id,
            np.full((max(req.max_new_tokens, 1),), self.config.pad_token_id, np.int32),
            "error",
            error=f"{type(exc).__name__}: {exc}",
        )
        self._results[req.request_id] = res
        if self._result_callback is not None and self._returns_results:
            self._result_callback(res)

    @torch.inference_mode()
    def _admit(self) -> None:
        # 1) drain the queue into (slot, request, prepared payload) triples: host
        #    prep errors and over-budget prompts fail per request here, before
        #    any prefill is paid
        free = [i for i, s in enumerate(self._slots) if s.request is None]
        admits: List[Tuple[int, Request, Any]] = []
        prefix_admits: List[Tuple[int, Request, Any]] = []
        while free and self._queue:
            req = self._queue[0]
            try:
                prepared = self._take_prefetch(req)
            except Exception as e:
                self._queue.popleft()
                self._fail(req, e)
                continue
            self._queue.popleft()
            try:
                if req.prefix_id is not None:
                    if prepared is None:
                        with span("admit.prepare", request=req.request_id):
                            prepared = self._prepare_suffix(req)
                    n = self._prefixes[req.prefix_id][1] + len(prepared[2])
                    if n + req.max_new_tokens > self.max_len:
                        raise ValueError(
                            f"prefix ({self._prefixes[req.prefix_id][1]}) + suffix ({len(prepared[2])}) + "
                            f"max_new_tokens ({req.max_new_tokens}) exceeds engine max_len {self.max_len}"
                        )
                    prefix_admits.append((free.pop(0), req, prepared))
                    continue
                if prepared is None and self._prepare is not None:
                    with span("admit.prepare", request=req.request_id):
                        prepared = self._prepare(req)
                if self._prepared_len is not None and prepared is not None:
                    n = self._prepared_len(req, prepared)
                    if n + req.max_new_tokens > self.max_len:
                        raise ValueError(
                            f"prompt ({n} tokens) + max_new_tokens ({req.max_new_tokens}) exceeds engine max_len "
                            f"{self.max_len}"
                        )
            except Exception as e:
                self._fail(req, e)
                continue
            admits.append((free.pop(0), req, prepared))

        # prefix admissions: suffix-only prefill grouped by (prefix, bucket), so
        # that same-(video, bucket) questions share one program on any frontend
        if prefix_admits:
            self.stats.admit_buckets.extend(it[2][0].shape[1] for it in prefix_admits)
            if self._fuse_buckets:
                # pad each prefix's pending suffixes toward its largest bucket
                # (gated like the main path)
                by_pid: Dict[str, List[int]] = {}
                for _, req, prepared in prefix_admits:
                    by_pid.setdefault(req.prefix_id, []).append(prepared[0].shape[1])
                ptargets = {pid: self._fusion_targets(bs) for pid, bs in by_pid.items()}
                prefix_admits = [(s, r, self._repad(p, ptargets[r.prefix_id][p[0].shape[1]]))
                                 for s, r, p in prefix_admits]
            pgroups: Dict[Tuple[str, int], List[Tuple[int, Request, Any]]] = {}
            for item in prefix_admits:
                pgroups.setdefault((item[1].prefix_id, item[2][0].shape[1]), []).append(item)
            for (pid, Tb), items in pgroups.items():
                if Tb not in self.stats.prefill_buckets:
                    self.stats.prefill_buckets.append(Tb)
                cache, P, _bos = self._prefixes[pid]
                ids, mask = self._pow2_rows(items)
                self.stats.prefill_shapes.append(tuple(ids.shape))
                rids = tuple(it[1].request_id for it in items)
                with span("admit.prefill", request=rids, device=self.device):
                    small, first, n_valid = _prefix_suffix_prefill(
                        self.decoder, self.config, cache, torch.as_tensor(ids, device=self.device),
                        torch.as_tensor(mask, device=self.device), self._rng,
                    )
                self.stats.prefills += 1
                self.stats.suffix_prefills += 1
                self.stats.prefix_admissions += len(items)
                if len(items) > 1:
                    self.stats.batched_admissions += len(items)
                with span("admit.place", request=rids):
                    self._place_group(items, small, first, n_valid, P)
        if not admits:
            return

        # 2) prefill. Same-bucket pending admissions on the default LLM path
        #    share one prefill program (the weights stream once for all of
        #    them); custom prefill fns run per request.
        if self._can_batch_prefill:
            self.stats.admit_buckets.extend(it[2][0].shape[1] for it in admits)
            if self._fuse_buckets and len(admits) > 1:
                targets = self._fusion_targets([it[2][0].shape[1] for it in admits])
                admits = [(s, r, self._repad(p, targets[p[0].shape[1]])) for s, r, p in admits]
            groups: Dict[int, List[Tuple[int, Request, Any]]] = {}
            for item in admits:
                groups.setdefault(item[2][0].shape[1], []).append(item)
            for Tb, items in groups.items():
                if Tb not in self.stats.prefill_buckets:
                    self.stats.prefill_buckets.append(Tb)
                rids = tuple(it[1].request_id for it in items)
                with span("admit.prefill", request=rids, device=self.device):
                    small, first, n_valid = self._llm_prefill(*self._pow2_rows(items))
                self.stats.prefills += 1
                if len(items) > 1:
                    self.stats.batched_admissions += len(items)
                with span("admit.place", request=rids):
                    self._place_group(items, small, first, n_valid, 0)
        else:
            for slot_idx, req, prepared in admits:
                with span("admit.request", request=req.request_id):
                    self._admit_one(slot_idx, req, prepared)

    def _admit_one(self, slot_idx: int, req: Request, prepared: Any) -> None:
        """One admission through the per-request prefill fn (``for_vidlm``'s
        towers and prefill, or a custom fn), then its placement."""
        try:
            out = self._prefill_request(req, prepared)
        except Exception as e:
            self._fail(req, e)  # the slot stays free for the next _admit
            return
        small, first, n_valid = out[:3]
        lookup = out[3] if len(out) > 3 else None
        if self.spec_gamma and lookup is None:
            raise ValueError(
                "speculative mode needs the prefill fn to return the prompt token ids as a 4th element "
                "(the draft corpus)"
            )
        self.stats.prefills += 1
        with span("admit.place"):
            if self._async_admission and self._prepared_len is not None and prepared is not None:
                # custom per-request prefills pipeline too when the frontend
                # gives a host-side length bound (for_vidlm does); otherwise
                # placement reads the prefill back so that the budget check
                # after it can run
                self._place_async(slot_idx, req, small, first, n_valid, 0,
                                  self._prepared_len(req, prepared), lookup)
            else:
                self._place(slot_idx, req, small, first, n_valid, 0, int(first[0]), int(n_valid[0]), lookup)

    def _pow2_rows(self, items: List[Tuple[int, Request, Any]]) -> Tuple[np.ndarray, np.ndarray]:
        """The admission batch's ids and mask, padded to a power of two rows
        by repeating the last real row (extras are never placed): prefill
        programs stay bounded at buckets x (1 + log2(slots)), and no padded
        row is all pad."""
        n_real = len(items)
        n_prog = 1 << (n_real - 1).bit_length()
        rows_ids = [it[2][0] for it in items] + [items[-1][2][0]] * (n_prog - n_real)
        rows_mask = [it[2][1] for it in items] + [items[-1][2][1]] * (n_prog - n_real)
        return np.concatenate(rows_ids, axis=0), np.concatenate(rows_mask, axis=0)

    def _place_group(self, items, small, first, n_valid, P: int) -> None:
        if self._async_admission:
            for row, (slot_idx, req, prepared) in enumerate(items):
                self._place_async(slot_idx, req, small, first, n_valid, row, P + len(prepared[2]), prepared[2])
        else:
            first_h, n_valid_h = first.cpu().numpy(), n_valid.cpu().numpy()
            for row, (slot_idx, req, prepared) in enumerate(items):
                self._place(slot_idx, req, small, first, n_valid, row, int(first_h[row]), int(n_valid_h[row]),
                            prepared[2])

    def _set_draft_corpus(self, slot_idx: int, lookup: Any, first: torch.Tensor, row: int) -> None:
        """Host mirror of the slot's draft corpus and, when speculating, its
        device history: the prompt ids, then the first token (still on the
        device: the write joins the queue, no readback)."""
        slot = self._slots[slot_idx]
        if self._spec_capable and lookup is not None:
            lk_host = [int(t) for t in np.asarray(lookup).reshape(-1)]
            slot.prompt_ids = lk_host
            slot.est_pos = len(lk_host) + 1
        elif self._spec_capable:
            slot.prompt_ids, slot.est_pos = None, 0
        if self.spec_gamma:
            st = self._state
            hc = st.hist.shape[1]
            lk = np.asarray(lookup, np.int64).reshape(-1)[: hc - 1]
            st.hist[slot_idx].fill_(self.config.pad_token_id)
            st.hist[slot_idx, : len(lk)] = torch.as_tensor(lk, device=self.device)
            st.hist[slot_idx, len(lk) : len(lk) + 1].copy_(first[row : row + 1])
            st.hist_len[slot_idx] = len(lk) + 1

    def _place(self, slot_idx: int, req: Request, small: Tuple, first: torch.Tensor, n_valid: torch.Tensor,
               row: int, first_i: int, n: int, lookup: Any) -> None:
        """Copy prefilled request ``row`` into ``slot_idx`` (or finish it at
        once). ``n`` / ``first_i`` are the values read back to the host."""
        if n + req.max_new_tokens > self.max_len:
            # backstop for prefill fns whose prepared payload under-counts the
            # final sequence: the prefill was paid, but only this request fails
            self._fail(req, ValueError(
                f"prompt ({n} tokens) + max_new_tokens ({req.max_new_tokens}) exceeds engine max_len {self.max_len}"
            ))
            return
        t0 = self._submit_t.pop(req.request_id, None)
        if t0 is not None:
            self.stats.ttft_s[req.request_id] = time.perf_counter() - t0
        event("request.first_token", request=req.request_id)
        if req.max_new_tokens == 1 or first_i == self.config.eos_token_id:
            self._finish(req, [first_i], "eos" if first_i == self.config.eos_token_id else "budget")
            return
        _insert_into_slot(self._state, small, row, slot_idx, n_valid, first)
        self._set_draft_corpus(slot_idx, lookup, first, row)
        slot = self._slots[slot_idx]
        slot.request = req
        slot.emitted = [first_i]
        slot.done = False

    def _place_async(self, slot_idx: int, req: Request, small: Tuple, first: torch.Tensor, n_valid: torch.Tensor,
                     row: int, n_host: int, lookup: Any) -> None:
        """Non-blocking :meth:`_place`: copy request ``row`` into ``slot_idx``
        without reading the first sampled token back; it resolves at the next
        chunk's sync (``pending_first``). The budget check uses the host-known
        sequence length ``n_host`` (prompt tokens, plus the prefix rows on the
        suffix path)."""
        if n_host + req.max_new_tokens > self.max_len:
            self._fail(req, ValueError(
                f"prompt ({n_host} tokens) + max_new_tokens ({req.max_new_tokens}) exceeds engine max_len "
                f"{self.max_len}"
            ))
            return
        _insert_into_slot(self._state, small, row, slot_idx, n_valid, first)
        self._set_draft_corpus(slot_idx, lookup, first, row)
        slot = self._slots[slot_idx]
        slot.request = req
        slot.emitted = []
        slot.pending_first = (first, row)
        slot.done = False

    def _resolve_pending_firsts(self) -> None:
        """Read back the first sampled token of every slot placed
        asynchronously (one readback per admission event's ``first`` tensor).
        An EOS first token marks the slot done, so that the chunk's tokens for
        it are dropped, as blocking placement's immediate finish does."""
        fetched: Dict[int, np.ndarray] = {}
        for slot in self._slots:
            if slot.request is None or slot.pending_first is None:
                continue
            arr, row = slot.pending_first
            host = fetched.get(id(arr))
            if host is None:
                host = arr.cpu().numpy()
                fetched[id(arr)] = host
            first_i = int(host[row])
            slot.pending_first = None
            slot.emitted = [first_i]
            rid = slot.request.request_id
            t0 = self._submit_t.pop(rid, None)
            if t0 is not None:
                self.stats.ttft_s[rid] = time.perf_counter() - t0
            event("request.first_token", request=rid)
            if first_i == self.config.eos_token_id:
                slot.done = True

    @torch.inference_mode()
    def _decode_one_chunk(self) -> None:
        spec_steps0, spec_emitted0 = self.stats.spec_steps, self.stats.spec_emitted
        self._state.done.copy_(torch.tensor([s.done for s in self._slots], device=self.device))
        with span("chunk.replay"):
            chunk = self._chunk(self.spec_gamma)
            chunk.run(self)
        self._start_prefetch()  # overlap the queue head's host prep with the running chunk
        with span("chunk.readback"):  # the one host sync per chunk
            if self.spec_gamma:  # [K, B, gamma+1] windows + [K, B] counts
                wins, emits = chunk.wins.cpu().numpy(), chunk.emits.cpu().numpy()
            else:
                toks = chunk.toks.cpu().numpy()  # [K, B]
        with span("chunk.bookkeeping"):
            if self.spec_gamma:
                step_tokens = [[wins[k, b, : emits[k, b]] for b in range(self.num_slots)]
                               for k in range(self.steps_per_sync)]
            else:
                step_tokens = [[toks[k, b : b + 1] for b in range(self.num_slots)]
                               for k in range(self.steps_per_sync)]
            self._consume_chunk(step_tokens, spec_steps0, spec_emitted0)

    def _consume_chunk(self, step_tokens: List[List[np.ndarray]], spec_steps0: int, spec_emitted0: int) -> None:
        """The chunk's tokens on the host: first tokens resolved, each slot's
        tokens emitted up to its budget or EOS, finished requests retired, the
        speculation monitor stepped."""
        self._resolve_pending_firsts()
        self.stats.decode_chunks += 1
        self.stats.decode_steps += self.steps_per_sync
        for slot_idx, slot in enumerate(self._slots):
            if slot.request is None:
                self.stats.slot_steps_idle += self.steps_per_sync
                continue
            req = slot.request
            active_steps = 0
            for k in range(self.steps_per_sync):
                if slot.done or len(slot.emitted) >= req.max_new_tokens:
                    break
                consumed_k = 0
                for t in step_tokens[k][slot_idx]:
                    if slot.done or len(slot.emitted) >= req.max_new_tokens:
                        break
                    consumed_k += 1
                    slot.emitted.append(int(t))
                    if int(t) == self.config.eos_token_id:
                        slot.done = True
                if consumed_k:
                    active_steps += 1
                    if self.spec_gamma:
                        self.stats.spec_steps += 1
                        self.stats.spec_emitted += consumed_k
            self.stats.slot_steps_active += active_steps
            self.stats.slot_steps_idle += self.steps_per_sync - active_steps
            if self._spec_off_by_monitor and not self.spec_gamma and slot.prompt_ids is not None:
                # acceptance estimate at no device cost: simulate the n-gram
                # drafter over the tokens plain decode just emitted
                h = slot.prompt_ids + slot.emitted
                s_, e_ = _sim_spec_steps(h, max(slot.est_pos, len(slot.prompt_ids) + 1), self._spec_gamma0,
                                         self.spec_ngram, self.config.pad_token_id)
                self._est_win_steps += s_
                self._est_win_emitted += e_
                slot.est_pos = len(h)
            if slot.done or len(slot.emitted) >= req.max_new_tokens:
                self._finish(req, slot.emitted, "eos" if slot.done else "budget")
                slot.request, slot.emitted, slot.done = None, [], True
                slot.prompt_ids, slot.est_pos = None, 0
        self._spec_monitor(self.stats.spec_steps - spec_steps0, self.stats.spec_emitted - spec_emitted0)

    def _spec_monitor(self, dsteps: int, demitted: int) -> None:
        """Per-chunk speculation governor (two-way with autodisable=True): the
        trailing window of realized tokens per verify step decides disable;
        the host acceptance estimate (gathered by the slot loop while off)
        decides re-enable. ``dsteps`` / ``demitted`` are this chunk's verify
        steps and tokens."""
        if not self._spec_capable:
            return
        if not self.spec_autodisable:
            # advisory mode: warn once when the cumulative run is a loss
            if (
                self.spec_gamma
                and not self._spec_warned
                and self.stats.spec_steps >= self._spec_probe_steps
                and self.stats.tokens_per_step < self.spec_break_even
            ):
                self._spec_warned = True
                overwatch.warning(
                    f"speculative decoding realized {self.stats.tokens_per_step:.3f} tokens/step over "
                    f"{self.stats.spec_steps} verify steps, below the {self.spec_break_even:.2f}x break-even: this "
                    "workload's n-gram acceptance is too low for gamma to pay; consider speculative_gamma=0 or "
                    "speculative_autodisable=True"
                )
            return
        if self.spec_gamma:
            self._spec_win_steps += dsteps
            self._spec_win_emitted += demitted
            if self._spec_win_steps >= self._spec_probe_steps:
                realized = self._spec_win_emitted / self._spec_win_steps
                if realized < self.spec_break_even:
                    overwatch.warning(
                        f"speculative decoding realized {realized:.3f} tokens/step over the trailing "
                        f"{self._spec_win_steps} verify steps, below the {self.spec_break_even:.2f}x break-even; "
                        "falling back to plain decode (the monitor re-enables when the trailing acceptance "
                        "estimate clears break-even)"
                    )
                    self.spec_gamma = 0
                    self._spec_off_by_monitor = True
                    self.stats.spec_disables += 1
                    self._est_win_steps = self._est_win_emitted = 0
                    for s in self._slots:
                        if s.prompt_ids is not None:
                            s.est_pos = len(s.prompt_ids) + len(s.emitted)
                self._spec_win_steps = self._spec_win_emitted = 0
        elif self._spec_off_by_monitor and self._est_win_steps >= self._spec_probe_steps:
            self._maybe_reenable_spec()

    def _maybe_reenable_spec(self) -> None:
        """Re-enable speculation when the trailing host estimate of tokens per
        verify step clears break-even x a hysteresis margin; gamma is picked
        from the measured per-gamma verify-cost table against per-gamma
        simulated acceptance on the live slots' streams."""
        est = self._est_win_emitted / self._est_win_steps
        self._est_win_steps = self._est_win_emitted = 0
        if est < self.spec_break_even * self._spec_reenable_margin:
            return
        best_g, best_speedup = self._spec_gamma0, 0.0
        for g in (2, 4, 8):
            steps = emitted = 0
            for slot in self._slots:
                if slot.request is None or slot.prompt_ids is None:
                    continue
                h = slot.prompt_ids + slot.emitted
                s_, e_ = _sim_spec_steps(h, len(slot.prompt_ids) + 1, g, self.spec_ngram, self.config.pad_token_id)
                steps += s_
                emitted += e_
            if steps == 0:
                continue
            speedup = (emitted / steps) / _spec_cost_ratio(g)
            if speedup > best_speedup:
                best_g, best_speedup = g, speedup
        overwatch.info(
            f"[*] speculation re-enabled: trailing estimate {est:.3f} tokens/step clears break-even "
            f"{self.spec_break_even:.2f} x margin {self._spec_reenable_margin:.2f}; gamma={best_g} from the "
            "measured cost table"
        )
        self._rebuild_device_hist()
        self.spec_gamma = best_g
        self._spec_off_by_monitor = False
        self.stats.spec_reenables += 1
        self._spec_win_steps = self._spec_win_emitted = 0

    @torch.inference_mode()
    def _rebuild_device_hist(self) -> None:
        """Write the live slots' host histories back into the device draft
        corpus, in place (it went stale while speculation was off)."""
        st = self._state
        hc = st.hist.shape[1]
        hmat = np.full((self.num_slots, hc), self.config.pad_token_id, np.int64)
        hlen = np.zeros((self.num_slots,), np.int64)
        for idx, slot in enumerate(self._slots):
            if slot.request is None or slot.prompt_ids is None:
                continue
            h = slot.prompt_ids + slot.emitted
            if len(h) > hc:
                h = h[-hc:]  # recency window: only recent tokens drive drafting
            hmat[idx, : len(h)] = h
            hlen[idx] = len(h)
        st.hist.copy_(torch.as_tensor(hmat))
        st.hist_len.copy_(torch.as_tensor(hlen))

    def _finish(self, req: Request, emitted: List[int], reason: str) -> None:
        event("request.finish", request=req.request_id)
        out = np.full((req.max_new_tokens,), self.config.pad_token_id, np.int32)
        out[: len(emitted)] = emitted[: req.max_new_tokens]
        res = RequestResult(req.request_id, out, reason)
        self._results[req.request_id] = res
        if self._result_callback is not None and self._returns_results:
            self._result_callback(res)

    # ------------------------------------------------------------- frontends
    @classmethod
    def for_vidlm(cls, vidlm: Any, **kwargs: Any) -> "ContinuousBatchingEngine":
        """Engine over a whole MERV (which holds its own weights): requests
        carry ``prompt_text`` (+ optional ``video``); a prefill runs the whole
        multimodal pipeline (towers -> projectors -> fusion -> splice -> prompt
        prefill) at B=1, as ``MERV.generate_ids`` does. ``register_prefix_video``
        builds a video's shared prefix (``MERV.build_video_prefix``)."""
        decoder = vidlm.llm_backbone.decoder
        engine = cls(decoder, **kwargs)
        seen_buckets: set = set()

        def prepare(req: Request):
            """Host side (video decode, per-encoder transforms, tokenizer): runs
            on the prefetch thread while the device decodes a chunk. The
            payload also keeps the text ids and the row's kind on the host, so
            that admission reads nothing back from the device."""
            if req.prompt_text is None:
                raise ValueError("VidLM engine requests need prompt_text")
            ids, mask, vids, is_mm = vidlm._prepare_batch_inputs([req.video], [req.prompt_text],
                                                                 length_bucket=engine.length_bucket)
            text_ids = ids[0][: int(mask.sum())].cpu().numpy()
            return ids, mask, vids, is_mm, text_ids, bool(is_mm[0])

        @torch.inference_mode()
        def prefill_request(req: Request, prepared: Any = None):
            ids, mask, vids, is_mm, text_ids, _ = prepared if prepared is not None else prepare(req)
            if ids.shape[1] not in seen_buckets:
                seen_buckets.add(ids.shape[1])
                engine.stats.prefill_buckets.append(ids.shape[1])
            embeds, m2 = vidlm.build_inputs_embeds(ids, mask, vids, is_mm)
            engine.stats.prefill_shapes.append(tuple(embeds.shape[:2]))
            with span("admit.prefill", device=engine.device):
                logits, cache, n_valid = prefill(decoder, embeds, m2.long(), embeds.shape[1],
                                                 kv_cache_dtype=engine.config.kv_cache_dtype)
                first = _sample_token(_ban_eos_below_min_length(logits, n_valid, engine.config), engine.config,
                                      engine._rng)
            # the text ids are the draft corpus
            return (cache.k, cache.v, cache.k_scale, cache.v_scale), first, n_valid, text_ids

        def prepared_len(req: Request, prepared: Any) -> int:
            """Expected sequence length after the splice (text, plus the visual
            tokens for a multimodal row): admission rejects an over-budget
            request before the towers and the prefill run."""
            text_ids, multimodal = prepared[4], prepared[5]
            return len(text_ids) + (vidlm.visual_feature_length if multimodal else 0)

        def suffix_tokenize(req: Request, bos: Tuple[int, ...]) -> np.ndarray:
            """prompt_text -> post-BOS suffix ids, checking the prompt's own BOS
            against the ids baked into the registered prefix (as
            ``MERV.generate_batch_shared`` checks)."""
            ids = vidlm.llm_backbone.tokenizer(req.prompt_text, truncation=True).input_ids
            nbos = vidlm.llm_backbone.bos_token_length
            if nbos and tuple(ids[:nbos]) != bos:
                raise ValueError(
                    f"prompt tokenizes to bos_ids={tuple(ids[:nbos])} but prefix {req.prefix_id!r} was built with "
                    f"bos_ids={bos}"
                )
            return np.asarray(ids[nbos:], np.int64)

        def register_prefix_video(prefix_id: str, video: Any, num_frames=None, clip_args=None) -> None:
            """Towers + fusion + the ``[BOS | visual]`` prefill once; every
            request naming ``prefix_id`` then pays only its question suffix."""
            vp = vidlm.build_video_prefix(video, num_frames, clip_args, kv_cache_dtype=engine.config.kv_cache_dtype)
            engine.register_prefix(prefix_id, vp)

        engine._prepare = prepare
        engine._prefill_request = prefill_request
        engine._prepared_len = prepared_len
        engine._suffix_tokenize = suffix_tokenize
        engine.register_prefix_video = register_prefix_video
        # the batched path pads token ids into one prefill; the multimodal
        # payload must go through prefill_request per request, or the towers
        # would be skipped. prefix_id requests ride the engine-owned suffix
        # path, which does batch (per prefix).
        engine._can_batch_prefill = False
        return engine
