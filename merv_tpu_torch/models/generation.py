"""Autoregressive generation over the decoder (counterpart of ``merv_tpu/models/generation.py``).

:func:`prefill` writes the prompt (or the multimodal embedding stream) into a
KV cache and returns the last valid position's logits; :func:`generate`
then decodes greedily or by sampling, with EOS semantics (tokens after EOS
become ``pad_token_id``), right-padded batches (RoPE positions count valid
tokens only) and min-length EOS banning. :func:`prefill_prefix` and
:func:`generate_with_prefix` share one video's ``[BOS | visual]`` cache
across many questions. :func:`generate_speculative` is prompt-lookup
speculative decoding at B=1 (drafts from the prompt's n-grams, verified
``gamma + 1`` tokens a forward); :func:`_ngram_propose` and
:func:`_spec_accept` also serve the engine's batched verify
(:mod:`merv_tpu_torch.serving.engine`).

Decode as one program. ``merv_tpu`` compiles the decode loop once
(``_decode_scan``, a ``lax.scan`` over the T=1 step with the cache donated).
Here the T=1 step is :meth:`DecodeRunner.step`, a function of tensors at
fixed addresses (the runner's cache, token, positions, write pointer,
``done`` and output), which reads nothing back to the host. On a CUDA device
it is captured once per (batch, cache length, config) as a CUDA graph and
replayed; on the CPU the same function runs in the Python loop, which is its
plain version. The early exit (every row has emitted EOS) is read once per
``DECODE_SYNC_EVERY`` steps: rows past EOS are pad either way, so the output
is what a step-by-step check, or ``merv_tpu``'s scan over every step, gives.
Sampling draws from the caller's ``torch.Generator`` (the runner's own
generator takes its state before and hands it back after, and is registered
with the graph).

Under an activation mesh with an ``sp`` axis above 1 (the caller's
:func:`~merv_tpu_torch.parallel.activation_mesh` scope) a runner's cache is
sharded on its rows (``KVCache.create(..., mesh=...)``) and each step merges
the ranks' partials by all-reduces. A step whose exchange a CUDA graph cannot
capture (gloo's collectives) runs eagerly: :attr:`DecodeRunner.mode` names
which. Small caches (a prefix, the engine's admission prefills) stay whole
on every rank and are copied into the shards (``CacheShards.copy_rows``).

A tensor-parallel decoder (``decoder.tp``, cut by ``load_vid`` on a mesh with
a ``tensor`` axis) makes every cache here with its rank's key/value heads, a
prefix included, and its step sums and gathers over the tensor group (2 L + 1
all-reduces and one all-gather): captured with the step under NCCL (written,
not run on a machine with two cards), eager under gloo, as above. Every rank
computes the same logits, so every rank draws the same tokens.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

import merv_tpu_torch.ops.attention as A
from merv_tpu_torch.models.backbones.llm.transformer import KVCache, LlamaDecoder, cache_dtype
from merv_tpu_torch.parallel.sharding import get_activation_mesh
from merv_tpu_torch.tracing import span

# steps run between two reads of ``done`` (the early exit's host sync)
DECODE_SYNC_EVERY = 16
# decode runners kept alive per decoder, least recently used evicted first. Each
# holds its KV cache: at Llama-2-7B 0.5 MiB per token per row (32 layers x K and
# V x 32 heads x 128 x 2 bytes), so B=8 x 1,600 tokens is 6.25 GiB, plus the
# graph's own pool (the step's activations at T=1, a few MiB)
MAX_DECODE_RUNNERS = 2


@dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 128
    do_sample: bool = False
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    eos_token_id: int = 2
    pad_token_id: int = 0
    # HF MinLengthLogitsProcessor: EOS banned while prompt + generated < min_length
    min_length: int = 1
    # "int8" stores the KV cache quantized (per-position fp32 scales): decode
    # reads half the cache bytes; None stores it in the decoder's compute dtype
    kv_cache_dtype: Optional[str] = None


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The one side stream per device on which every decode runner warms up and
    is captured: cuBLAS keeps a workspace for each stream it has run on, so a
    stream per runner would add one per captured shape."""
    return torch.cuda.Stream(device)


@contextlib.contextmanager
def _capturing(graph: "torch.cuda.CUDAGraph", stream: "torch.cuda.Stream"):
    """``torch.cuda.graph`` on ``stream`` with the cyclic garbage collector held
    off. torch collects just before the capture begins; a collection during it
    can free an object whose release is not permitted while a stream captures,
    which invalidates the capture (it did so in a card test of the engine's
    chunks, depending on where the collector's allocation count fell).
    thread_local: host threads (the engine's and the eval CLIs' prefetch) may
    call CUDA meanwhile."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            yield
    finally:
        if enabled:
            gc.enable()


def _graph_capturable(device: torch.device, sp: Any, tp: Any) -> bool:
    """Whether a CUDA graph can hold a decode step on ``device``: a sharded
    cache's merge (``sp``, its ``CacheShards``) and a tensor-parallel
    decoder's sums and gathers (``tp``) must be capturable (NCCL's
    collectives, or the in-process exchange), not gloo's."""
    return device.type == "cuda" and (sp is None or sp.ex.capturable) and (tp is None or tp.capturable)


def _filter_logits(logits: torch.Tensor, cfg: GenerationConfig) -> torch.Tensor:
    """Temperature + top-k + top-p filtering: [.., V] -> [.., V] (-inf masked)."""
    logits = logits / max(cfg.temperature, 1e-6)
    if cfg.top_k > 0:
        k = min(cfg.top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
        cutoff_idx = (cum < cfg.top_p).sum(dim=-1, keepdim=True)
        cutoff = sorted_logits.gather(-1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def _categorical(probs: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row from unnormalised probabilities [B, V] (argmax of p / q, q ~ Exp(1))."""
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return (probs / q).argmax(dim=-1)


def _sample_token(logits: torch.Tensor, cfg: GenerationConfig, generator: Optional[torch.Generator]) -> torch.Tensor:
    """logits [B, V] fp32 -> [B] int64. Sampling is ``torch.multinomial``'s own
    one-sample path written out (argmax of p / q with q ~ Exp(1) from the
    generator), without its checks that read the probabilities back to the
    host: the same draws, and nothing that stops a graph capture."""
    if not cfg.do_sample:
        return logits.argmax(dim=-1)
    return _categorical(torch.softmax(_filter_logits(logits, cfg), dim=-1), generator)


def _ban_eos_below_min_length(logits: torch.Tensor, cur_len: torch.Tensor, cfg: GenerationConfig) -> torch.Tensor:
    """logits [B, V], cur_len [B]: ban EOS while cur_len < min_length."""
    if cfg.min_length <= 1:
        return logits
    suppress = (cur_len < cfg.min_length)[:, None]
    is_eos = (torch.arange(logits.shape[-1], device=logits.device) == cfg.eos_token_id)[None, :]
    return logits.masked_fill(suppress & is_eos, float("-inf"))


@torch.inference_mode()
def prefill(
    decoder: LlamaDecoder,
    inputs_embeds: torch.Tensor,  # [B, T, E]
    attention_mask: Optional[torch.Tensor],  # [B, T]
    cache_len: int,
    attn_impl: str = "auto",
    cache: Optional[KVCache] = None,
    kv_cache_dtype: Optional[str] = None,
) -> Tuple[torch.Tensor, KVCache, torch.Tensor]:
    """Fill a cache of ``cache_len`` positions with the prompt: a new one (in
    ``kv_cache_dtype``), or ``cache`` (a decode runner's, written from row 0).
    Returns (fp32 logits of each row's last valid position [B, V], cache,
    valid-token counts [B])."""
    B, T = inputs_embeds.shape[:2]
    dev = inputs_embeds.device
    if cache is None:
        cache = KVCache.create(decoder.cfg, B, cache_len, cache_dtype(kv_cache_dtype, decoder.cfg.compute_dtype), dev,
                               tp=decoder.tp)
    elif (cache.k.shape[1], cache.max_len) != (B, cache_len):
        raise ValueError(f"prefill: cache of {tuple(cache.k.shape)} for batch {B} and {cache_len} positions")
    if attention_mask is not None:
        am = attention_mask.long()
        positions = (am.cumsum(dim=1) - 1).clamp(min=0)
        n_valid = am.sum(dim=1)
    else:
        positions = None
        n_valid = torch.full((B,), T, dtype=torch.long, device=dev)
    logits, cache = decoder(
        inputs_embeds=inputs_embeds, attention_mask=attention_mask, positions=positions,
        kv_cache=cache.at(0), logits_indices=n_valid - 1, attn_impl=attn_impl,
    )
    return logits[:, 0].float(), cache, n_valid


# ---------------------------------------------------------------------------
# Decode as one program: the T=1 step on fixed-address tensors
# ---------------------------------------------------------------------------


class DecodeRunner:
    """One decode shape: its KV cache, the step's state tensors and, on a CUDA
    device, the step captured as a CUDA graph.

    A graph keeps the addresses of the tensors it was captured on, so the
    runner owns them for as long as it lives: the cache ``[L, B, H_kv,
    max_len, D]`` (prefill and :func:`_tile_pad_cache` write into it), the
    last token, each row's RoPE position, the shared write pointer
    (``length``, a 0-d tensor), ``done``, the key mask and the output
    ``[B, max_new_tokens]`` with its next column. The decoder's weights must
    stay where they were at capture. The step's kernels are K5
    (``decode_attention``, every layer, on the bf16 or int8 cache as it lies)
    and, with int8 weights, K4 (``int8_linear``, every Linear at B rows). A
    replay calls no wrapper, so :meth:`replay` adds the launches the capture
    recorded (``launches_per_step``) to the kernels' counts.
    """

    def __init__(self, decoder: LlamaDecoder, batch: int, max_len: int, config: GenerationConfig,
                 device: torch.device, mesh=None) -> None:
        c = decoder.cfg
        self.config = config
        self.cache = KVCache.create(c, batch, max_len, cache_dtype(config.kv_cache_dtype, c.compute_dtype), device,
                                    mesh=mesh, tp=decoder.tp)
        self.tp = decoder.tp
        self.token = torch.zeros(batch, dtype=torch.long, device=device)
        self.pos = torch.zeros(batch, dtype=torch.long, device=device)
        self.length = torch.zeros((), dtype=torch.long, device=device)
        self.column = torch.ones(1, dtype=torch.long, device=device)
        self.done = torch.zeros(batch, dtype=torch.bool, device=device)
        self.cache_mask = torch.ones((batch, max_len), dtype=torch.bool, device=device)
        self.out = torch.full((batch, config.max_new_tokens), config.pad_token_id, dtype=torch.long, device=device)
        self.generator = torch.Generator(device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.graph_logits: Optional[torch.Tensor] = None  # the captured step's logits, rewritten by each replay
        self.launches_per_step: Dict[str, int] = {}  # kernel launches one replay makes
        self.capture_s = 0.0

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold the step (:func:`_graph_capturable`)."""
        return _graph_capturable(self.token.device, self.cache.sp, self.tp)

    @property
    def mode(self) -> str:
        """How the step runs: "graph" (captured and replayed) or "eager"."""
        return "graph" if self.graph is not None else "eager"

    def step(self, decoder: LlamaDecoder) -> torch.Tensor:
        """One T=1 decode step on the runner's tensors, all of it on the device:
        decoder forward at the write pointer, EOS ban, token choice, pad after
        EOS, ``done``, and every pointer advanced by one. Returns the step's
        fp32 logits [B, V] (after the EOS ban)."""
        cfg = self.config
        logits, _ = decoder(
            input_ids=self.token[:, None], kv_cache=self.cache.at(self.length),
            attention_mask=self.cache_mask, positions=self.pos[:, None],
        )
        # pos = per-row sequence length so far (prompt + generated)
        step_logits = _ban_eos_below_min_length(logits[:, 0].float(), self.pos + 1, cfg)
        nxt = _sample_token(step_logits, cfg, self.generator)
        nxt = torch.where(self.done, torch.full_like(nxt, cfg.pad_token_id), nxt)
        self.done |= nxt == cfg.eos_token_id
        self.out.index_copy_(1, self.column, nxt[:, None])
        self.token.copy_(nxt)
        self.pos += 1
        self.length += 1
        self.column += 1
        return step_logits

    def capture(self, decoder: LlamaDecoder) -> None:
        """Capture :meth:`step` as a CUDA graph (after two warm-up steps on a
        side stream, as torch asks). Run before the runner's first prefill:
        the warm-up steps write cache rows. A capture that fails raises."""
        register = getattr(torch.cuda.CUDAGraph, "register_generator_state", None)
        if self.config.do_sample and register is None:
            raise RuntimeError("this torch cannot register a custom generator with a CUDA graph: no sampled decode")
        t0 = time.perf_counter()
        dev = self.token.device
        side = _capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                self.column.fill_(1)  # a warm-up step must not write past the output's last column
                self.step(decoder)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        if self.config.do_sample:
            graph.register_generator_state(self.generator)
        counted = A.launch_counts()
        with _capturing(graph, side):
            self.graph_logits = self.step(decoder)
        torch.cuda.synchronize(dev)
        # the capture recorded these launches; each replay makes them
        self.launches_per_step = A.launches_since(counted)
        A.add_launch_counts({k: -n for k, n in self.launches_per_step.items()})
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> torch.Tensor:
        """One captured step, its kernels' launches counted; returns the step's logits."""
        self.graph.replay()
        A.add_launch_counts(self.launches_per_step)
        return self.graph_logits

    def load(self, first: torch.Tensor, start_pos: torch.Tensor, cache_mask: torch.Tensor, length: int,
             generator: Optional[torch.Generator]) -> None:
        """Set the step's state for one request: the first sampled token, each
        row's position, the key mask over the whole cache, the write pointer
        (the rows written so far), and the caller's generator state."""
        cfg = self.config
        self.token.copy_(first)
        self.pos.copy_(start_pos)
        self.length.fill_(length)
        self.column.fill_(1)
        self.done.copy_(first == cfg.eos_token_id)
        self.cache_mask.copy_(cache_mask)
        self.out.fill_(cfg.pad_token_id)
        self.out[:, 0] = first
        if cfg.do_sample and generator is not None:
            self.generator.set_state(generator.get_state())

    def decode(self, decoder: LlamaDecoder) -> int:
        """Run up to ``max_new_tokens - 1`` steps (graph replays on a CUDA
        device, :meth:`step` on the CPU), reading ``done`` once every
        ``DECODE_SYNC_EVERY`` steps. Returns the steps run."""
        remaining, steps = self.config.max_new_tokens - 1, 0
        while remaining > 0 and not bool(self.done.all()):
            n = min(DECODE_SYNC_EVERY, remaining)
            for _ in range(n):
                if self.graph is not None:
                    self.replay()
                else:
                    self.step(decoder)
            remaining, steps = remaining - n, steps + n
        return steps

    def release(self) -> None:
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.graph_logits = self.cache = None


def decode_runner(decoder: LlamaDecoder, batch: int, max_len: int, config: GenerationConfig,
                  device: torch.device) -> Tuple[DecodeRunner, bool]:
    """The decoder's runner for (batch, cache length, config, device), made
    (and, on a CUDA device, captured where :attr:`DecodeRunner.capturable`)
    on first use: (runner, made now). At most ``MAX_DECODE_RUNNERS`` stay
    alive per decoder. The activation mesh in scope shards the runner's cache
    (see the module's text)."""
    runners = decoder.__dict__.setdefault("_decode_runners", OrderedDict())
    mesh = get_activation_mesh()
    key = (batch, max_len, config, str(device), mesh)
    runner = runners.get(key)
    if runner is not None:
        runners.move_to_end(key)
        return runner, False
    while len(runners) >= MAX_DECODE_RUNNERS:
        runners.popitem(last=False)[1].release()
    runner = DecodeRunner(decoder, batch, max_len, config, device, mesh)
    if runner.capturable:
        runner.capture(decoder)
    runners[key] = runner
    return runner, True


def release_decode_runners(decoder: LlamaDecoder) -> None:
    """Drop the decoder's runners (and their graphs): a captured step keeps
    the addresses of the weights it read, so replacing a weight's storage
    (a dtype change) must come with this."""
    for runner in decoder.__dict__.pop("_decode_runners", {}).values():
        runner.release()


def _decode(decoder: LlamaDecoder, runner: DecodeRunner, made: bool, first: torch.Tensor, start_pos: torch.Tensor,
            cache_mask: torch.Tensor, length: int, generator: Optional[torch.Generator],
            timings: Optional[Dict[str, float]]) -> torch.Tensor:
    with span("generate.decode", device=first.device, timings=timings, key="decode_s"):
        runner.load(first, start_pos, cache_mask, length, generator)
        steps = runner.decode(decoder)
        if runner.config.do_sample and generator is not None:
            generator.set_state(runner.generator.get_state())
        out = runner.out.clone()
    if timings is not None:
        timings["decode_steps"] = steps
        timings["decode_capture_s"] = runner.capture_s if made else 0.0
    return out


def _default_generator(config: GenerationConfig, generator: Optional[torch.Generator],
                       device: torch.device) -> Optional[torch.Generator]:
    if config.do_sample and generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    return generator


@torch.inference_mode()
def generate(
    decoder: LlamaDecoder,
    *,
    input_ids: Optional[torch.Tensor] = None,  # [B, T] right-padded
    inputs_embeds: Optional[torch.Tensor] = None,  # [B, T, E]
    attention_mask: Optional[torch.Tensor] = None,  # [B, T]
    config: GenerationConfig = GenerationConfig(),
    generator: Optional[torch.Generator] = None,
    max_cache_len: Optional[int] = None,
    attn_impl: str = "auto",
    timings: Optional[Dict[str, float]] = None,
) -> torch.Tensor:
    """Returns generated token ids ``[B, max_new_tokens]`` (prompt excluded).

    ``timings``, when given, receives ``prefill_s`` / ``decode_s`` /
    ``decode_steps`` measured with a device synchronisation at each phase
    boundary, and ``decode_capture_s``, the graph capture's time when this
    call made the runner (else 0; outside both phases)."""
    if inputs_embeds is None:
        inputs_embeds = decoder.embed_input_ids(input_ids)
    B, T = inputs_embeds.shape[:2]
    dev = inputs_embeds.device
    generator = _default_generator(config, generator, dev)
    cache_len = max_cache_len or (T + config.max_new_tokens)
    runner, made = decode_runner(decoder, B, cache_len, config, dev) if config.max_new_tokens > 1 else (None, False)

    with span("generate.prefill", device=dev, timings=timings, key="prefill_s"):
        last_logits, _, n_valid = prefill(decoder, inputs_embeds, attention_mask, cache_len, attn_impl,
                                          cache=None if runner is None else runner.cache,
                                          kv_cache_dtype=config.kv_cache_dtype)
        first = _sample_token(_ban_eos_below_min_length(last_logits, n_valid, config), config, generator)
    if runner is None:
        if timings is not None:
            timings.update(decode_s=0.0, decode_steps=0, decode_capture_s=0.0)
        return first[:, None]
    ones = torch.ones((B, cache_len - T), dtype=torch.bool, device=dev)
    if attention_mask is not None:
        cache_mask = torch.cat([attention_mask.bool(), ones], dim=1)
    else:
        cache_mask = torch.cat([torch.ones((B, T), dtype=torch.bool, device=dev), ones], dim=1)
    return _decode(decoder, runner, made, first, n_valid, cache_mask, T, generator, timings)


# ---------------------------------------------------------------------------
# Shared-prefix generation (video-prefix KV caching)
# ---------------------------------------------------------------------------


class VideoPrefix(NamedTuple):
    """A shared-video prefix cache plus the host-side facts that define which
    requests it may serve: the exact BOS ids baked into its first rows and
    the KV dtype it was built with. ``MERV.generate_batch_shared`` validates
    both before reuse."""

    cache: KVCache
    bos_ids: Tuple[int, ...]
    kv_cache_dtype: Optional[str]


@torch.inference_mode()
def prefill_prefix(
    decoder: LlamaDecoder,
    *,
    inputs_embeds: torch.Tensor,  # [1, P, E]: the shared prefix, no padding
    kv_cache_dtype: Optional[str] = None,
) -> KVCache:
    """Prefill a shared, pad-free prompt prefix into a fresh B=1 cache (in
    ``kv_cache_dtype``) whose buffer is exactly P rows (``length == P``): the
    suffix path tiles and extends it (:func:`generate_with_prefix`), and reads
    P from its shape."""
    B, P = inputs_embeds.shape[:2]
    if B != 1:
        raise ValueError(f"a shared prefix is per video (B=1), got B={B}")
    dtype = cache_dtype(kv_cache_dtype, decoder.cfg.compute_dtype)
    cache = KVCache.create(decoder.cfg, 1, P, dtype, inputs_embeds.device, tp=decoder.tp)
    _, cache = decoder(inputs_embeds=inputs_embeds, kv_cache=cache)
    return cache


def _tile_pad_cache(cache: KVCache, n: int, extra_rows: int, out: Optional[KVCache] = None) -> KVCache:
    """Broadcast a B=1 prefix cache to n rows and extend its buffer by
    ``extra_rows`` rows: into ``out`` (a decode runner's cache, whose rows past
    the prefix are written before any step reads them) or into a new cache
    (K and V zero-filled; int8 scales filled with 1.0, the neutral scale
    ``create`` uses). Shapes [L, B, H_kv, max_len, D]; returns ``length == P``."""
    L, _, H, P, D = cache.k.shape
    shape = (L, n, H, P + extra_rows, D)
    if out is not None and out.sp is not None:  # a sharded runner cache: each rank copies the rows it owns
        if (out.k.shape[1], out.max_len) != (n, P + extra_rows) or out.k.dtype != cache.k.dtype:
            raise ValueError(f"_tile_pad_cache: target cache {tuple(out.k.shape)} {out.k.dtype}, need {shape} "
                             f"{cache.k.dtype}")
        for dst, src in zip((out.k, out.v, out.k_scale, out.v_scale), (cache.k, cache.v, cache.k_scale,
                                                                       cache.v_scale)):
            if dst is not None:
                out.sp.copy_rows(dst, src.expand(L, n, *src.shape[2:]), P, 3)
        return out.at(P)
    if out is None:
        c = cache.k
        out = KVCache(torch.zeros(shape, dtype=c.dtype, device=c.device),
                      torch.zeros(shape, dtype=c.dtype, device=c.device), 0,
                      *((None, None) if cache.k_scale is None else
                        (torch.ones(shape[:-1] + (1,), dtype=torch.float32, device=c.device) for _ in range(2))))
    elif tuple(out.k.shape) != shape or out.k.dtype != cache.k.dtype:
        raise ValueError(f"_tile_pad_cache: target cache {tuple(out.k.shape)} {out.k.dtype}, need {shape} "
                         f"{cache.k.dtype}")
    out.k[:, :, :, :P] = cache.k
    out.v[:, :, :, :P] = cache.v
    if cache.k_scale is not None:
        out.k_scale[:, :, :, :P] = cache.k_scale
        out.v_scale[:, :, :, :P] = cache.v_scale
    return out.at(P)


@torch.inference_mode()
def prefill_with_prefix(
    decoder: LlamaDecoder,
    prefix_cache: KVCache,
    suffix_ids: torch.Tensor,  # [B, Ts] right-padded question tokens (post-BOS)
    suffix_mask: torch.Tensor,  # [B, Ts]
    decode_rows: int,
    cache: Optional[KVCache] = None,
) -> Tuple[torch.Tensor, KVCache, torch.Tensor, torch.Tensor]:
    """The suffix prefill of :func:`generate_with_prefix`: the prefix tiled
    into a cache of P + Ts + ``decode_rows`` positions (``cache``, or a new
    one), then the B suffixes written at P, each attending the prefix and its
    own suffix causally (K2 with ``q_offset = P`` and a key mask). Returns
    (fp32 logits of each row's last valid suffix position [B, V], cache,
    valid tokens per row P + n_valid [B], key mask over the whole cache:
    prefix valid, suffix pads invalid, decode rows valid)."""
    B, Ts = suffix_ids.shape
    P = prefix_cache.k.shape[3]
    if prefix_cache.k.shape[1] != 1:
        raise ValueError(f"prefix cache holds {prefix_cache.k.shape[1]} rows, not one video's")
    cache = _tile_pad_cache(prefix_cache, B, Ts + decode_rows, out=cache)
    dev = suffix_ids.device
    sm = suffix_mask.long()
    n_valid = sm.sum(dim=1)
    positions = P + (sm.cumsum(dim=1) - 1).clamp(min=0)
    cache_mask = torch.cat([
        torch.ones((B, P), dtype=torch.bool, device=dev), suffix_mask.bool(),
        torch.ones((B, decode_rows), dtype=torch.bool, device=dev),
    ], dim=1)
    logits, cache = decoder(
        inputs_embeds=decoder.embed_input_ids(suffix_ids), attention_mask=cache_mask, positions=positions,
        kv_cache=cache, logits_indices=(n_valid - 1).clamp(min=0),
    )
    return logits[:, 0].float(), cache, P + n_valid, cache_mask


@torch.inference_mode()
def generate_with_prefix(
    decoder: LlamaDecoder,
    prefix_cache: KVCache,
    *,
    suffix_ids: torch.Tensor,  # [B, Ts] right-padded question tokens (post-BOS)
    suffix_mask: torch.Tensor,  # [B, Ts]
    config: GenerationConfig = GenerationConfig(),
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Generate continuations of a shared cached prefix -> [B, max_new_tokens].

    Token-identical to :func:`generate` on the spliced ``[prefix | suffix_b]``
    sequences: suffix positions start at P, and ``logits_indices`` is
    ``max(n_valid - 1, 0)``. The prefix cache is tiled into the decode
    runner's buffer, so the caller's cache serves further question batches.
    Every suffix row must hold at least one valid token (``MERV.generate_batch_shared``
    checks); an all-pad row reads its first suffix position."""
    B, Ts = suffix_ids.shape
    P = prefix_cache.k.shape[3]
    dev = suffix_ids.device
    generator = _default_generator(config, generator, dev)
    max_new = config.max_new_tokens
    runner, made = decode_runner(decoder, B, P + Ts + max_new, config, dev) if max_new > 1 else (None, False)

    last_logits, _, total_valid, cache_mask = prefill_with_prefix(
        decoder, prefix_cache, suffix_ids, suffix_mask, max_new, cache=None if runner is None else runner.cache,
    )
    first = _sample_token(_ban_eos_below_min_length(last_logits, total_valid, config), config, generator)
    if runner is None:
        return first[:, None]
    return _decode(decoder, runner, made, first, total_valid, cache_mask, P + Ts, generator, None)


# ---------------------------------------------------------------------------
# Speculative decoding (prompt-lookup / n-gram drafting, no draft model)
# ---------------------------------------------------------------------------


def _ngram_propose(hist: torch.Tensor, hist_len: torch.Tensor, gamma: int, ngram: int, pad_id: int) -> torch.Tensor:
    """Propose ``gamma`` draft tokens per row: the most recent PREVIOUS
    occurrence of the row's last ``n`` tokens in its history, longest ``n``
    (``ngram``, ``ngram - 1``, ..., 1) first, and what followed it; no match
    gives pad tokens (they verify-reject at no extra cost).

    hist [B, Hc] (pad past ``hist_len``), hist_len [B] -> [B, gamma]. Static
    shapes, on the device, nothing read back: the counterpart of
    ``merv_tpu``'s ``_ngram_propose`` ``vmap``-ed over rows, including its
    clamped ``dynamic_slice`` starts."""
    B, Hc = hist.shape
    dev = hist.device
    W = Hc - ngram - gamma + 1  # starts whose n-gram window and draft read stay in bounds
    idx = torch.arange(W, device=dev)[None]
    best_start = torch.zeros(B, dtype=torch.long, device=dev)
    best_found = torch.zeros(B, dtype=torch.bool, device=dev)
    hist_len = hist_len.long()
    for n in range(ngram, 0, -1):
        key_start = (hist_len - n).clamp(0, Hc - n)
        key = hist.gather(1, key_start[:, None] + torch.arange(n, device=dev)[None])  # [B, n]
        match = torch.ones((B, W), dtype=torch.bool, device=dev)
        for j in range(n):
            match &= hist[:, j : W + j] == key[:, j : j + 1]
        match &= idx < (hist_len - n)[:, None]  # strictly previous: the current suffix starts at hist_len - n
        found = match.any(dim=1)
        last = (W - 1) - match.flip(1).to(torch.uint8).argmax(dim=1)  # the most recent match
        best_start = torch.where(found & ~best_found, last + n, best_start)  # the draft begins after it
        best_found |= found
    draft_start = best_start.clamp(0, Hc - gamma)
    draft = hist.gather(1, draft_start[:, None] + torch.arange(gamma, device=dev)[None])
    return torch.where(best_found[:, None], draft, torch.full_like(draft, pad_id))


def _spec_accept(probs: torch.Tensor, draft: torch.Tensor, generator: Optional[torch.Generator],
                 pad_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rejection sampling against a deterministic (delta) proposal: accept
    draft d_t with probability p_t(d_t); the first rejection emits a draw from
    the residual (p_t with d_t removed); full acceptance emits a bonus draw
    from p_gamma. Every position is marginally distributed as p_t, so sampled
    speculation is lossless in distribution.

    probs [B, gamma+1, V] (post-filter softmax), draft [B, gamma] ->
    ([B, gamma+1] tokens, pad past each row's count; [B] counts). Draws come
    from ``generator``; nothing is read back to the host."""
    B, G1, _ = probs.shape
    gamma = G1 - 1
    rows = torch.arange(B, device=probs.device)
    alive = torch.ones(B, dtype=torch.bool, device=probs.device)
    emit_n = torch.zeros(B, dtype=torch.long, device=probs.device)
    out = torch.full((B, G1), pad_id, dtype=torch.long, device=probs.device)
    pad = torch.full_like(emit_n, pad_id)
    for t in range(gamma):
        p_t, d_t = probs[:, t], draft[:, t].long()
        u = torch.rand(B, generator=generator, device=probs.device)
        accept = u < p_t[rows, d_t]
        resid = p_t.index_put((rows, d_t), torch.zeros_like(u))
        tok_t = torch.where(accept, d_t, _categorical(resid, generator))
        out[:, t] = torch.where(alive, tok_t, pad)
        emit_n += alive.long()
        alive &= accept
    out[:, gamma] = torch.where(alive, _categorical(probs[:, gamma], generator), pad)
    emit_n += alive.long()
    return out, emit_n


@torch.inference_mode()
def generate_speculative(
    decoder: LlamaDecoder,
    *,
    input_ids: Optional[torch.Tensor] = None,  # [1, T] right-padded
    inputs_embeds: Optional[torch.Tensor] = None,  # [1, T, E] (multimodal prefill)
    attention_mask: Optional[torch.Tensor] = None,  # [1, T]
    prompt_lookup_ids: Optional[torch.Tensor] = None,  # [1, T'] right-padded text ids: the draft corpus
    lookup_mask: Optional[torch.Tensor] = None,  # [1, T'] validity of prompt_lookup_ids
    config: GenerationConfig = GenerationConfig(),
    gamma: int = 4,
    ngram: int = 2,
    generator: Optional[torch.Generator] = None,
    max_cache_len: Optional[int] = None,
    attn_impl: str = "auto",
    timings: Optional[Dict[str, float]] = None,
) -> torch.Tensor:
    """Prompt-lookup speculative decoding at B=1 -> [1, max_new_tokens].

    Each step drafts ``gamma`` tokens by n-gram lookup in the prompt and the
    tokens so far (:func:`_ngram_propose`) and verifies them in one
    ``T = gamma + 1`` forward, which streams the same weights as a one-token
    step. Greedy output is token-identical to :func:`generate`; sampled output
    uses :func:`_spec_accept` (the same distribution, another random stream).

    The prefill is :func:`generate`'s. The verify forward keeps the cache
    length on the device, as a [1] per-slot pointer, so its attention (K5
    with a [1] causal offset; ``merv_tpu``'s runs XLA at this length) reads
    nothing back; the loop around it is a host loop that reads the step's ``done``
    and emit count once per verify step. That one read per step stands for
    ``merv_tpu``'s ``lax.while_loop``: the loop's end depends on the data, a
    read costs microseconds against a verify forward of milliseconds, and a
    captured graph would have to run a fixed number of steps past the end.
    The batched form that the serving engine captures as one CUDA graph per
    chunk is ``serving.engine._decode_chunk_spec``. ``timings`` receives
    ``prefill_s``, ``decode_s`` and ``decode_steps`` (verify steps)."""
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    if inputs_embeds is None:
        inputs_embeds = decoder.embed_input_ids(input_ids)
    B, T = inputs_embeds.shape[:2]
    if B != 1:
        raise ValueError(f"speculative decoding supports B=1 (got B={B}); rows with "
                         "different acceptance counts desync a shared scalar cache")
    if prompt_lookup_ids is None:
        if input_ids is None:
            raise ValueError("multimodal (inputs_embeds) speculative decoding needs "
                             "prompt_lookup_ids (the text token ids) for the draft corpus")
        prompt_lookup_ids, lookup_mask = input_ids, attention_mask
    dev = inputs_embeds.device
    generator = _default_generator(config, generator, dev)
    max_new, pad_id, eos_id = config.max_new_tokens, config.pad_token_id, config.eos_token_id
    cache_len = max_cache_len or (T + max_new + gamma + 1)

    with span("generate.prefill", device=dev, timings=timings, key="prefill_s"):
        # one row past cache_len: the per-slot path's scratch row
        last_logits, cache, n_valid = prefill(decoder, inputs_embeds, attention_mask, cache_len + 1, attn_impl,
                                              kv_cache_dtype=config.kv_cache_dtype)
        first = _sample_token(_ban_eos_below_min_length(last_logits, n_valid, config), config, generator)
    cache_mask = torch.ones((1, cache_len + 1), dtype=torch.bool, device=dev)
    if attention_mask is not None:
        cache_mask[:, :T] = attention_mask.bool()

    # draft corpus: the valid prompt tokens (contiguous from 0, right padding), then the first token
    lk = prompt_lookup_ids[0].long().to(dev)
    n_lookup = int(lookup_mask[0].sum()) if lookup_mask is not None else lk.shape[0]
    Hc = lk.shape[0] + max_new + 2 * gamma + ngram + 8
    hist = torch.full((1, Hc), pad_id, dtype=torch.long, device=dev)
    hist[0, : lk.shape[0]] = lk
    hist[0, n_lookup] = first[0]
    hist_len = torch.full((1,), n_lookup + 1, dtype=torch.long, device=dev)

    out = torch.full((1, max_new + gamma + 1), pad_id, dtype=torch.long, device=dev)
    out[:, 0] = first
    length = torch.full((1,), T, dtype=torch.long, device=dev)  # cache rows written (pads included)
    pos = n_valid.clone()  # RoPE position of the next token (valid tokens only)
    tok = first.clone()
    n_out = torch.ones(1, dtype=torch.long, device=dev)
    done = first == eos_id
    steps_v = torch.arange(gamma + 1, device=dev)
    eos_vec = torch.arange(decoder.cfg.vocab_size, device=dev) == eos_id

    with span("generate.decode", device=dev, timings=timings, key="decode_s"):
        steps = 0
        while not bool(done[0]) and int(n_out[0]) < max_new:  # the one host read per verify step
            draft = _ngram_propose(hist, hist_len, gamma, ngram, pad_id)  # [1, gamma]
            logits, _ = decoder(input_ids=torch.cat([tok[:, None], draft], dim=1), attention_mask=cache_mask,
                                positions=pos[:, None] + steps_v[None], kv_cache=cache.at(length))
            lg = logits[0].float()  # [gamma+1, V]
            if config.min_length > 1:
                lg = lg.masked_fill(((pos + 1 + steps_v) < config.min_length)[:, None] & eos_vec[None], float("-inf"))
            if config.do_sample:
                probs = torch.softmax(_filter_logits(lg, config), dim=-1)
                w_all, nat_emit = _spec_accept(probs[None], draft, generator, pad_id)
                w_all = w_all[0]
            else:
                w_all = lg.argmax(dim=-1)
                nat_emit = (draft[0] == w_all[:gamma]).long().cumprod(0).sum()[None] + 1
            is_eos = (w_all == eos_id) & (steps_v < nat_emit)
            has_eos = is_eos.any()[None]
            emit_n = torch.where(has_eos, is_eos.to(torch.uint8).argmax()[None] + 1, nat_emit)
            window = torch.where(steps_v < emit_n, w_all, torch.full_like(w_all, pad_id))
            out[0, n_out + steps_v] = window
            hist[0, hist_len.clamp(max=Hc - gamma - 1) + steps_v] = window
            tok = window[emit_n - 1]
            length += emit_n
            pos += emit_n
            hist_len += emit_n
            n_out += emit_n
            done |= has_eos
            steps += 1
    if timings is not None:
        timings.update(decode_steps=steps, decode_capture_s=0.0)
    keep = torch.arange(max_new, device=dev) < n_out
    return torch.where(keep, out[0, :max_new], torch.full_like(keep, pad_id, dtype=torch.long))[None]
