"""Autoregressive generation over the decoder (counterpart of ``merv_tpu/models/generation.py``).

:func:`prefill` writes the prompt (or the multimodal embedding stream) into a
fresh KV cache and returns the last valid position's logits; :func:`generate`
then decodes greedily or by sampling in a Python loop (``lax.scan`` in JAX),
with EOS semantics (tokens after EOS become ``pad_token_id``), right-padded
batches (RoPE positions count valid tokens only) and min-length EOS banning.
Sampling draws from an explicit ``torch.Generator``. Prefix sharing and
speculative decoding wait for the serving slice (ROADMAP A9).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from merv_tpu_torch.models.backbones.llm.transformer import KVCache, LlamaDecoder


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


def _sample_token(logits: torch.Tensor, cfg: GenerationConfig, generator: Optional[torch.Generator]) -> torch.Tensor:
    """logits [B, V] fp32 -> [B] int64."""
    if not cfg.do_sample:
        return logits.argmax(dim=-1)
    probs = torch.softmax(_filter_logits(logits, cfg), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _ban_eos_below_min_length(logits: torch.Tensor, cur_len: torch.Tensor, cfg: GenerationConfig) -> torch.Tensor:
    """logits [B, V], cur_len [B]: ban EOS while cur_len < min_length."""
    if cfg.min_length <= 1:
        return logits
    suppress = (cur_len < cfg.min_length)[:, None]
    is_eos = (torch.arange(logits.shape[-1], device=logits.device) == cfg.eos_token_id)[None, :]
    return logits.masked_fill(suppress & is_eos, float("-inf"))


def _sync(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


@torch.inference_mode()
def prefill(
    decoder: LlamaDecoder,
    inputs_embeds: torch.Tensor,  # [B, T, E]
    attention_mask: Optional[torch.Tensor],  # [B, T]
    cache_len: int,
    attn_impl: str = "auto",
) -> Tuple[torch.Tensor, KVCache, torch.Tensor]:
    """Fill a new cache of ``cache_len`` positions with the prompt.
    Returns (fp32 logits of each row's last valid position [B, V], cache,
    valid-token counts [B])."""
    B, T = inputs_embeds.shape[:2]
    dev = inputs_embeds.device
    cache = KVCache.create(decoder.cfg, B, cache_len, decoder.cfg.compute_dtype, dev)
    if attention_mask is not None:
        am = attention_mask.long()
        positions = (am.cumsum(dim=1) - 1).clamp(min=0)
        n_valid = am.sum(dim=1)
    else:
        positions = None
        n_valid = torch.full((B,), T, dtype=torch.long, device=dev)
    logits, cache = decoder(
        inputs_embeds=inputs_embeds, attention_mask=attention_mask, positions=positions,
        kv_cache=cache, logits_indices=n_valid - 1, attn_impl=attn_impl,
    )
    return logits[:, 0].float(), cache, n_valid


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
    boundary (so it costs two syncs per call and nothing when omitted)."""
    if inputs_embeds is None:
        inputs_embeds = decoder.embed_input_ids(input_ids)
    B, T = inputs_embeds.shape[:2]
    dev = inputs_embeds.device
    if config.do_sample and generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    cache_len = max_cache_len or (T + config.max_new_tokens)

    t0 = _sync(dev) if timings is not None else 0.0
    last_logits, cache, n_valid = prefill(decoder, inputs_embeds, attention_mask, cache_len, attn_impl)
    first = _sample_token(_ban_eos_below_min_length(last_logits, n_valid, config), config, generator)
    if timings is not None:
        t1 = _sync(dev)
        timings["prefill_s"] = t1 - t0

    out = torch.full((B, config.max_new_tokens), config.pad_token_id, dtype=torch.long, device=dev)
    out[:, 0] = first
    if attention_mask is not None:
        cache_mask = torch.cat(
            [attention_mask.bool(), torch.ones((B, cache_len - T), dtype=torch.bool, device=dev)], dim=1
        )
    else:
        cache_mask = None
    token, pos = first, n_valid.clone()
    done = first == config.eos_token_id
    steps = 0
    for step in range(1, config.max_new_tokens):
        if bool(done.all()):  # every row has emitted EOS: the rest stays pad
            break
        logits, cache = decoder(
            input_ids=token[:, None], kv_cache=cache, attention_mask=cache_mask,
            positions=pos[:, None], attn_impl=attn_impl,
        )
        step_logits = _ban_eos_below_min_length(logits[:, 0].float(), pos + 1, config)
        nxt = _sample_token(step_logits, config, generator)
        nxt = torch.where(done, torch.full_like(nxt, config.pad_token_id), nxt)
        done = done | (nxt == config.eos_token_id)
        out[:, step] = nxt
        token, pos = nxt, pos + 1
        steps += 1
    if timings is not None:
        timings["decode_s"] = _sync(dev) - t1
        timings["decode_steps"] = steps
    return out
