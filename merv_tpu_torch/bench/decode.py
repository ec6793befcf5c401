"""Decode throughput and TTFT (counterpart of ``scripts/bench_decode.py``).

On the bench model (:func:`~merv_tpu_torch.benchkit.build_model`) with random
bf16 weights:

- p50 TTFT: the multimodal prefill (towers, projectors and fusion, the LLM
  prefill) and the first token read back to the host, 3 runs after a warm one;
- decode tokens/s: ``(t_N - t_1) / (N - 1)`` per token, where ``t_n`` is the
  time of ``n`` decode steps, each timed run starting from a fresh prefill's
  cache (``merv_tpu``'s ``_decode_scan`` donates its cache, so it refills it
  the same way).

``merv_tpu`` runs the decode loop as one ``lax.scan`` program. Here it is
:class:`~merv_tpu_torch.models.generation.DecodeRunner`'s T = 1 step captured
as a CUDA graph and replayed (on the CPU the same step runs eagerly), so the
steps launch K5 (``decode_attention``) once a layer and, with
``BENCH_INT8=1``, K4 (``int8_linear``) once a Linear.

Env: ``BENCH_LLM_LAYERS`` (16), ``BENCH_BATCH`` (1), ``BENCH_DECODE_STEPS``
(128), ``BENCH_INT8`` / ``BENCH_INT8_KV`` (0), ``BENCH_TOWERS`` (merv).
Prints the launch counts, then one JSON line: ``metric``,
``decode_tokens_per_sec``, ``ttft_p50_sec``, ``unit``, plus the work it
timed (``prefills``, ``decode_steps``) and the device.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import torch

from merv_tpu_torch import benchkit
from merv_tpu_torch.device import resolve_device

PROMPT_TOKENS = 64


@torch.inference_mode()
def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="the card unless 'cpu' (the tiny model)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    from merv_tpu_torch.models.generation import GenerationConfig, _sample_token, _sync, decode_runner, prefill

    layers = int(os.environ.get("BENCH_LLM_LAYERS", "16"))
    batch = int(os.environ.get("BENCH_BATCH", "1"))
    steps = int(os.environ.get("BENCH_DECODE_STEPS", "128"))
    int8 = os.environ.get("BENCH_INT8", "0") == "1"
    int8_kv = os.environ.get("BENCH_INT8_KV", "0") == "1"
    model = benchkit.make_bench_params(benchkit.build_model(layers, tiny=dev.type == "cpu", device=dev), int8=int8)

    T = PROMPT_TOKENS
    input_ids = torch.full((batch, T), 5, dtype=torch.long, device=dev)
    input_ids[:, 0] = 1
    attention_mask = torch.ones((batch, T), dtype=torch.long, device=dev)
    videos = [torch.zeros((batch, *vb.default_video_resolution), dtype=torch.bfloat16, device=dev)
              for vb in model.video_backbones]
    dec = model.llm_backbone.decoder
    total = T + model.visual_feature_length
    # one column more than the longest timed run: the runner's output holds the first token too
    gen_cfg = GenerationConfig(max_new_tokens=steps + 1, eos_token_id=-1, pad_token_id=0,
                               kv_cache_dtype="int8" if int8_kv else None)
    cache_len = total + steps + 1
    runner, _ = decode_runner(dec, batch, cache_len, gen_cfg, dev)
    cache_mask = torch.ones((batch, cache_len), dtype=torch.bool, device=dev)
    work = {"prefills": 0, "decode_steps": 0}

    def prefill_first() -> torch.Tensor:
        embeds, mask = model.build_inputs_embeds(input_ids, attention_mask, videos)
        logits, _, n_valid = prefill(dec, embeds, mask.long(), cache_len, cache=runner.cache,
                                     kv_cache_dtype=gen_cfg.kv_cache_dtype)
        work["prefills"] += 1
        return _sample_token(logits, gen_cfg, None), n_valid

    # --- TTFT: prefill + first-token fetch
    int(prefill_first()[0][0])  # warm
    ttfts = []
    for _ in range(3):
        t0 = time.perf_counter()
        first, _ = prefill_first()
        int(first[0])
        ttfts.append(time.perf_counter() - t0)
    ttft_p50 = sorted(ttfts)[len(ttfts) // 2]

    # --- decode: (t_N - t_1) / (N - 1), each timed run from a fresh (untimed) prefill's cache
    def timed_decode(n: int) -> float:
        first, n_valid = prefill_first()
        runner.load(first, n_valid, cache_mask, total, None)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            if runner.graph is not None:
                runner.replay()
            else:
                runner.step(dec)
        int(runner.out[0, n])
        work["decode_steps"] += n
        return time.perf_counter() - t0

    timed_decode(1)
    timed_decode(steps)
    t1 = min(timed_decode(1) for _ in range(2))
    tN = min(timed_decode(steps) for _ in range(2))
    per_tok = max((tN - t1) / (steps - 1), 1e-9)
    towers_tag = os.environ.get("BENCH_TOWERS", "merv")
    return benchkit.emit({
        "metric": f"{towers_tag} decode tokens/sec + p50 TTFT (llm depth {layers}/32, bsz {batch}"
                  + (", int8 weights" if int8 else "") + (", int8 kv" if int8_kv else "") + ")",
        "decode_tokens_per_sec": round(batch / per_tok, 2),
        "ttft_p50_sec": round(ttft_p50, 4),
        "unit": "tokens/sec; sec",
        **work, "captured_steps": 2 if runner.graph is not None else 0,
        "layers": layers, "batch": batch, "int8": int8, "int8_kv": int8_kv,
    }, dev)


if __name__ == "__main__":
    main()
