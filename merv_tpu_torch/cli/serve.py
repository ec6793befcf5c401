"""Offline batch serving: continuous batching over a request file (counterpart of ``scripts/serve.py``).

    python -m merv_tpu_torch.cli.serve --model_path <run> --requests reqs.jsonl --output out.jsonl \\
        --slots 4 [--speculative 4] [--share_video_prefix false] [--device cpu]

Request file, one JSON object per line::

    {"request_id": "q1", "prompt": "In: what happens?\\nOut: ",
     "video": "path/to/clip.mp4",        # optional; null or absent = text only
     "max_new_tokens": 128}               # optional, default --max_new_tokens

Each result is appended to ``--output`` as one JSON line the moment its
request finishes (``request_id``, ``text``, ``finish_reason``,
``num_tokens``, and ``error`` for a failed request), so a rerun with
``--resume`` (the default) skips every request already there. With
``--share_video_prefix`` (the default) every video named by two or more
requests gets one shared ``[BOS | visual]`` prefix, registered in waves of
``--prefix_budget``, and its requests admit suffix-only; a video whose
prefix build fails serves its requests un-shared (each then fails on its
own). ``--speculative N`` turns on batched prompt-lookup speculation with
draft length N. The last line on stdout is one JSON object with the run's
numbers (walls, tokens/s, time to first token, slot utilisation, prefill
stall share, the engine's program counts and the kernels' launches).

``--quantize_llm`` serves the LLM with weight-only int8 Linears and
``--int8_kv`` keeps the engine's slot cache (and the shared prefixes) in
int8, as in ``merv_tpu``. The model runs on the card unless ``--device cpu``
is given.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Union

import torch

import merv_tpu_torch.conf.registry as draccus
import merv_tpu_torch.ops.attention as A
from merv_tpu_torch.models.generation import GenerationConfig
from merv_tpu_torch.models.load_vid import load_vid
from merv_tpu_torch.overwatch import initialize_overwatch
from merv_tpu_torch.serving import ContinuousBatchingEngine, Request

overwatch = initialize_overwatch(__name__)


@dataclass
class ServeConfig:
    # fmt: off
    model_path: Union[str, Path] = "merv-full"  # run directory under runs/, or a local path
    requests: Path = Path("requests.jsonl")
    output: Path = Path("serve_results.jsonl")

    slots: int = 4                       # concurrent decode slots
    max_len: int = 4096                  # per-slot prompt + output bound
    steps_per_sync: int = 8              # decode steps between host syncs
    max_new_tokens: int = 128            # default per-request budget
    do_sample: bool = False
    temperature: float = 1.0
    top_p: float = 1.0
    min_length: int = 1

    quantize_llm: bool = False           # weight-only int8 LLM
    int8_kv: bool = False                # int8 KV cache
    speculative: int = 0                 # batched prompt-lookup speculation: draft length gamma
    speculative_ngram: int = 2
    speculative_autodisable: bool = True  # two-way monitor: plain decode below break-even, back on (gamma
    #                                     # from the measured cost table) when the acceptance estimate recovers
    share_video_prefix: bool = True      # one tower + prefix prefill per video named twice or more
    prefix_budget: int = 4               # most prefixes registered at once (device memory)
    resume: bool = True                  # skip request_ids already in --output
    allow_random_weights: bool = False   # structure / throughput testing ONLY
    device: Optional[str] = None         # the card unless "cpu"
    # fmt: on


@draccus.wrap()
def serve(cfg: ServeConfig) -> None:
    local_run = Path("runs") / str(cfg.model_path)
    src = str(local_run) if local_run.exists() else str(cfg.model_path)
    vidlm = load_vid(src, allow_random_weights=cfg.allow_random_weights, quantize_llm=cfg.quantize_llm,
                     device=cfg.device)
    dev = vidlm.device

    # resume: results append line by line the moment each request finishes, so
    # a crash loses at most the in-flight slots; a rerun skips what is on disk
    done: set = set()
    if cfg.resume and Path(cfg.output).exists():
        with open(cfg.output) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        done.add(str(json.loads(line)["request_id"]))
                    except (json.JSONDecodeError, KeyError):
                        continue  # a torn final line from a crash: served again
        if done:
            overwatch.info(f"Resuming: {len(done)} results already in {cfg.output}")

    tok = vidlm.llm_backbone.tokenizer
    stop = vidlm.llm_backbone.stop_token_id
    out_f = open(cfg.output, "a" if cfg.resume else "w")
    totals = {"tokens": 0, "errors": 0}

    def write_result(res) -> None:
        ids = res.token_ids.tolist()
        if stop in ids:
            ids = ids[: ids.index(stop)]
        totals["tokens"] += len(ids)
        rec = {
            "request_id": res.request_id,
            "text": tok.decode(ids, skip_special_tokens=True).strip(),
            "finish_reason": res.finish_reason,
            "num_tokens": len(ids),
        }
        if res.finish_reason == "error":
            rec["error"] = res.error
            totals["errors"] += 1
        out_f.write(json.dumps(rec) + "\n")
        out_f.flush()

    gcfg = GenerationConfig(
        max_new_tokens=cfg.max_new_tokens, do_sample=cfg.do_sample, temperature=cfg.temperature, top_p=cfg.top_p,
        min_length=cfg.min_length, eos_token_id=stop, pad_token_id=vidlm.llm_backbone.pad_token_id,
        kv_cache_dtype="int8" if cfg.int8_kv else None,
    )
    engine = ContinuousBatchingEngine.for_vidlm(
        vidlm, slots=cfg.slots, max_len=cfg.max_len, steps_per_sync=cfg.steps_per_sync, config=gcfg,
        speculative_gamma=cfg.speculative, speculative_ngram=cfg.speculative_ngram,
        speculative_autodisable=cfg.speculative_autodisable, result_callback=write_result,
    )

    n, skipped = 0, 0
    pending = []
    video_counts: dict = {}
    with open(cfg.requests) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            r = json.loads(line)
            rid = str(r.get("request_id", n + skipped))
            if rid in done:
                skipped += 1
                continue
            pending.append((rid, r))
            vid = r.get("video")
            if isinstance(vid, str):
                video_counts[vid] = video_counts.get(vid, 0) + 1
            n += 1

    def submit_plain(rid: str, r: dict) -> None:
        engine.submit(Request(
            request_id=rid, prompt_text=r["prompt"], video=r.get("video"),
            max_new_tokens=int(r.get("max_new_tokens", cfg.max_new_tokens)),
        ))

    overwatch.info(f"Serving {n} requests on {cfg.slots} slots" + (f" ({skipped} already done, skipped)"
                                                                   if skipped else ""))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = A.launch_counts()
    prefix_builds = 0
    t0 = time.perf_counter()
    if cfg.share_video_prefix:
        # prefix caching: register each repeated video once so that its
        # requests admit suffix-only, in waves of --prefix_budget with
        # unregister after each wave, so that many videos never hold more than
        # budget x one prefix's memory
        shared_videos = [v for v, c in video_counts.items() if c >= 2]
        by_video: dict = {v: [] for v in shared_videos}
        rest = []
        for rid, r in pending:
            vid = r.get("video")
            if isinstance(vid, str) and vid in by_video:
                by_video[vid].append((rid, r))
            else:
                rest.append((rid, r))
        if shared_videos:
            overwatch.info(f"{len(shared_videos)} videos shared by {sum(len(v) for v in by_video.values())} "
                           f"requests: serving in waves of {cfg.prefix_budget} prefixes")
        budget = max(cfg.prefix_budget, 1)
        for w in range(0, len(shared_videos), budget):
            live = []
            for vid in shared_videos[w : w + budget]:
                pid = f"video:{vid}"
                try:
                    engine.register_prefix_video(pid, vid)
                except Exception as e:
                    overwatch.warning(f"prefix build failed for {vid} ({type(e).__name__}: {e}): its "
                                      f"{len(by_video[vid])} requests serve un-shared")
                    rest.extend(by_video[vid])
                    continue
                prefix_builds += 1
                live.append(pid)
                for rid, r in by_video[vid]:
                    engine.submit(Request(
                        request_id=rid, prompt_text=r["prompt"], prefix_id=pid,
                        max_new_tokens=int(r.get("max_new_tokens", cfg.max_new_tokens)),
                    ))
            engine.run()
            for pid in live:
                engine.unregister_prefix(pid)
        for rid, r in rest:
            submit_plain(rid, r)
    else:
        for rid, r in pending:
            submit_plain(rid, r)
    engine.run()  # the rest: un-shared requests (the prefix waves ran above)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    out_f.close()

    s = engine.stats
    overwatch.info(
        f"Served {n} requests in {wall:.1f}s ({totals['tokens'] / max(wall, 1e-9):.1f} tok/s): slot utilization "
        f"{s.slot_utilization:.1%}, {s.prefills} prefills, {s.decode_chunks} chunks"
        + (f", {s.prefix_admissions} suffix-only admissions" if s.prefix_admissions else "")
        + (f", {s.errors} failed (finish_reason=error)" if s.errors else "")
        + (f", {s.tokens_per_step:.2f} tokens/verify-step" if cfg.speculative else "")
    )
    ttft = sorted(s.ttft_s.values())
    overwatch.info(
        f"Phases: admit {s.admit_s:.2f}s, decode {s.decode_s:.2f}s (chunk graph captures {s.capture_s:.2f}s), "
        f"prefill stall share {s.prefill_stall_share:.3f}"
        + (f", ttft p50 {1e3 * ttft[len(ttft) // 2]:.0f}ms" if ttft else "")
    )
    overwatch.info(f"Results -> {cfg.output}")
    launches = {k: v - launches0[k] for k, v in A.launch_counts().items()}
    print(json.dumps({
        "requests": n, "errors": totals["errors"], "wall_s": wall, "requests_per_s": n / wall if wall else 0.0,
        "tokens": totals["tokens"], "tokens_per_s": totals["tokens"] / wall if wall else 0.0,
        "ttft_p50_ms": 1e3 * ttft[len(ttft) // 2] if ttft else None,
        "slot_utilization": s.slot_utilization, "prefill_stall_share": s.prefill_stall_share,
        "admit_s": s.admit_s, "decode_s": s.decode_s, "capture_s": s.capture_s,
        "prefills": s.prefills, "suffix_prefills": s.suffix_prefills, "prefix_admissions": s.prefix_admissions,
        "prefix_builds": prefix_builds, "decode_chunks": s.decode_chunks, "decode_forwards": s.decode_forwards,
        "prefill_shapes": [list(p) for p in s.prefill_shapes], "prefix_rows": s.prefix_rows, "spec_steps": s.spec_steps,
        "tokens_per_step": s.tokens_per_step, "spec_disables": s.spec_disables, "spec_reenables": s.spec_reenables,
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None,
        "peak_reserved_gib": torch.cuda.max_memory_reserved(dev) / 2**30 if dev.type == "cuda" else None,
        "launches": launches,
    }), flush=True)


if __name__ == "__main__":
    serve()
