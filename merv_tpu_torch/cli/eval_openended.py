"""Open-ended QA evaluation (counterpart of ``scripts/eval_openended.py``).

    python -m merv_tpu_torch.cli.eval_openended --model_path <run> --eval_dataset dummy_openended [--device cpu] ...

The chunked jsonl protocol of :mod:`merv_tpu_torch.cli.eval_mcq`, plus:
- resume from partial output: this chunk's ``_done`` shard, else its temp
  shard, else the shards of a run with another ``num_chunks``;
- ``flops.json`` (forward GFLOPs and parameters) once per model, unless
  ``--skip_flops``;
- ``batch_size > 1`` batches each group into one prefill and one decode
  (``MERV.generate_batch``), with host decode run ahead (``prefetch_map``) and
  a failed group retried item by item; a failed item is logged and skipped;
- ``--speculative N`` (batch size 1 only) decodes by prompt-lookup
  speculation with draft length N;
- ``--use_engine`` serves the questions through the continuous-batching
  engine (:mod:`merv_tpu_torch.serving`) instead of groups: ``--engine_slots``
  decode slots, questions grouped by (video, clip) and, with
  ``--share_video_prefix``, each group of two or more sharing one
  ``[BOS | visual]`` prefix, registered in waves of ``--prefix_budget``;
  results stream to the shard as each question finishes; a failed question
  is logged and skipped; ``--batch_size`` is ignored;
- ``--serving_passes N`` serves the workload N times in-process and reports
  the last pass (the first holds the graph captures), writing results once;
  it prints one JSON line with ``serving_wall_s`` and ``questions_per_sec``
  (and the kernels' launch counts over the process, ``launches``).
Scoring happens downstream (``scripts/eval_gpt_batch.py``, an LLM judge).

``--quantize_llm`` serves the LLM with weight-only int8 Linears and
``--int8_kv`` keeps the KV cache in int8 (the batch, batch-1, speculative and
engine paths alike), as in ``merv_tpu``. The model runs on the card unless
``--device cpu`` is given. Not ported: ``--mesh_seq > 1`` (ROADMAP A12),
which raises ``NotImplementedError``.
"""

from __future__ import annotations

import glob
import json
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Union

import merv_tpu_torch.conf.registry as draccus
import merv_tpu_torch.ops.attention as A
from merv_tpu_torch.cli.eval_mcq import _clip, _resolve_video, get_chunk, load_model, refuse_unported
from merv_tpu_torch.models.generation import GenerationConfig
from merv_tpu_torch.models.vidlms.merv import _load_media
from merv_tpu_torch.overwatch import initialize_overwatch
from merv_tpu_torch.serving import ContinuousBatchingEngine, Request
from merv_tpu_torch.util.flops_utils import get_statistics
from merv_tpu_torch.util.prefetch import prefetch_map

overwatch = initialize_overwatch(__name__)


@dataclass
class EvalConfig:
    # fmt: off
    model_path: Union[str, Path] = "merv-full"
    hf_token: Union[str, Path] = Path(".hf_token")

    do_sample: bool = False
    temperature: float = 1.0
    max_new_tokens: int = 512
    min_length: int = 1
    eval_dataset: str = "MSVD"
    num_chunks: int = 1
    chunk_idx: int = 0
    filename_question: str = "test_q"
    filename_answer: str = "test_a"
    eval_data_root: Path = Path("eval_data")
    eval_result_root: Path = Path("eval_result")
    skip_flops: bool = False
    batch_size: int = 1                             # questions per prefill
    allow_random_weights: bool = False              # random-init fallback (speed tests ONLY)
    quantize_llm: bool = False                      # weight-only int8 LLM serving
    int8_kv: bool = False                           # int8 KV cache (half the cache bytes decode reads)
    mesh_seq: int = 1                               # sequence-sharded KV cache: not ported (ROADMAP A12)
    speculative: int = 0                            # prompt-lookup speculative decoding: draft length gamma
    #                                               # (batch_size 1 only; greedy output is unchanged)
    speculative_autodisable: bool = True            # (engine only) two-way monitor: plain decode below break-even,
    #                                               # back on when the trailing acceptance estimate recovers
    use_engine: bool = False                        # continuous-batching engine: per-slot retirement and
    #                                               # shared-video prefix caching; --batch_size is ignored
    engine_slots: int = 4                           # (engine only) concurrent decode slots
    serving_passes: int = 1                         # serve the workload N times in-process, report the LAST pass
    #                                               # (the first holds the decode graphs' captures); results
    #                                               # written once
    share_video_prefix: bool = True                 # (engine only) suffix-only admission per repeated video
    prefix_budget: int = 4                          # (engine only) most prefixes registered at once
    device: Optional[str] = None                    # the card unless "cpu"
    # fmt: on


@draccus.wrap()
def evaluate(cfg: EvalConfig) -> None:
    if cfg.speculative > 0 and cfg.batch_size != 1:
        raise ValueError(
            "--speculative requires --batch_size 1: per-row acceptance counts desync a shared batch cache (serve "
            "batched speculation through the continuous-batching engine, --use_engine or cli/serve.py)"
        )
    refuse_unported(cfg)
    result_dir = Path(cfg.eval_result_root) / str(cfg.model_path)
    result_dir.mkdir(parents=True, exist_ok=True)

    benchmark = cfg.eval_dataset.replace("_token", "")
    benchmark_dir = Path(cfg.eval_data_root) / benchmark
    questions = json.load(open(benchmark_dir / f"{cfg.filename_question}.json"))
    overwatch.info(f"Number of Questions in {benchmark}: {len(questions)}")
    all_questions_id = {item["question_id"] for item in questions}
    questions = get_chunk(questions, cfg.num_chunks, cfg.chunk_idx)

    answers = json.load(open(benchmark_dir / f"{cfg.filename_answer}.json"))
    answers_dict = {item["question_id"]: item for item in answers}

    vidlm, model_cfg = load_model(cfg)

    # FLOPs and parameters, once per model
    flops_path = result_dir / "flops.json"
    if not flops_path.exists() and not cfg.skip_flops:
        overwatch.info("Getting model statistics: FLOPs + Params")
        gflops, n_params = get_statistics(vidlm, num_frames=model_cfg.num_frames)
        overwatch.info(f"Model GFLOPs: {gflops}, Params: {n_params}")
        json.dump({"gflops": gflops, "params": n_params}, open(flops_path, "w"))

    tag = f"{cfg.eval_dataset}_pred_{cfg.num_chunks}"
    temp_output_path = result_dir / f"{tag}_{cfg.chunk_idx}.jsonl"
    done_output_path = result_dir / f"{tag}_{cfg.chunk_idx}_done.jsonl"
    merged_path = result_dir / f"{cfg.eval_dataset}_pred_merge.jsonl"

    # --- resume ---
    done_lines = []
    if done_output_path.exists():
        done_lines = open(done_output_path).readlines()
        done_ids = {json.loads(x)["question_id"] for x in done_lines}
        questions = [q for q in questions if q["question_id"] not in done_ids]
    elif temp_output_path.exists():
        done_lines = open(temp_output_path).readlines()
        done_ids = {json.loads(x)["question_id"] for x in done_lines}
        questions = [q for q in questions if q["question_id"] not in done_ids]
    else:
        previous = set(glob.glob(str(result_dir / f"{cfg.eval_dataset}_pred_*.jsonl"))) - set(
            glob.glob(str(result_dir / f"{tag}_*.jsonl"))
        )
        raw = [line for p in previous for line in open(p).readlines()]
        try:
            done_dict = {json.loads(x)["question_id"]: x for x in raw}
        except (json.JSONDecodeError, KeyError, TypeError):
            done_dict = {}
        done_lines = [done_dict[q["question_id"]] for q in questions if q["question_id"] in done_dict]
        questions = [q for q in questions if q["question_id"] not in done_dict]

    def _prep(question):
        prompt_builder = vidlm.llm_backbone.prompt_builder_fn(model_family="merv")
        prompt_builder.add_turn(role="human", message=question["question"])
        return prompt_builder.get_prompt(), _clip(question)

    def _generate_one(question, prompt_text, clip):
        video_name = _resolve_video(benchmark_dir, question["video_name"])
        return vidlm.generate(
            video_name, prompt_text, do_sample=cfg.do_sample, temperature=cfg.temperature,
            max_new_tokens=cfg.max_new_tokens, min_length=cfg.min_length, num_frames=model_cfg.num_frames,
            speculative_gamma=cfg.speculative, kv_cache_dtype="int8" if cfg.int8_kv else None, **clip,
        )

    def _decode_group(group):
        """Host-side: resolve + decode the group's videos to uint8 arrays, ahead
        of the card in prefetch_map's threads; a failure is kept per item."""
        arrays = []
        for q in group:
            try:
                name = _resolve_video(benchmark_dir, q["video_name"])
                arrays.append(_load_media(name, max(model_cfg.num_frames), **_clip(q)))
            except Exception as e:
                arrays.append(e)
        return arrays

    if cfg.use_engine:
        _engine_eval(cfg, vidlm, model_cfg, questions, answers_dict, benchmark_dir, _prep, done_lines,
                     temp_output_path)
        os.rename(temp_output_path, done_output_path)
        _merge_chunks(result_dir, tag, all_questions_id, merged_path)
        return

    groups = [questions[s : s + cfg.batch_size] for s in range(0, len(questions), cfg.batch_size)]

    # --serving_passes N: the first passes take the decode graphs' captures, the LAST pass measures steady
    # serving; results are written once, on the last pass
    passes = max(cfg.serving_passes, 1)
    pass_walls = []
    with open(temp_output_path, "w") as f:
        for line in done_lines:  # re-emit carried-over results
            f.write(line if line.endswith("\n") else line + "\n")
        for p in range(passes):
            write_results = p == passes - 1
            decoded_iter = (
                prefetch_map(groups, _decode_group) if cfg.batch_size > 1
                else ((g, None) for g in groups)
            )
            serve_t0 = time.perf_counter()
            for group, decoded in decoded_iter:
                prepped = [_prep(q) for q in group]
                preds = [None] * len(group)
                if cfg.batch_size > 1:
                    # one prefill + one decode per group; a failure falls back to the per-item path below
                    try:
                        if isinstance(decoded, Exception):
                            raise decoded
                        good = [i for i, a in enumerate(decoded) if not isinstance(a, Exception)]
                        if len(good) < len(group):
                            overwatch.error(f"{len(group) - len(good)} item(s) failed host decode; batching the rest")
                        if good:
                            sub_preds = vidlm.generate_batch(
                                [decoded[i] for i in good], [prepped[i][0] for i in good],
                                num_frames=model_cfg.num_frames, max_new_tokens=cfg.max_new_tokens,
                                do_sample=cfg.do_sample, temperature=cfg.temperature,
                                min_length=cfg.min_length, pad_to_batch=cfg.batch_size,
                                kv_cache_dtype="int8" if cfg.int8_kv else None,
                            )
                            for i, p_ in zip(good, sub_preds):
                                preds[i] = p_
                    except Exception as e:
                        overwatch.error(f"Batched generate failed ({type(e).__name__}: {e}); retrying per-item")
                        preds = [None] * len(group)
                for question, (prompt_text, clip), pred in zip(group, prepped, preds):
                    try:
                        if pred is None:  # batch-1 path or batch-failure retry
                            pred = _generate_one(question, prompt_text, clip)
                        if write_results:
                            out = {**question, **answers_dict[question["question_id"]]}
                            out["pred"] = pred
                            f.write(json.dumps(out) + "\n")
                    except Exception as e:  # per-video fault tolerance
                        overwatch.error(f"Failed on {question.get('question_id')}: {type(e).__name__}: {e}")
                # flush per group so a killed shard loses at most one group
                f.flush()
            pass_walls.append(time.perf_counter() - serve_t0)
    wall = pass_walls[-1]
    if questions:
        overwatch.info(
            f"Serving wall: {wall:.2f}s for {len(questions)} questions = {len(questions) / wall:.3f} questions/sec"
            + (f" (pass 1 incl. graph captures: {pass_walls[0]:.2f}s)" if passes > 1 else "")
        )
        print(json.dumps({
            "serving_wall_s": round(wall, 2), "questions": len(questions),
            "questions_per_sec": round(len(questions) / wall, 4) if wall else 0.0,
            "passes": passes, "cold_wall_s": round(pass_walls[0], 2), "launches": A.launch_counts(),
        }), flush=True)
    os.rename(temp_output_path, done_output_path)
    _merge_chunks(result_dir, tag, all_questions_id, merged_path)


def _merge_chunks(result_dir, tag, all_questions_id, merged_path) -> None:
    """The last finisher merges the shards."""
    all_jsonls = glob.glob(str(result_dir / f"{tag}_*_done.jsonl"))
    all_done_items = {
        item["question_id"]: item
        for jsonl in all_jsonls
        for line in open(jsonl).readlines()
        if line.strip() and (item := json.loads(line))
    }
    if len(all_questions_id - set(all_done_items.keys())) == 0:
        with open(merged_path, "w") as f:
            for item in all_done_items.values():
                f.write(json.dumps(item) + "\n")
        for jsonl in all_jsonls:
            os.remove(jsonl)
        overwatch.info(f"Merged predictions -> {merged_path}; score with scripts/eval_gpt_batch.py")


def _engine_eval(cfg, vidlm, model_cfg, questions, answers_dict, benchmark_dir, _prep, done_lines,
                 temp_output_path) -> None:
    """Continuous-batching engine serving for open-ended evaluation.

    In place of the group loop, a fixed pool of decode slots stays live
    (short answers retire their slot at once), and a repeated video
    registers one shared ``[BOS | visual]`` prefix so that its questions admit
    suffix-only. Questions group by (video, clip): a clipped question shares a
    prefix only with identically clipped ones. Waves of ``--prefix_budget``
    prefixes bound device memory. A corrupt video fails only its own
    questions. Results stream through the engine's ``result_callback`` into
    the shard (flushed per result), so the resume protocol holds: a killed
    shard loses at most the in-flight slots."""
    tok = vidlm.llm_backbone.tokenizer
    stop = vidlm.llm_backbone.stop_token_id
    gcfg = GenerationConfig(
        max_new_tokens=cfg.max_new_tokens, do_sample=cfg.do_sample, temperature=cfg.temperature,
        min_length=cfg.min_length, eos_token_id=stop, pad_token_id=vidlm.llm_backbone.pad_token_id,
        kv_cache_dtype="int8" if cfg.int8_kv else None,
    )
    by_q = {str(q["question_id"]): q for q in questions}

    # extra passes serve the same workload again in-process, so that the LAST
    # pass measures steady serving (the graph captures land in pass 1);
    # results are written only on the last pass
    passes = max(cfg.serving_passes, 1)
    write_results = [passes == 1]
    register_s = [0.0]
    with open(temp_output_path, "w") as f:
        for line in done_lines:  # re-emit carried-over results
            f.write(line if line.endswith("\n") else line + "\n")

        def on_result(res) -> None:
            if not write_results[0]:
                return
            q = by_q[res.request_id]
            if res.finish_reason == "error":
                # per-item fault tolerance: logged and skipped; the resume
                # protocol tries it again on the next run
                overwatch.error(f"Failed on {res.request_id}: {res.error}")
                return
            ids = res.token_ids.tolist()
            if stop in ids:
                ids = ids[: ids.index(stop)]
            out = {**q, **answers_dict[q["question_id"]]}
            out["pred"] = tok.decode(ids, skip_special_tokens=True).strip()
            f.write(json.dumps(out) + "\n")
            f.flush()  # a killed shard loses at most the in-flight slots

        engine = ContinuousBatchingEngine.for_vidlm(
            vidlm, slots=cfg.engine_slots, max_len=vidlm.llm_backbone.llm_max_length, steps_per_sync=8,
            config=gcfg, length_bucket=64, speculative_gamma=cfg.speculative,
            speculative_autodisable=cfg.speculative_autodisable, result_callback=on_result,
        )

        # group questions by (video, clip): identical prefixes share the towers
        # and the [BOS | visual] prefill through the engine's prefix caching
        vgroups: dict = {}
        order = []
        for q in questions:
            key = (q["video_name"], tuple(sorted(_clip(q).items())))
            if key not in vgroups:
                vgroups[key] = []
                order.append(key)
            vgroups[key].append(q)

        budget = max(cfg.prefix_budget, 1)
        wave_keys: list = []

        def run_wave() -> None:
            if not wave_keys:
                return
            live = []
            for key in wave_keys:
                video_name, clip_items = key
                group = vgroups[key]
                try:
                    path = _resolve_video(benchmark_dir, video_name)
                    video = _load_media(path, max(model_cfg.num_frames), **dict(clip_items))
                except Exception as e:
                    overwatch.error(f"{len(group)} question(s) failed: video {video_name} ({type(e).__name__}: {e})")
                    continue
                pid = None
                if cfg.share_video_prefix and len(group) >= 2:
                    pid = f"video:{video_name}:{hash(clip_items) & 0xFFFFFFFF:x}"
                    try:
                        t0 = time.perf_counter()
                        engine.register_prefix_video(pid, video, num_frames=model_cfg.num_frames)
                        register_s[-1] += time.perf_counter() - t0
                        live.append(pid)
                    except Exception as e:
                        overwatch.error(f"prefix build failed for {video_name} ({type(e).__name__}: {e}); serving "
                                        "un-shared")
                        pid = None
                for q in group:
                    prompt_text, _ = _prep(q)
                    engine.submit(Request(
                        request_id=str(q["question_id"]), prompt_text=prompt_text, video=None if pid else video,
                        prefix_id=pid, max_new_tokens=cfg.max_new_tokens,
                    ))
            engine.run()
            for pid in live:
                engine.unregister_prefix(pid)
            wave_keys.clear()

        pass_walls = []
        prev = None
        for p in range(passes):
            write_results[0] = p == passes - 1
            if p:
                register_s.append(0.0)
            s = engine.stats
            prev = (s.admit_s, s.decode_s, s.prefills, s.prefix_admissions, s.errors, len(s.ttft_s))
            t0 = time.perf_counter()
            for key in order:
                wave_keys.append(key)
                if len(wave_keys) >= budget:
                    run_wave()
            run_wave()
            pass_walls.append(time.perf_counter() - t0)

    # the last pass's deltas: with extra passes the cumulative stats would count twice
    s = engine.stats
    prefills, prefix_admissions, errors = s.prefills - prev[2], s.prefix_admissions - prev[3], s.errors - prev[4]
    ttft = sorted(s.ttft_s[prev[5]:])
    wall = pass_walls[-1]
    served = len(questions) - errors
    overwatch.info(
        f"Engine served chunk: slot utilization {s.slot_utilization:.1%}, {prefills} prefills ({prefix_admissions} "
        f"suffix-only), {s.decode_chunks} chunks" + (f", {errors} failed" if errors else "")
        + (f", {s.tokens_per_step:.2f} tokens/verify-step" if cfg.speculative else "")
    )
    overwatch.info(
        f"Serving wall: {wall:.2f}s for {served} questions = {served / wall:.3f} questions/sec"
        + (f" (pass 1 incl. graph captures: {pass_walls[0]:.2f}s)" if passes > 1 else "")
    )
    print(json.dumps({
        "serving_wall_s": round(wall, 2), "questions": served,
        "questions_per_sec": round(served / wall, 4) if wall else 0.0,
        "prefills": prefills, "prefix_admissions": prefix_admissions,
        "passes": passes, "cold_wall_s": round(pass_walls[0], 2),
        "admit_s": round(s.admit_s - prev[0], 2), "decode_s": round(s.decode_s - prev[1], 2),
        "register_s": round(register_s[-1], 2),
        "ttft_p50_ms": round(1e3 * ttft[len(ttft) // 2], 1) if ttft else None,
        "launches": A.launch_counts(),
    }), flush=True)


if __name__ == "__main__":
    evaluate()
