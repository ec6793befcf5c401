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
- ``--serving_passes N`` serves the workload N times in-process and reports
  the last pass (the first holds the graph captures), writing results once;
  it prints one JSON line with ``serving_wall_s`` and ``questions_per_sec``.
Scoring happens downstream (``scripts/eval_gpt_batch.py``, an LLM judge).

The model runs on the card unless ``--device cpu`` is given. Not ported:
``--use_engine`` and ``--speculative > 0`` (ROADMAP A9), ``--int8_kv`` (A4),
``--quantize_llm`` (A2), ``--mesh_seq > 1`` (A12); each raises
``NotImplementedError``.
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
from merv_tpu_torch.cli.eval_mcq import _clip, _resolve_video, get_chunk, load_model, refuse_unported
from merv_tpu_torch.models.vidlms.merv import _load_media
from merv_tpu_torch.overwatch import initialize_overwatch
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
    quantize_llm: bool = False                      # int8 LLM weights: not ported (ROADMAP A2)
    int8_kv: bool = False                           # int8 KV cache: not ported (ROADMAP A4)
    mesh_seq: int = 1                               # sequence-sharded KV cache: not ported (ROADMAP A12)
    speculative: int = 0                            # prompt-lookup speculative decoding: not ported (ROADMAP A9)
    speculative_autodisable: bool = True            # (engine only)
    use_engine: bool = False                        # continuous-batching engine: not ported (ROADMAP A9)
    engine_slots: int = 4                           # (engine only)
    serving_passes: int = 1                         # serve the workload N times in-process, report the LAST pass
    #                                               # (the first holds the decode graphs' captures); results
    #                                               # written once
    share_video_prefix: bool = True                 # (engine only)
    prefix_budget: int = 4                          # (engine only)
    device: Optional[str] = None                    # the card unless "cpu"
    # fmt: on


@draccus.wrap()
def evaluate(cfg: EvalConfig) -> None:
    if cfg.use_engine:
        raise NotImplementedError("--use_engine: the continuous-batching engine is not ported yet (ROADMAP A9)")
    if cfg.speculative > 0:
        raise NotImplementedError("--speculative: prompt-lookup speculative decoding is not ported yet (ROADMAP A9)")
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
            max_new_tokens=cfg.max_new_tokens, min_length=cfg.min_length, num_frames=model_cfg.num_frames, **clip,
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
            "passes": passes, "cold_wall_s": round(pass_walls[0], 2),
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


if __name__ == "__main__":
    evaluate()
