"""Multiple-choice QA evaluation (counterpart of ``scripts/eval_mcq.py``).

    python -m merv_tpu_torch.cli.eval_mcq --model_path <run> --eval_dataset dummy_mcq [--device cpu] ...

The chunk-parallel protocol of ``merv_tpu``'s driver: per-chunk jsonl shards
named ``{dataset}_{strategy}_pred_{num_chunks}_{chunk_idx}.jsonl``, renamed to
``*_done.jsonl`` on completion; the last finisher merges the shards into
``{dataset}_{strategy}_pred_merge.jsonl`` and scores first-letter accuracy
into ``{dataset}_{strategy}_gpt.json``. ``batch_size > 1`` batches questions
into one prefill and one decode (``MERV.generate_batch``); ``--strategy
likelihood`` reads the answer from one forward's letter-token logits
(``MERV.score_options``); ``--share_video_prefix`` groups questions by video
and runs the towers and the ``[BOS | visual]`` prefill once per video
(``MERV.generate_batch_shared``), reusing the prefix across groups of the same
video. Host video decode runs ahead of the card (``prefetch_map``); a group
that fails is retried item by item, and an item that fails is logged and
skipped, as ``merv_tpu``'s driver does.

``--quantize_llm`` serves the LLM with weight-only int8 Linears and
``--int8_kv`` keeps the KV cache in int8, as in ``merv_tpu``. The model runs
on the card unless ``--device cpu`` is given.

``--mesh_seq N`` serves with the KV cache sharded on its rows over N ranks
(the decoder's sequence-parallel paths): launch one process a rank,

    python -m torch.distributed.run --nproc_per_node N -m merv_tpu_torch.cli.eval_mcq --mesh_seq N ...

Every rank loads the model and runs every question; only rank 0 writes the
prediction files. ``--dist_backend`` names the process-group backend (NCCL
on the card by default, gloo on the CPU); N ranks on fewer cards must name
gloo. As in ``merv_tpu``, ``--share_video_prefix`` is ignored under a mesh.
"""

from __future__ import annotations

import glob
import json
import math
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Union

import merv_tpu_torch.conf.registry as draccus
from merv_tpu_torch.models.load_vid import load_vid
from merv_tpu_torch.models.vidlms.merv import _load_media
from merv_tpu_torch.overwatch import initialize_overwatch
from merv_tpu_torch.parallel.mesh import world
from merv_tpu_torch.util.prefetch import prefetch_map

overwatch = initialize_overwatch(__name__)


def split_list(lst, n):
    """Split a list into n (roughly) equal-sized chunks."""
    chunk_size = math.ceil(len(lst) / n)
    return [lst[i : i + chunk_size] for i in range(0, len(lst), chunk_size)]


def get_chunk(lst, n, k):
    chunks = split_list(lst, n)
    return chunks[k] if k < len(chunks) else []


@dataclass
class EvalConfig:
    # fmt: off
    model_path: Union[str, Path] = "merv-full"      # run directory under runs/, or a local path
    hf_token: Union[str, Path] = Path(".hf_token")

    # Generation parameters
    do_sample: bool = False
    temperature: float = 1.0
    max_new_tokens: int = 512
    min_length: int = 1
    eval_dataset: str = "Perception"
    num_chunks: int = 1                             # shard-parallel eval
    chunk_idx: int = 0
    batch_size: int = 1                             # questions per prefill
    strategy: str = "naive"                         # answer-extraction: naive | likelihood
    share_video_prefix: bool = False                # group questions by video; towers + video-prefix KV run once per video
    allow_random_weights: bool = False              # random-init fallback (speed tests ONLY)
    quantize_llm: bool = False                      # weight-only int8 LLM serving
    int8_kv: bool = False                           # int8 KV cache (half the cache bytes decode reads)
    mesh_seq: int = 1                               # sequence-sharded KV cache over N ranks (one process a rank)
    dist_backend: Optional[str] = None              # process-group backend: nccl (card default) | gloo
    filename_question: str = "test_q"
    filename_answer: str = "test_a"
    eval_data_root: Path = Path("eval_data")
    eval_result_root: Path = Path("eval_result")
    device: Optional[str] = None                    # the card unless "cpu"
    # fmt: on


def serving_mesh(cfg):
    """``--mesh_seq N > 1``: ``merv_tpu``'s serving mesh (data 1, fsdp the
    rest, sp N) over the ``torchrun`` world, on ``cfg.device``'s device type
    with ``--dist_backend``; else None."""
    if cfg.mesh_seq <= 1:
        return None
    from merv_tpu_torch.device import resolve_device
    from merv_tpu_torch.parallel import MeshConfig, build_mesh

    return build_mesh(MeshConfig(data=1, fsdp=-1, tensor=1, seq=cfg.mesh_seq),
                      device_type=resolve_device(cfg.device).type, backend=cfg.dist_backend)


def output_file(path: Path):
    """The shard file rank 0 writes; the other ranks of a mesh write nothing."""
    return open(path, "w") if world()[0] == 0 else open(os.devnull, "w")


def barrier(mesh) -> None:
    """Every rank of ``mesh`` waits here (nothing without one)."""
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()


def prepare_mcqa_question(sample, gt_answer, cfg):
    """Letter-choice MCQ prompt -> (prompt, answer_char, option_letters)."""
    if cfg.strategy in ("naive", "likelihood"):
        question = sample["question"]
        choice_list = sample["options"]
        mapping = ["A. ", "B. ", "C. ", "D. ", "E. "]
        num_answers = sample["num_option"]
        choices = "\n".join([mapping[i] + c for i, c in enumerate(choice_list)])
        letters = ", ".join([mapping[c][0] for c in range(num_answers)])
        prompt = (
            f"{question} Select the correct answer from the following options. "
            f"Write your answer as only one of {letters} and nothing else.\n\n    {choices}"
        )
        answer = mapping[gt_answer["answer_id"]][0]
        return prompt, answer, [mapping[c][0] for c in range(num_answers)]
    raise ValueError(f"strategy {cfg.strategy} not supported")


def _resolve_video(benchmark_dir: Path, video_name: str) -> str:
    d = benchmark_dir / "videos" / video_name
    if d.is_dir():
        return str(d)
    matches = glob.glob(str(benchmark_dir / "videos" / f"{video_name}.*"))
    if not matches:
        raise FileNotFoundError(f"no video found for {video_name}")
    return matches[0]


def _clip(question):
    return dict(
        clip_start_sec=question["time"][0] if "time" in question else 0.0,
        clip_end_sec=question["time"][1] if "time" in question else None,
        end_frame=question.get("end_frame"),
    )


def load_model(cfg, mesh=None):
    """The run directory ``runs/<model_path>`` if it exists, else ``model_path``
    itself, loaded on ``cfg.device`` -> (vidlm, model_cfg); on a serving
    ``mesh`` the decoder takes its sequence-parallel paths, and under a
    ``tensor`` axis above 1 its rank's Megatron shards (``load_vid(mesh=)``;
    the drivers build no such mesh themselves, as ``merv_tpu``'s do not)."""
    local_run = Path("runs") / str(cfg.model_path)
    src = str(local_run) if local_run.exists() else str(cfg.model_path)
    on_mesh = {} if mesh is None else {"mesh": mesh}
    vidlm, model_cfg = load_vid(src, get_model_cfg=True, allow_random_weights=cfg.allow_random_weights,
                                quantize_llm=cfg.quantize_llm, device=cfg.device, **on_mesh)
    if mesh is not None:
        vidlm.llm_backbone.sequence_parallel = True
    return vidlm, model_cfg


@draccus.wrap()
def evaluate(cfg: EvalConfig) -> None:
    mesh = serving_mesh(cfg)
    result_dir = Path(cfg.eval_result_root) / str(cfg.model_path)
    result_dir.mkdir(parents=True, exist_ok=True)

    benchmark = cfg.eval_dataset.replace("_token", "")
    benchmark_dir = Path(cfg.eval_data_root) / benchmark
    questions = json.load(open(benchmark_dir / f"{cfg.filename_question}.json"))
    overwatch.info(f"Number of Questions in {benchmark}: {len(questions)}")
    all_questions_id = {item["question_id"] for item in questions}
    questions = get_chunk(questions, cfg.num_chunks, cfg.chunk_idx)
    overwatch.info(f"This chunk runs: {len(questions)}")

    answers = json.load(open(benchmark_dir / f"{cfg.filename_answer}.json"))
    answers_dict = {item["question_id"]: item for item in answers}

    # random weights only when asked for: garbage accuracies that look like results are worse than a crash
    vidlm, model_cfg = load_model(cfg, mesh)

    tag = f"{cfg.eval_dataset}_{cfg.strategy}_pred_{cfg.num_chunks}"
    temp_output_path = result_dir / f"{tag}_{cfg.chunk_idx}.jsonl"
    done_output_path = result_dir / f"{tag}_{cfg.chunk_idx}_done.jsonl"
    done_outputs_glob = str(result_dir / f"{tag}_*_done.jsonl")
    merged_path = result_dir / f"{cfg.eval_dataset}_{cfg.strategy}_pred_merge.jsonl"
    accuracy_path = result_dir / f"{cfg.eval_dataset}_{cfg.strategy}_gpt.json"

    def _prep(question):
        prompt_builder = vidlm.llm_backbone.prompt_builder_fn(model_family="merv")
        question_text, answer_char, letters = prepare_mcqa_question(
            question, answers_dict[question["question_id"]], cfg
        )
        if "_token" in cfg.eval_dataset:
            question_text = "<video>\n" + question_text
        prompt_builder.add_turn(role="human", message=question_text)
        return prompt_builder.get_prompt(), answer_char, question_text, _clip(question), letters

    def _decode_group(group):
        """Host-side resolve + decode, run ahead of the card by prefetch_map.
        Failures are caught per item (an exception in the item's place), so one
        corrupt video does not force the group's good decodes to be redone."""
        arrays = []
        for q in group:
            try:
                if arrays and share and not isinstance(arrays[0], Exception):
                    arrays.append(arrays[0])  # single-video group: decode once
                    continue
                name = _resolve_video(benchmark_dir, q["video_name"])
                arrays.append(_load_media(name, max(model_cfg.num_frames), **_clip(q)))
            except Exception as e:
                arrays.append(e)
        return arrays

    kv_cache_dtype = "int8" if cfg.int8_kv else None

    def _predict_one(question, prompt_text, letters):
        """Per-item path: path-based load, both strategies."""
        video = _resolve_video(benchmark_dir, question["video_name"])
        if cfg.strategy == "likelihood":
            return vidlm.score_options(
                [video], [prompt_text], [letters], num_frames=model_cfg.num_frames, clip_args=[_clip(question)],
                mesh=mesh,
            )[0]
        return vidlm.generate(
            video, prompt_text, do_sample=cfg.do_sample, temperature=cfg.temperature,
            max_new_tokens=cfg.max_new_tokens, min_length=cfg.min_length,
            num_frames=model_cfg.num_frames, kv_cache_dtype=kv_cache_dtype, mesh=mesh, **_clip(question),
        )

    share = cfg.share_video_prefix and cfg.strategy != "likelihood" and mesh is None
    if cfg.share_video_prefix and not share:
        overwatch.info("share_video_prefix ignored (likelihood strategy / sp serving mesh)")
    if share:
        # stable-order questions by (video, clip) so batches are single-video and the towers + [BOS | visual]
        # prefix KV amortize over every question on the video; jsonl rows are keyed by question_id, so the
        # merge / score / resume protocol does not depend on the order
        key = lambda q: (str(q["video_name"]), json.dumps(_clip(q), sort_keys=True, default=str))  # noqa: E731
        questions = sorted(questions, key=key)

    groups = [questions[s : s + cfg.batch_size] for s in range(0, len(questions), cfg.batch_size)]
    if share:
        # split batches at video boundaries: each group is exactly one video
        groups = []
        run = []
        for q in questions:
            if run and (key(q) != key(run[0]) or len(run) == cfg.batch_size):
                groups.append(run)
                run = []
            run.append(q)
        if run:
            groups.append(run)
    overlap = cfg.batch_size > 1 or cfg.strategy == "likelihood" or share
    decoded_iter = prefetch_map(groups, _decode_group) if overlap else ((g, None) for g in groups)

    prefix_state = {"key": None, "cache": None}  # cross-group video-prefix reuse
    barrier(mesh)  # every rank has read the resumable state before rank 0 writes
    with output_file(temp_output_path) as f:
        for group, decoded in decoded_iter:
            prepped = [_prep(q) for q in group]
            preds = [None] * len(group)
            # grouped fast path; any failure (a prefetch decode error included) falls back to the per-item path
            # below, so one corrupt video never drops the whole group
            try:
                if isinstance(decoded, Exception):
                    raise decoded
                # items whose host decode failed keep preds[i] = None and take the per-item path
                good = (
                    list(range(len(group))) if decoded is None
                    else [i for i, a in enumerate(decoded) if not isinstance(a, Exception)]
                )
                if decoded is not None and len(good) < len(group):
                    overwatch.error(f"{len(group) - len(good)} item(s) failed host decode; batching the rest")
                sub = None if decoded is None else [decoded[i] for i in good]
                if cfg.strategy == "likelihood" and good:
                    # one batched forward, the answer read from letter-token logits
                    sub_preds = vidlm.score_options(
                        sub, [prepped[i][0] for i in good], [prepped[i][4] for i in good],
                        num_frames=model_cfg.num_frames, pad_to_batch=cfg.batch_size, mesh=mesh,
                    )
                    for i, p in zip(good, sub_preds):
                        preds[i] = p
                elif share and good:
                    # single-video group: towers + video-prefix KV once; a video spanning several groups reuses
                    # the cached prefix
                    gk = key(group[0])
                    if prefix_state["key"] != gk:
                        prefix_state = {"key": gk, "cache": vidlm.build_video_prefix(
                            sub[0], num_frames=model_cfg.num_frames, kv_cache_dtype=kv_cache_dtype,
                        )}
                    sub_preds = vidlm.generate_batch_shared(
                        sub[0], [prepped[i][0] for i in good], num_frames=model_cfg.num_frames,
                        max_new_tokens=cfg.max_new_tokens, do_sample=cfg.do_sample, temperature=cfg.temperature,
                        min_length=cfg.min_length, pad_to_batch=cfg.batch_size, prefix_cache=prefix_state["cache"],
                        kv_cache_dtype=kv_cache_dtype,
                    )
                    for i, p in zip(good, sub_preds):
                        preds[i] = p
                elif cfg.batch_size > 1 and good:
                    sub_preds = vidlm.generate_batch(
                        sub, [prepped[i][0] for i in good], num_frames=model_cfg.num_frames,
                        max_new_tokens=cfg.max_new_tokens, do_sample=cfg.do_sample, temperature=cfg.temperature,
                        min_length=cfg.min_length, pad_to_batch=cfg.batch_size, kv_cache_dtype=kv_cache_dtype,
                        mesh=mesh,
                    )
                    for i, p in zip(good, sub_preds):
                        preds[i] = p
            except Exception as e:
                overwatch.error(f"Grouped eval failed ({type(e).__name__}: {e}); retrying per-item")
                preds = [None] * len(group)

            for question, (prompt_text, answer_char, question_text, _, letters), pred in zip(group, prepped, preds):
                try:
                    if pred is None:  # batch-1 path or group-failure retry
                        pred = _predict_one(question, prompt_text, letters)
                    out = {**question, **answers_dict[question["question_id"]]}
                    out["pred"] = pred
                    out["question_text"] = question_text
                    out["answer_char"] = answer_char
                    f.write(json.dumps(out) + "\n")
                except Exception as e:  # per-video fault tolerance
                    overwatch.error(f"Failed on {question.get('question_id')}: {type(e).__name__}: {e}")
            # flush per group: a killed shard loses at most one group
            f.flush()
    if world()[0] != 0:
        return
    os.rename(temp_output_path, done_output_path)

    # the last finisher merges the shards and scores
    all_jsonls = glob.glob(done_outputs_glob)
    all_done_items = {
        item["question_id"]: item
        for jsonl in all_jsonls
        for line in open(jsonl).readlines()
        if (item := json.loads(line))
    }
    if len(all_questions_id - set(all_done_items.keys())) == 0:
        with open(merged_path, "w") as f:
            for item in all_done_items.values():
                f.write(json.dumps(item) + "\n")
        for jsonl in all_jsonls:
            os.remove(jsonl)

    if merged_path.exists():
        items = [json.loads(line) for line in open(merged_path).readlines() if line.strip()]
        completed_files = {}
        yes_count = no_count = 0
        for sample in items:
            sample["acc"] = sample["pred"].lower()[:1] == sample["answer_char"].lower()
            completed_files[sample["question_id"]] = [
                {"pred": "yes" if sample["acc"] else "no", "score": 0}, sample,
            ]
            yes_count += int(sample["acc"])
            no_count += int(not sample["acc"])
        json.dump(completed_files, open(accuracy_path, "w"))
        accuracy = yes_count / max(yes_count + no_count, 1)
        print("Yes count:", yes_count)
        print("No count:", no_count)
        print("Accuracy:", accuracy)


if __name__ == "__main__":
    evaluate()
