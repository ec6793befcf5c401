"""Closed-loop serving through the port's engine (``ContinuousBatchingEngine.for_vidlm``).

Set-up: the model from the seed, the video pool, one warm-up request of the
cell's own shapes (towers at batch 1, the prompt's prefill bucket, the
captured decode chunk). Window: ``queue`` requests queued at once; each
completion submits the next request of the deck while the window is open;
after it the engine drains what it holds. ``answers_per_s`` is the answers
completed between the window's first and last completion over the time
between them. Check: a sample of the finished requests drawn from the seed,
the longest among them, held against the float32 reference: the widest gap
by which a served token's logit lies below the reference's best at its
position.

With ``trace`` the same run also keeps CUDA-event spans of the towers and
of each prefill (hooks on the modules), profiles a slice in the middle of the
window, and after the window times the kernels the roofline readers ask for.
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark import flops, harness, program, traffic, weights
from benchmark.harness import Cell
from benchmark.reference import merv as ref


def build(cell: Cell, int8: bool = False, compute_dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """The model, the engine and the traffic: everything before the warm-up. ``int8``: the program's int8
    path, its LLM's Linears and its slot cache in int8 (the serving control)."""
    from merv_tpu_torch.models.generation import GenerationConfig
    from merv_tpu_torch.serving.engine import ContinuousBatchingEngine, Request

    cfg, mix, dev = cell.cfg, cell.mix, cell.device
    vidlm = program.serving_model(cfg, dev, cell.seed, int8=int8, compute_dtype=compute_dtype)
    v = mix["video"]
    pool = traffic.videos(cell.seed, v["pool"] + 1, (v["frames"], v["height"], v["width"], 3), dev).cpu().numpy()
    tr = traffic.ServeTraffic(mix, cell.seed)
    tok = vidlm.llm_backbone.tokenizer
    first = tr.request(0).prompt
    if list(tok(first).input_ids) != traffic.text_ids(first):
        raise RuntimeError("the program's tokenizer is not the byte-level one the traffic is written for")
    state: Dict[str, Any] = dict(results={}, completions=[], on=False, next=0, t0=0.0, closed=None, hook=None)

    def on_result(res) -> None:
        now = time.perf_counter()
        state["results"][res.request_id] = (now, res)
        if not state["on"]:
            return
        if now - state["t0"] < cell.seconds:
            state["completions"].append(now)
            submit()
        elif state["closed"] is None:
            state["closed"] = snapshot(engine)
        if state["hook"] is not None:
            state["hook"](now)

    def submit() -> None:
        r = tr.request(state["next"])
        engine.submit(Request(f"r{state['next']}", prompt_text=r.prompt, video=pool[r.video],
                              max_new_tokens=r.budget))
        state["next"] += 1

    e = mix["engine"]
    rng = torch.Generator(device=dev)
    rng.manual_seed(cell.seed % (1 << 63))
    gcfg = GenerationConfig(max_new_tokens=mix["answer_tokens"]["max"], do_sample=False, eos_token_id=-1,
                            pad_token_id=vidlm.llm_backbone.pad_token_id, kv_cache_dtype="int8" if int8 else None)
    engine = ContinuousBatchingEngine.for_vidlm(
        vidlm, slots=e["slots"], max_len=e["max_len"], steps_per_sync=e["steps_per_sync"], config=gcfg,
        length_bucket=e["length_bucket"], speculative_gamma=e["speculative_gamma"],
        async_admission=e["async_admission"], rng=rng, result_callback=on_result)
    return dict(vidlm=vidlm, engine=engine, pool=pool, traffic=tr, state=state, submit=submit, Request=Request)


def warm_up(b: Dict[str, Any], cell: Cell) -> None:
    mix = cell.mix
    prompt = traffic.text(traffic._rng(cell.seed, 3), mix["question_tokens"]["max"])
    b["engine"].run([b["Request"]("warmup", prompt_text=prompt, video=b["pool"][-1],
                                  max_new_tokens=mix["warmup_budget"])])
    harness.sync(cell.device)


def snapshot(engine) -> Dict[str, float]:
    s = engine.stats
    return dict(admit_s=s.admit_s, decode_s=s.decode_s, active=s.slot_steps_active, idle=s.slot_steps_idle,
                decode_steps=s.decode_steps, prefills=s.prefills, t=time.perf_counter())


def window(b: Dict[str, Any], cell: Cell) -> Dict[str, Any]:
    """Run the closed loop; returns the window's readings (host clock)."""
    st, engine = b["state"], b["engine"]
    st["start"] = snapshot(engine)
    st["on"], st["t0"] = True, time.perf_counter()
    for _ in range(cell.mix["queue"]):
        b["submit"]()
    engine.run()
    st["on"] = False
    if st["closed"] is None:
        st["closed"] = snapshot(engine)
    c = st["completions"]
    if len(c) < 2:
        raise RuntimeError(f"{len(c)} answers completed in a {cell.seconds} s window: no rate")
    return dict(answers=len(c) - 1, span_s=c[-1] - c[0], answers_per_s=(len(c) - 1) / (c[-1] - c[0]))


def served(b: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every finished request but the warm-up: its deck entry and its tokens."""
    out = []
    for rid, (t, res) in b["state"]["results"].items():
        if rid == "warmup":
            continue
        r = b["traffic"].request(int(rid[1:]))
        out.append(dict(id=rid, t=t, req=r, ok=res.finish_reason != "error", tokens=res.token_ids[: r.budget]))
    return out


def sample(done: List[Dict[str, Any]], n: int, seed: int) -> List[Dict[str, Any]]:
    """The longest finished request and n - 1 more drawn from the seed."""
    ok = sorted((d for d in done if d["ok"]), key=lambda d: int(d["id"][1:]))
    if not ok:
        return []
    longest = max(ok, key=lambda d: (d["req"].budget, -int(d["id"][1:])))
    rest = [d for d in ok if d is not longest]
    rng = traffic._rng(seed, 4)
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[int(i)] for i in sorted(pick)]


def gaps(cell: Cell, picked: List[Dict[str, Any]], pool: np.ndarray, P: ref.Precision = ref.FP32) -> Dict[str, float]:
    """The gaps of the picked requests' served tokens against the reference: the widest, the mean, and the
    share of tokens that are not the reference's best."""
    dev = cell.device
    W = weights.draw_dict(ref.spec(cell.cfg), cell.seed, dev)
    towers = cell.cfg["merv"]["towers"]
    all_gaps = []
    for d in picked:
        video = torch.as_tensor(pool[d["req"].video], device=dev)
        pixels = [ref.tower_pixels(t, video)[None] for t in towers]
        prompt = torch.tensor(traffic.text_ids(d["req"].prompt), device=dev)
        toks = torch.as_tensor(np.asarray(d["tokens"], np.int64), device=dev)
        logits = ref.served_logits(W, cell.cfg, pixels, prompt, toks, P)
        all_gaps.append(ref.served_gaps(logits, toks).double().cpu())
    del W
    harness.free(dev)
    g = torch.cat(all_gaps)
    return dict(max_gap=float(g.max()), mean_gap=float(g.mean()), off_best=float((g > 0).double().mean()))


def k5_shape(cell: Cell, b: Dict[str, Any]) -> Dict[str, Any]:
    """Decode attention at the engine's slots, each holding the deck's mean cache length over decode
    steps, in the engine's cache of max_len + 1 rows."""
    tr, cfg = b["traffic"], cell.cfg
    V = cfg["merv"]["visual_feature_length"]
    num = sum(sum(V + q + j for j in range(1, a)) for q, a in zip(tr.q, tr.a))
    steps = sum(a - 1 for a in tr.a)
    return dict(B=cell.mix["engine"]["slots"], rows=int(round(num / steps)), Tk=cell.mix["engine"]["max_len"] + 1,
                H=cfg["num_attention_heads"], Hk=cfg["num_key_value_heads"],
                D=cfg["hidden_size"] // cfg["num_attention_heads"])


def probes(cell: Cell, b: Dict[str, Any]) -> Dict[str, Any]:
    """Graph-replay times of the kernels at the cell's shapes (after the window; card only)."""
    if cell.device.type != "cuda":
        return {}
    from merv_tpu_torch.ops.attention import small_attention_kt
    from merv_tpu_torch.ops.decode_attention import decode_attention

    dev, g = cell.device, torch.Generator(device=cell.device)
    g.manual_seed(cell.seed % (1 << 63))
    out = {}
    s = k5_shape(cell, b)
    q = torch.randn(s["B"], s["H"], 1, s["D"], generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(s["B"], s["Hk"], s["Tk"], s["D"], generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(s["B"], s["Hk"], s["Tk"], s["D"], generator=g, device=dev).to(torch.bfloat16)
    mask = (torch.arange(s["Tk"], device=dev) < s["rows"])[None].expand(s["B"], s["Tk"]).contiguous()
    ms = harness.graph_ms(lambda: decode_attention(q, k, v, kv_mask=mask))
    out["k5"] = dict(ms=ms, **flops.k5(s["B"], s["H"], s["Hk"], [s["rows"]] * s["B"], s["D"]), shape=s)
    t = next(t for t in cell.cfg["merv"]["towers"] if t["family"] == "dinov2")
    T = (t["image_size"] // t["patch_size"]) ** 2 + t["num_cls_tokens"] + t["num_register_tokens"]
    H, D = t["num_heads"], t["hidden_size"] // t["num_heads"]
    qq = torch.randn(t["frames"], H, T, D, generator=g, device=dev).to(torch.bfloat16)
    kt = torch.randn(t["frames"], H, D, T, generator=g, device=dev).to(torch.bfloat16)
    vv = torch.randn(t["frames"], H, T, D, generator=g, device=dev).to(torch.bfloat16)
    ms = harness.graph_ms(lambda: small_attention_kt(qq, kt, vv, D ** -0.5))
    out["k1"] = dict(ms=ms, **flops.k1(t["frames"], H, T, D), shape=[t["frames"], H, T, D])
    return out


def run(cell: Cell) -> Dict[str, Any]:
    import merv_tpu_torch.ops.attention as A

    dev = cell.device
    t = time.perf_counter()
    b = build(cell, compute_dtype=cell.compute_dtype)
    engine, vidlm, st = b["engine"], b["vidlm"], b["state"]
    cell.obs["build_s"] = harness.sync(dev) - t
    towers = prefill = prof = None
    if cell.trace:
        towers = harness.Spans(dev, list(vidlm.video_backbones))
        prefill = harness.Spans(dev, [vidlm.llm_backbone.decoder],
                                when=lambda a, kw: kw.get("inputs_embeds") is not None
                                and kw["inputs_embeds"].shape[1] > 1)
        prof = harness.ProfileSlice(dev, Path(tempfile.gettempdir()) / "serve_trace.json")
    t = time.perf_counter()
    warm_up(b, cell)
    cell.obs["warm_s"] = time.perf_counter() - t
    if cell.trace:
        towers.on = prefill.on = True
        marks: Dict[str, Any] = {}

        def hook(now: float) -> None:
            if not prof.started and now - st["t0"] >= 0.4 * cell.seconds:
                marks["launch0"], marks["stats0"] = A.launch_counts(), snapshot(engine)
                prof.start()
            elif prof.started and "stats1" not in marks and now - prof.t0 >= cell.mix["profile_s"]:
                prof.stop()
                marks["launch1"], marks["stats1"] = A.launch_counts(), snapshot(engine)

        st["hook"] = hook
    cell.obs["setup_s"] = time.perf_counter() - cell.t_process
    harness.reset_peak(dev)
    w = window(b, cell)
    harness.sync(dev)
    peak = harness.peak_bytes(dev)
    done = served(b)
    in_window = [d for d in done if st["t0"] <= d["t"] <= st["completions"][-1]]
    cell.obs.update(w, memory_peak_bytes=peak, attempted=len(done), failed=sum(not d["ok"] for d in done),
                    start=st["start"], closed=st["closed"])
    # the model work of the answers whose completions bound the rate (all but the first)
    counted = sorted(in_window, key=lambda d: d["t"])[1:]
    cell.obs["model_flops"] = sum(flops.answer_flops(cell.cfg, len(d["req"].prompt), len(d["tokens"]))
                                  for d in counted)
    if cell.trace:
        towers.on = prefill.on = False
        harness.sync(dev)
        cell.obs["towers_ms"] = towers.total_ms() / max(len(prefill.pairs), 1)
        cell.obs["prefill_ms"] = prefill.total_ms() / max(len(prefill.pairs), 1)
        towers.remove()
        prefill.remove()
        if prof.started and "stats1" not in marks:
            prof.stop()
            marks["launch1"], marks["stats1"] = A.launch_counts(), snapshot(engine)
        if prof.started:
            cell.obs["profile"] = prof.reduce()
            cell.obs["profile"]["launches"] = {k: marks["launch1"][k] - marks["launch0"].get(k, 0)
                                               for k in marks["launch1"]}
            cell.obs["profile"]["decode_steps"] = marks["stats1"]["decode_steps"] - marks["stats0"]["decode_steps"]
        try:
            cell.obs["probes"] = probes(cell, b)
        except RuntimeError as e:  # a kernel that cannot be timed leaves its roofline unread
            sys.stderr.write(f"kernel probes failed: {e}\n")
            cell.obs["probes"] = {}
    picked = sample(done, cell.mix["check_requests"], cell.seed)
    pool = b["pool"]
    del engine, vidlm, b
    harness.free(dev)
    harness.strict_fp32()
    t_ref = time.perf_counter()
    got = gaps(cell, picked, pool) if picked else dict(max_gap=float("inf"), mean_gap=float("inf"), off_best=1.0)
    cell.obs["ref_s"] = time.perf_counter() - t_ref
    cell.obs["gaps"] = got
    for name in cell.limits:
        cell.checks[name] = dict(value=got[name], limit=cell.limits[name])
    cell.obs["served_checked"] = sum(len(d["tokens"]) for d in picked)
    return dict(answers_per_s=w["answers_per_s"])
