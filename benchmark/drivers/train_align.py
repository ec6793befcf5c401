"""The align stage's training step, as ``cli/pretrain.py``'s strategy builds and calls it.

Set-up builds the model from the seed and the strategy
(``get_train_strategy`` -> ``run_setup``: the recipe's schedule, clipped
AdamW and ``make_train_step(make_loss_fn(model, remat=True), ...)``), makes
the pool of examples (each batch a fixed set of text lengths in the seed's
order; uint8 frames at the towers' geometry, as the align dataloader hands
them over), and runs the first ``checked_steps`` steps through the same
call, one distinct batch each. Their losses, the first gradient (Adam's first
moment after step 1, over 1 - beta1) and the parameters' change are kept for
the check. The window then keeps calling the same step, cycling the pool,
each step's completion read one step late by a CUDA event.
``train_tokens_per_s`` counts the LLM's non-padding input positions of the
steps completed in the window over the time from its start to the end of
its last completed step. Check: the float32 reference repeats the checked
steps from the same weights and batches; per leaf, the gaps of the gradient's
and the change's norms, and each step's loss.
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from benchmark import flops, harness, program, traffic, weights
from benchmark.harness import Cell
from benchmark.reference import merv as ref

BETA1 = 0.9


def towers_frames(cfg: dict, videos: Dict[int, torch.Tensor]) -> List[torch.Tensor]:
    """Videos by frame size, uint8 [..., T, S, S, 3] -> each tower's frames at its own size (every
    T // frames-th, the first ``frames``)."""
    out = []
    for t in cfg["merv"]["towers"]:
        video = videos[t["image_size"]]
        T, n = video.shape[-4], t["frames"]
        idx = torch.arange(0, T, max(1, T // n), device=video.device)[:n]
        out.append(video.index_select(video.dim() - 4, idx))
    return out


def make_videos(cell: Cell, count: int) -> Dict[int, torch.Tensor]:
    """``count`` seeded uint8 videos at each tower frame size (one set where every tower takes 224 px)."""
    sizes = sorted({t["image_size"] for t in cell.cfg["merv"]["towers"]})
    T = cell.mix["video"]["frames"]
    return {S: traffic.videos(cell.seed, count, (T, S, S, 3), cell.device, stream=7 + S) for S in sizes}


def make_batches(cell: Cell, pad_id: int) -> Dict[str, Any]:
    cfg, mix, dev = cell.cfg, cell.mix, cell.device
    ex = traffic.train_examples(mix, cell.seed)
    vids = make_videos(cell, len(ex))
    b = mix["batch"]
    batches, texts = [], []
    for k in range(mix["batches"]):
        rows = ex[k * b:(k + 1) * b]
        T = max(len(r.prompt_ids) + len(r.caption_ids) for r in rows)
        ids = torch.full((b, T), pad_id, dtype=torch.long)
        labels = torch.full((b, T), ref.IGNORE_INDEX, dtype=torch.long)
        mask = torch.zeros((b, T), dtype=torch.long)
        for i, r in enumerate(rows):
            n = len(r.prompt_ids) + len(r.caption_ids)
            ids[i, :n] = torch.tensor(r.prompt_ids + r.caption_ids)
            labels[i, len(r.prompt_ids):n] = torch.tensor(r.caption_ids)
            mask[i, :n] = 1
        frames = towers_frames(cfg, {S: v[k * b:(k + 1) * b] for S, v in vids.items()})
        batches.append(dict(input_ids=ids.to(dev), attention_mask=mask.to(dev), labels=labels.to(dev),
                            is_multimodal=torch.ones(b, dtype=torch.bool, device=dev),
                            video_values=frames))
        texts.append(rows)
    V = cfg["merv"]["visual_feature_length"]
    tokens = [sum(V + len(r.prompt_ids) + len(r.caption_ids) for r in rows) for rows in texts]
    model_flops = [sum(flops.align_example_flops(cfg, len(r.prompt_ids) + len(r.caption_ids), len(r.caption_ids))
                       for r in rows) for rows in texts]
    return dict(batches=batches, rows=texts, videos=vids, tokens=tokens, model_flops=model_flops)


def build(cell: Cell, compute_dtype: torch.dtype = torch.bfloat16):
    from merv_tpu_torch.training.materialize import get_train_strategy

    a = cell.cfg["align"]
    vidlm, transforms = program.training_model(cell.cfg, cell.device, cell.seed, compute_dtype=compute_dtype)
    strategy = get_train_strategy(
        "fsdp-full-shard", vidlm, stage=a["stage"], epochs=1, max_steps=None,
        global_batch_size=a["global_batch_size"], per_device_batch_size=a["per_device_batch_size"],
        learning_rate=a["learning_rate"], weight_decay=a["weight_decay"], max_grad_norm=a["max_grad_norm"],
        lr_scheduler_type=a["lr_scheduler_type"], warmup_ratio=a["warmup_ratio"],
        enable_gradient_checkpointing=a["remat"], loss_chunk_size=a["loss_chunk_size"])
    strategy.run_setup(Path(tempfile.gettempdir()) / "bench_align", n_train_examples=examples(cell.cfg),
                       video_transforms=transforms, seed=cell.seed)
    return vidlm, strategy


def examples(cfg: dict) -> int:
    """This chip's share of the align set: the recipe's examples over its ranks."""
    a = cfg["align"]
    return a["align_examples"] * a["global_batch_size"] // a["published_global_batch_size"]


def total_steps(cfg: dict) -> int:
    return max(examples(cfg) // cfg["align"]["global_batch_size"], 1)


def first_steps(strategy, data: Dict[str, Any], n: int) -> Dict[str, Any]:
    """The checked steps through the window's own call: losses, the first clipped gradient's norms
    and the parameters' change norms, by leaf."""
    tx = strategy.tx
    named = dict(tx.named_params)
    p0 = {k: p.detach().clone() for k, p in named.items()}
    losses, g1 = [], {}
    for s in range(n):
        out = strategy.step_fn(data["batches"][s % len(data["batches"])])
        losses.append(float(out["loss"]))
        if s == 0:
            state = tx.adamw.state
            g1 = {k: float(state[p]["exp_avg"].float().norm() / (1 - BETA1)) if p in state else 0.0
                  for k, p in named.items()}
    change = {k: float((p.detach().float() - p0[k].float()).norm()) for k, p in named.items()}
    return dict(losses=losses, grad=g1, change=change)


def reference_steps(cell: Cell, data: Dict[str, Any], n: int, P: ref.Precision = ref.FP32,
                    keep: Optional[Callable[[int], bool]] = None) -> Dict[str, Any]:
    """The reference's checked steps from the same weights and batches. ``keep(i)`` drops examples
    (a planted fault: half of each micro-batch)."""
    cfg, dev, a = cell.cfg, cell.device, cell.cfg["align"]
    W = weights.draw_dict(ref.spec(cfg), cell.seed, dev)
    params = {k: W[k].requires_grad_(True) for k in W if ref.trainable(k)}
    opt = ref.AdamW(params, a["learning_rate"], total_steps(cfg), a["warmup_ratio"], a["weight_decay"],
                    a["max_grad_norm"])
    p0 = {k: p.detach().clone() for k, p in params.items()}
    towers = cfg["merv"]["towers"]
    micro = a["per_device_batch_size"]
    losses, g1 = [], {}
    for s in range(n):
        k = s % len(data["batches"])
        rows = data["rows"][k]
        first = k * len(rows)
        grads = {name: torch.zeros_like(p) for name, p in params.items()}
        loss = 0.0
        n_micro = len(rows) // micro
        for m in range(n_micro):
            idx = [i for i in range(m * micro, (m + 1) * micro) if keep is None or keep(i - m * micro)]
            count = sum(len(rows[i].caption_ids) for i in idx)
            total = 0.0
            for i in idx:
                r = rows[i]
                frames = towers_frames(cfg, {S: v[first + i] for S, v in data["videos"].items()})
                pixels = [ref.tower_pixels(t, f)[None] for t, f in zip(towers, frames)]
                with torch.no_grad():
                    grids = [ref.tower_features(W, j, t, x, P) for j, (t, x) in enumerate(zip(towers, pixels))]
                vis = ref.visual_tokens(W, cfg, None, P, grids=grids)
                ids = torch.tensor(r.prompt_ids + r.caption_ids, device=dev)
                labels = torch.tensor([ref.IGNORE_INDEX] * len(r.prompt_ids) + r.caption_ids, device=dev)
                nll, _ = ref.example_nll(W, cfg, vis, ids, labels, P)
                g = torch.autograd.grad(nll / count / n_micro, list(params.values()), allow_unused=True)
                for (name, _), gi in zip(params.items(), g):
                    if gi is not None:
                        grads[name] += gi
                total += float(nll.detach())
            loss += total / count / n_micro
        clipped = opt.step(grads)
        losses.append(loss)
        if s == 0:
            g1 = {name: float(gi.norm()) for name, gi in clipped.items()}
    change = {name: float((p.detach() - p0[name]).norm()) for name, p in params.items()}
    del W, params, opt
    harness.free(dev)
    return dict(losses=losses, grad=g1, change=change)


def leaf_gaps(prog: Dict[str, float], refr: Dict[str, float], counted: List[str]) -> Dict[str, float]:
    """Each leaf's gap of norms, over the reference's norm of that leaf or of the median leaf."""
    vals = sorted(refr[k] for k in counted)
    med = vals[len(vals) // 2]
    return {k: abs(prog[k] - refr[k]) / max(refr[k], med) for k in counted}


def compare(prog: Dict[str, Any], refr: Dict[str, Any]) -> Dict[str, Any]:
    """The numbers a limits file may compare: each step's loss gap (the worst), and by leaf the first
    gradient's and the change's gaps of norms (the worst leaf's and the median leaf's). Leaves whose
    reference gradient is under 1e-3 of the median leaf's (rounding alone moves them under Adam) are not
    counted."""
    g = sorted(refr["grad"].values())
    med = g[len(g) // 2]
    counted = [k for k, v in refr["grad"].items() if v >= 1e-3 * med]
    gg, cg = leaf_gaps(prog["grad"], refr["grad"], counted), leaf_gaps(prog["change"], refr["change"], counted)

    def median(d: Dict[str, float]) -> float:
        return sorted(d.values())[len(d) // 2]

    return dict(loss_gap=max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], refr["losses"])),
                grad_gap=max(gg.values()), change_gap=max(cg.values()), grad_median_gap=median(gg),
                change_median_gap=median(cg), worst=[max(gg, key=gg.get), max(cg, key=cg.get)],
                leaves=len(counted), left_out=sorted(set(refr["grad"]) - set(counted)))


def run(cell: Cell) -> Dict[str, Any]:
    import merv_tpu_torch.ops.attention as A

    dev, mix = cell.device, cell.mix
    t = time.perf_counter()
    vidlm, strategy = build(cell, cell.compute_dtype)
    data = make_batches(cell, vidlm.llm_backbone.pad_token_id)
    cell.obs["build_s"] = harness.sync(dev) - t
    towers = harness.Spans(dev, list(vidlm.video_backbones)) if cell.trace else None
    n_check = mix["checked_steps"]
    prog = first_steps(strategy, data, n_check)
    harness.sync(dev)
    cell.obs["setup_s"] = time.perf_counter() - cell.t_process
    harness.reset_peak(dev)
    prof = harness.ProfileSlice(dev, Path(tempfile.gettempdir()) / "train_trace.json") if cell.trace else None
    host_ms: List[float] = []
    if towers is not None:
        towers.on = True
    start = harness.Event(dev).record()
    t0 = time.perf_counter()
    launched: List[Any] = []  # (start event, end event, batch) of each window step
    k = n_check
    while time.perf_counter() - t0 < cell.seconds:
        if prof is not None and not prof.started and time.perf_counter() - t0 >= 0.4 * cell.seconds:
            launches0 = A.launch_counts()
            prof.start()
        if prof is not None and prof.started and prof.t1 == 0.0 and time.perf_counter() - prof.t0 >= mix["profile_s"]:
            prof.stop()
            launches1 = A.launch_counts()
        j = k % len(data["batches"])
        e0 = harness.Event(dev).record()
        h0 = time.perf_counter()
        strategy.step_fn(data["batches"][j])
        host_ms.append((time.perf_counter() - h0) * 1e3)
        launched.append((e0, harness.Event(dev).record(), j))
        k += 1
        if len(launched) > 1:  # at most one step ahead, as the strategy's loop reads a loss one step late
            launched[-2][1].synchronize()
    harness.sync(dev)
    if prof is not None and prof.started and prof.t1 == 0.0:
        prof.stop()
        launches1 = A.launch_counts()
    # each step's end on the device's clock, from the window's start: the host's lead does not move it
    ends = [start.ms_to(e1) / 1e3 for _, e1, _ in launched]
    done = [(e0, e1, j, end) for (e0, e1, j), end in zip(launched, ends) if end <= cell.seconds]
    if not done:
        raise RuntimeError(f"no step completed in a {cell.seconds} s window")
    steps, span = len(done), max(d[3] for d in done)
    done_tokens = sum(data["tokens"][d[2]] for d in done)
    done_flops = sum(data["model_flops"][d[2]] for d in done)
    step_ms = [e0.ms_to(e1) for e0, e1, _, _ in done]
    micro = mix["batch"] // cell.cfg["align"]["per_device_batch_size"]
    cell.obs.update(memory_peak_bytes=harness.peak_bytes(dev), attempted=steps, failed=0, steps=steps,
                    span_s=span, model_flops=done_flops, micro_steps=steps * micro,
                    step_ms=flops.mean(step_ms), host_ms=host_ms, step_device_ms=step_ms)
    if cell.trace:
        towers.on = False
        # every micro-step runs each tower once
        cell.obs["towers_ms"] = towers.total_ms() * len(vidlm.video_backbones) / max(len(towers.pairs), 1)
        towers.remove()
        if prof.started:
            cell.obs["profile"] = prof.reduce()
            cell.obs["profile"]["launches"] = {k: launches1[k] - launches0.get(k, 0) for k in launches1}
        try:
            cell.obs["probes"] = probes(cell, data)
        except RuntimeError as e:  # a kernel that cannot be timed leaves its roofline unread
            sys.stderr.write(f"kernel probes failed: {e}\n")
            cell.obs["probes"] = {}
    del vidlm, strategy
    harness.free(dev)
    harness.strict_fp32()
    t_ref = time.perf_counter()
    refr = reference_steps(cell, data, n_check)
    got = compare(prog, refr)
    for name in cell.limits:
        cell.checks[name] = dict(value=got[name], limit=cell.limits[name])
    cell.obs["gaps"] = {k: v for k, v in got.items() if k.endswith("gap")}
    cell.obs.update({k: got[k] for k in ("leaves", "left_out", "worst")},
                    ref_s=time.perf_counter() - t_ref, losses=prog["losses"], ref_losses=refr["losses"])
    return dict(train_tokens_per_s=done_tokens / span)


def probes(cell: Cell, data: Dict[str, Any]) -> Dict[str, Any]:
    """The causal flash backward at the cell's mean LLM length (graph replay; card only)."""
    if cell.device.type != "cuda":
        return {}
    from merv_tpu_torch.ops.attention import flash_attention_backward, flash_attention_forward

    cfg, dev = cell.cfg, cell.device
    B = cell.cfg["align"]["per_device_batch_size"]
    H, Hk = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = cfg["hidden_size"] // H
    T = int(round(sum(data["tokens"]) / (len(data["tokens"]) * cell.mix["batch"])))
    g = torch.Generator(device=dev)
    g.manual_seed(cell.seed % (1 << 63))
    q = torch.randn(B, H, T, D, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, Hk, T, D, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, Hk, T, D, generator=g, device=dev).to(torch.bfloat16)
    do = torch.randn(B, H, T, D, generator=g, device=dev).to(torch.bfloat16)
    o, lse = flash_attention_forward(q, k, v, causal=True, return_lse=True)
    ms = harness.graph_ms(lambda: flash_attention_backward(q, k, v, o, lse, do, causal=True))
    return {"k3": dict(ms=ms, **flops.k3(B, H, Hk, T, D), shape=[B, H, Hk, T, D])}
