#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``merv_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--max-new-tokens 32]

Phases, each of which fails the run (non-zero exit, no result line) if it fails:
1. device: the card's name and ``nvidia-smi`` power limit; no CUDA -> exit 2.
2. build: ``nvcc`` compiles every ``merv_tpu_torch/csrc/*.cu`` for sm_90a.
3. kernels: each hand-written kernel against its plain PyTorch version at the
   main path's shapes (bf16, inputs from a numpy seed), with max/mean abs
   error against a stated tolerance and CUDA-event times of the kernel, the
   plain version and one PyTorch library call (SDPA, a yardstick only: the
   port never calls it), beside the shape's lower bound on this card.
4. main path: merv-base at full width (four towers at 224 px with
   [16, 16, 32, 16] frames, 1024 visual tokens, Llama-2-7B with 32 layers in
   bf16) on random weights from a seeded generator on the card; serves 3
   requests through ``MERV.generate`` and one batched ``generate_ids``
   (B=2: one shorter prompt, one text-only row), with the kernels' launch
   counters zeroed just before and read just after; then reruns request 0's
   prefill with ``impl="plain"`` and holds the spliced input embeddings and
   the last-position logits against it, holds each kernel call of that
   prefill against its plain version on the call's own inputs, compares the
   greedy tokens, and reports what both checks give for a few planted
   kernel faults.
5. output: ``nvidia-smi`` line, a ``{"kernels": [...]}`` line, and the last
   line ``{"ok": true, "device": {...}}``. Details go to
   ``chiprun_out/chip_smoke.json``.

Imports nothing of JAX or of ``merv_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak
# A kernel's output is held element by element against its plain version:
# |out - ref| <= KERNEL_REL_TOL * (|ref| + mag) + KERNEL_ABS_TOL, where mag is
# the plain version's output on |v|, i.e. sum(p |v|) / l. Kernel and plain
# version each round p to bf16 (at different maxima: an error of at most
# 2**-8 * mag each) and round the output to bf16 (2**-8 * |ref| each), so
# 2**-7 * (|ref| + mag) is the sum of both; it is what a row whose few terms
# cancel needs. The absolute term covers fp32 summation order. The mean error
# must also stay under KERNEL_MEAN_SHARE of the mean limit (about 7e-4 at
# unit-normal inputs, against a typical |o| >= 0.023 at these shapes).
KERNEL_REL_TOL = 2 ** -7
KERNEL_ABS_TOL = 1e-4
KERNEL_MEAN_SHARE = 0.1
# whole path, kernels vs plain versions on the same weights: relative L2
# difference of the spliced input embeddings (towers, projectors, fusion) and
# of the prefill's last-position logits (all of the above plus 32 layers)
EMBEDS_REL_TOL = 2e-2
LOGITS_REL_TOL = 5e-2


def hold(out, ref, mag) -> dict:
    """A kernel's output against its plain version ``ref`` (and the plain
    version on |v|, ``mag``): the errors, the limit, and whether both the
    worst element and the mean stay within it."""
    ref, mag = ref.float(), mag.float()
    err = (out.float() - ref).abs()
    limit = KERNEL_REL_TOL * (ref.abs() + mag) + KERNEL_ABS_TOL
    share = (err / limit).flatten()
    i = int(share.argmax())
    r = dict(max_abs_err=err.max().item(), mean_abs_err=err.mean().item(), mean_abs_ref=ref.abs().mean().item(),
             mean_limit=limit.mean().item(), worst_share_of_limit=share[i].item(),
             worst_at=dict(err=err.flatten()[i].item(), ref=ref.flatten()[i].item(), mag=mag.flatten()[i].item()))
    r["ok"] = r["worst_share_of_limit"] <= 1.0 and r["mean_abs_err"] <= KERNEL_MEAN_SHARE * r["mean_limit"]
    return r


@contextlib.contextmanager
def patched(*replacements):
    """Swap module attributes, given as (module, name, value), for the block."""
    saved = [(module, name, getattr(module, name)) for module, name, _ in replacements]
    for module, name, value in replacements:
        setattr(module, name, value)
    try:
        yield
    finally:
        for module, name, value in saved:
            setattr(module, name, value)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, flops: float):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _randn(rng, shape, dev):
    import numpy as np
    import torch

    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)


def kernel_cases(dev, seed: int):
    import numpy as np
    import torch
    import torch.nn.functional as F

    import merv_tpu_torch.ops.attention as A

    cases = []

    def record(kernel, name, shape, out, ref, mag, fn, plain, lib, bytes_moved, flops, extra=None):
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            raise RuntimeError(f"{kernel}/{name}: non-finite kernel output")
        h = hold(out, ref, mag)
        at = h["worst_at"]
        ms, plain_ms, lib_ms = time_ms(fn, 20), time_ms(plain, 5), time_ms(lib, 20)
        bound_ms, bound_by = bound(bytes_moved, flops)
        row = dict(kernel=kernel, case=name, shape=shape, **h, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bound_ms, bound_by=bound_by, **(extra or {}))
        log(f"[kernel] {kernel:24s} {name:22s} {shape} max_err={h['max_abs_err']:.3e} "
            f"mean_err={h['mean_abs_err']:.3e} mean|ref|={h['mean_abs_ref']:.3e} mean_limit={h['mean_limit']:.3e} "
            f"worst/limit={h['worst_share_of_limit']:.3f} (err {at['err']:.3e} at ref {at['ref']:.3e}, "
            f"mag {at['mag']:.3e}) ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by})")
        if not h["ok"]:
            raise RuntimeError(f"{kernel}/{name}: outside |out - ref| <= {KERNEL_REL_TOL:.3g}*(|ref| + mag) + "
                               f"{KERNEL_ABS_TOL} or mean err <= {KERNEL_MEAN_SHARE} * mean limit")
        cases.append(row)

    rng = np.random.default_rng(seed)
    # K1: tower frame attention (DINOv2 T=261, LanguageBind spatial T=257)
    for name, T in (("dinov2_frames", 261), ("languagebind_spatial", 257)):
        B, H, D = 16, 16, 64
        q, k, v = (_randn(rng, (B, H, T, D), dev) for _ in range(3))
        kt = k.transpose(-1, -2).contiguous()
        scale = D ** -0.5
        out = A.small_attention_kt(q, kt, v, scale)
        ref = A.small_attention_kt_plain(q, kt, v, scale)
        mag = A.small_attention_kt_plain(q, kt, v.abs(), scale)
        record(
            "small_attention_kt", name, [B, H, T, D], out, ref, mag,
            lambda: A.small_attention_kt(q, kt, v, scale),
            lambda: A.small_attention_kt_plain(q, kt, v, scale),
            lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
            bytes_moved=4 * q.numel() * 2, flops=4.0 * B * H * T * T * D,
        )

    # K2: flash forward. (name, B, H, Hk, Tq, Tk, D, causal, q_offset, kv valid length per row / None)
    flash = [
        ("vivit_frames", 1, 12, 12, 3137, 3137, 64, False, None, None),
        # cache prefill: 1053 valid prompt tokens (BOS + 1024 visual + 28 text) padded to
        # 1088, against a 1120-slot cache whose last 32 slots are not written yet
        ("llama_cache_prefill", 1, 32, 32, 1088, 1120, 128, True, 0, "prefill"),
        ("gqa_causal", 1, 32, 8, 1088, 1088, 128, True, None, None),
        ("fully_masked_row", 2, 8, 8, 256, 512, 64, False, None, "row1_empty"),
    ]
    for name, B, H, Hk, Tq, Tk, D, causal, q_offset, mask_kind in flash:
        q = _randn(rng, (B, H, Tq, D), dev)
        k, v = (_randn(rng, (B, Hk, Tk, D), dev) for _ in range(2))
        mask = None
        if mask_kind == "prefill":
            mask = torch.zeros((B, Tk), dtype=torch.bool, device=dev)
            mask[:, :1053] = True
        elif mask_kind == "row1_empty":
            mask = torch.ones((B, Tk), dtype=torch.bool, device=dev)
            mask[1] = False
        kw = dict(causal=causal, kv_mask=mask, q_offset=q_offset)
        out = A.flash_attention_forward(q, k, v, **kw)
        ref = A.flash_attention_forward_plain(q, k, v, **kw)
        mag = A.flash_attention_forward_plain(q, k, v.abs(), **kw)
        extra = {}
        if mask_kind == "row1_empty":
            torch.cuda.synchronize()
            if out[1].abs().max().item() != 0.0:
                raise RuntimeError("flash_attention_forward: a row with no valid key must be exactly 0")
            extra["masked_row_exact_zero"] = True
        # valid (query, key) pairs this run's masks leave: the work the function needs
        valid = torch.ones((B, Tq, Tk), dtype=torch.bool, device=dev)
        if mask is not None:
            valid &= mask[:, None, :]
        if causal:
            off = Tk - Tq if q_offset is None else q_offset
            valid &= torch.arange(Tk, device=dev)[None, :] <= torch.arange(Tq, device=dev)[:, None] + off
        pairs = valid.sum().item() * H
        kr, vr = (k, v) if Hk == H else (k.repeat_interleave(H // Hk, 1), v.repeat_interleave(H // Hk, 1))
        sdpa_mask = valid[:, None] if (mask is not None or causal) else None
        bytes_moved = (2 * q.numel() + k.numel() + v.numel()) * 2 + (0 if mask is None else mask.numel())
        record(
            "flash_attention_forward", name, [B, H, Hk, Tq, Tk, D], out, ref, mag,
            lambda: A.flash_attention_forward(q, k, v, **kw),
            lambda: A.flash_attention_forward_plain(q, k, v, **kw),
            lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=sdpa_mask),
            bytes_moved=bytes_moved, flops=4.0 * pairs * D, extra=extra,
        )
    return cases


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def build_merv_base(dev, seed: int):
    import torch

    from merv_tpu_torch.conf import MERV_Base
    from merv_tpu_torch.device import make_generator
    from merv_tpu_torch.models.materialize import (
        get_llm_backbone_and_tokenizer,
        get_video_backbone_and_transform,
        get_vidlm,
    )

    cfg = MERV_Base()
    g = make_generator(dev, seed)
    vbs, _ = get_video_backbone_and_transform(
        cfg.video_backbone_ids, cfg.image_resize_strategy, cfg.num_frames,
        device=dev, param_dtype=torch.bfloat16, generator=g,
    )
    llm, _ = get_llm_backbone_and_tokenizer(
        cfg.llm_backbone_id, cfg.llm_max_length, inference_mode=True, device=dev, generator=g
    )
    vidlm = get_vidlm(
        cfg.model_id, cfg.arch_specifier, cfg.feature_fusion, vbs, llm,
        projector_token_length=cfg.projector_token_length, visual_feature_length=cfg.visual_feature_length,
        param_dtype=torch.bfloat16, device=dev, generator=g,
    )
    return cfg, vidlm.eval()


def planted_faults():
    """Faulty stand-ins for the plain versions, as (module, name, function):
    kernel faults the checks should see, or show they cannot."""
    import torch

    import merv_tpu_torch.models.backbones.video.vit as vit
    import merv_tpu_torch.ops.attention as A

    small_plain, flash_plain = A.small_attention_kt_plain, A.flash_attention_forward_plain

    def k1_ragged_tail_dropped(q, kt, v, scale):
        # keys past the last whole 64-key tile ignored (DINOv2: 5 of 261, LanguageBind: 1 of 257)
        n = kt.shape[-1] // 64 * 64
        return small_plain(q, kt[..., :n].contiguous(), v[..., :n, :].contiguous(), scale)

    def k1_scores_in_bf16(q, kt, v, scale):
        s = torch.matmul(q, kt).float() * scale  # QK^T rounded to bf16 before the softmax
        p = torch.exp(s - s.amax(-1, keepdim=True))
        return (torch.matmul(p.to(v.dtype).float(), v.float()) / p.sum(-1, keepdim=True)).to(q.dtype)

    def k2_causal_top_left(q, k, v, *, causal, kv_mask=None, scale=None, q_offset=None):
        # q_offset dropped: the cache prefill's queries see Tk - Tq = 32 keys ahead
        return flash_plain(q, k, v, causal=causal, kv_mask=kv_mask, scale=scale)

    def k2_kv_mask_ignored(q, k, v, *, causal, kv_mask=None, scale=None, q_offset=None):
        return flash_plain(q, k, v, causal=causal, scale=scale, q_offset=q_offset)

    return {
        "k1_ragged_tail_dropped": (vit, "small_attention_kt_plain", k1_ragged_tail_dropped),
        "k1_scores_in_bf16": (vit, "small_attention_kt_plain", k1_scores_in_bf16),
        "k2_causal_top_left": (A, "flash_attention_forward_plain", k2_causal_top_left),
        "k2_kv_mask_ignored": (A, "flash_attention_forward_plain", k2_kv_mask_ignored),
    }


def main_path(dev, seed: int, max_new_tokens: int):
    import numpy as np
    import torch

    import merv_tpu_torch.models.backbones.video.vit as vit
    import merv_tpu_torch.ops.attention as A
    from merv_tpu_torch.models.generation import prefill

    t0 = time.perf_counter()
    cfg, vidlm = build_merv_base(dev, seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in vidlm.parameters())
    log(f"[main] built {cfg.model_id}: {n_params / 1e9:.3f} B params in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    questions = [
        "What is happening in this video?",
        "Describe the main object and its motion in detail.",
        "How many people appear, and what are they doing?",
    ]
    prompts = [vidlm.llm_backbone.prompt_builder_fn("merv").get_potential_prompt(q) for q in questions]
    rng = np.random.default_rng(seed + 1)
    videos = [rng.integers(0, 256, size=(32, 256, 320, 3), dtype=np.uint8) for _ in prompts]

    # warm-up request (cuBLAS handles, allocator), outside the counted window
    vidlm.generate(videos[0], prompts[0], max_new_tokens=2)
    torch.cuda.synchronize()

    A.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    requests = []
    texts = []
    for i, (video, prompt) in enumerate(zip(videos, prompts)):
        timings = {}
        t = time.perf_counter()
        text = vidlm.generate(video, prompt, max_new_tokens=max_new_tokens, timings=timings)
        # random weights: most ids fall outside the byte tokenizer's range and decode to nothing
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        steps = timings["decode_steps"]
        row = dict(request=i, wall_s=wall, prepare_s=timings["prepare_s"], towers_s=timings["towers_s"],
                   project_fuse_s=timings["project_fuse_s"], prefill_s=timings["prefill_s"],
                   decode_s=timings["decode_s"], decode_steps=steps,
                   decode_tokens_per_s=steps / timings["decode_s"] if steps else None, text=text)
        requests.append(row)
        texts.append(text)
        log(f"[main] request {i}: wall {wall:.3f} s = prepare {row['prepare_s']:.3f} + towers {row['towers_s']:.3f} "
            f"+ projector/fusion {row['project_fuse_s']:.4f} + prefill {row['prefill_s']:.3f} "
            f"+ decode {row['decode_s']:.3f} s ({steps} steps, {row['decode_tokens_per_s']} tok/s); "
            f"text {text[:40]!r}")

    # batched: a video row and a text-only row with a shorter prompt
    ids, mask, vids, is_mm = vidlm._prepare_batch_inputs([videos[0], None], [prompts[1], prompts[0][:12]])
    timings = {}
    t = time.perf_counter()
    batch_tokens = vidlm.generate_ids(ids, mask, vids, is_multimodal=is_mm, max_new_tokens=max_new_tokens,
                                      timings=timings)
    torch.cuda.synchronize()
    batch_wall = time.perf_counter() - t
    counts = A.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    vocab = vidlm.llm_backbone.decoder_config.vocab_size
    if tuple(batch_tokens.shape) != (2, max_new_tokens) or not bool(((batch_tokens >= 0) & (batch_tokens < vocab)).all()):
        raise RuntimeError(f"batched generate_ids: bad output {tuple(batch_tokens.shape)}")
    log(f"[main] batched generate_ids B=2 (video + text-only): wall {batch_wall:.3f} s, "
        f"prompt lengths {mask.sum(1).tolist()}, is_multimodal {is_mm.tolist()}")
    log(f"[main] launches during the main path: {counts}; peak memory {peak_gib:.2f} GiB")
    for kname, n in counts.items():
        if n <= 0:
            raise RuntimeError(f"kernel {kname} was not launched on the main path")

    # whole-path comparison with the plain versions (request 0)
    ids, mask, vids, is_mm = vidlm._prepare_batch_inputs([videos[0]], [prompts[0]])

    def run(impl):
        embeds, emask = vidlm.build_inputs_embeds(ids, mask, vids, is_mm, attn_impl=impl)
        if embeds.shape[1] != ids.shape[1] + cfg.visual_feature_length:
            raise RuntimeError(f"spliced stream has {embeds.shape[1]} positions")
        logits, _, _ = prefill(vidlm.llm_backbone.decoder, embeds, emask.long(),
                               embeds.shape[1] + max_new_tokens, attn_impl=impl)
        if not (torch.isfinite(embeds).all() and torch.isfinite(logits).all()):
            raise RuntimeError(f"non-finite embeddings or prefill logits (impl={impl})")
        return embeds.float(), logits.float()

    def run_held():
        """run("auto") with every kernel call held, by ``hold``, against the
        plain version (as the module holds it now) on the call's own inputs."""
        calls = {name: [] for name in KERNELS}
        small, flash = vit.small_attention_kt, A.flash_attention_forward

        def small_held(q, kt, v, scale):
            out = small(q, kt, v, scale)
            calls["small_attention_kt"].append(hold(out, vit.small_attention_kt_plain(q, kt, v, scale),
                                                    vit.small_attention_kt_plain(q, kt, v.abs(), scale)))
            return out

        def flash_held(q, k, v, **kw):
            out = flash(q, k, v, **kw)
            calls["flash_attention_forward"].append(hold(out, A.flash_attention_forward_plain(q, k, v, **kw),
                                                         A.flash_attention_forward_plain(q, k, v.abs(), **kw)))
            return out

        with patched((vit, "small_attention_kt", small_held), (A, "flash_attention_forward", flash_held)):
            run("auto")
        return {name: dict(calls=len(c), ok=all(x["ok"] for x in c),
                           worst_share_of_limit=max((x["worst_share_of_limit"] for x in c), default=0.0),
                           worst_mean_share=max((x["mean_abs_err"] / x["mean_limit"] for x in c), default=0.0))
                for name, c in calls.items()}

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    def show(held):
        return "; ".join(f"{name} {h['calls']} calls, worst/limit {h['worst_share_of_limit']:.3f}, "
                         f"mean err/mean limit {h['worst_mean_share']:.4f}" for name, h in held.items())

    ref_embeds, ref_logits = run("plain")
    embeds, logits = run("auto")
    rel_embeds, rel_logits = rel(embeds, ref_embeds), rel(logits, ref_logits)
    held = run_held()
    tok_auto = vidlm.generate_ids(ids, mask, vids, is_multimodal=is_mm, max_new_tokens=max_new_tokens)
    tok_plain = vidlm.generate_ids(ids, mask, vids, is_multimodal=is_mm, max_new_tokens=max_new_tokens,
                                   attn_impl="plain")
    agree = (tok_auto == tok_plain).float().mean().item()
    first_equal = bool((tok_auto[:, 0] == tok_plain[:, 0]).all())
    log(f"[main] kernels vs plain: spliced input embeddings (towers, projectors, fusion) relative L2 diff "
        f"{rel_embeds:.3e} (tol {EMBEDS_REL_TOL}); prefill last-position logits {rel_logits:.3e} "
        f"(tol {LOGITS_REL_TOL}); greedy-token agreement {agree:.3f} over {max_new_tokens} tokens; "
        f"first token equal: {first_equal}")
    log(f"[main] each kernel call of request 0 against its plain version on its own inputs: {show(held)}")
    if not rel_embeds <= EMBEDS_REL_TOL:
        raise RuntimeError(f"kernel path embeddings differ from the plain path by {rel_embeds}")
    if not rel_logits <= LOGITS_REL_TOL:
        raise RuntimeError(f"kernel path logits differ from the plain path by {rel_logits}")
    for name, h in held.items():
        if h["calls"] == 0:
            raise RuntimeError(f"{name}: no call on request 0's path")
        if not h["ok"]:
            raise RuntimeError(f"{name}: a call on the main path is outside its limit against the plain version")

    # what the same checks give for a planted fault: one plain version swapped
    # for a faulty one, read on the whole path and call by call
    faults = {}
    for fname, fault in planted_faults().items():
        with patched(fault):
            f_embeds, f_logits = run("plain")
            f_held = run_held()
        fe, fl = rel(f_embeds, ref_embeds), rel(f_logits, ref_logits)
        faults[fname] = dict(embeds_rel_diff=fe, logits_rel_diff=fl, caught_whole_path=fe > EMBEDS_REL_TOL or
                             fl > LOGITS_REL_TOL, caught_call_by_call=not all(h["ok"] for h in f_held.values()),
                             held=f_held)
        log(f"[fault] {fname:24s} whole path: embeds {fe:.3e} logits {fl:.3e} -> "
            f"{'caught' if faults[fname]['caught_whole_path'] else 'not caught'}; call by call: {show(f_held)} -> "
            f"{'caught' if faults[fname]['caught_call_by_call'] else 'not caught'}")
    return dict(model=cfg.model_id, params=n_params, requests=requests, batched_wall_s=batch_wall,
                batched_timings=timings, launches=counts, peak_memory_gib=peak_gib,
                embeds_rel_diff=rel_embeds, logits_rel_diff=rel_logits, held_call_by_call=held,
                greedy_agreement=agree, first_token_equal=first_equal, planted_faults=faults)


# ---------------------------------------------------------------------------


KERNELS = {
    "small_attention_kt": dict(source="merv_tpu_torch/csrc/small_attention_kt.cu",
                               replaces="merv_tpu/ops/attention.py:540", main_case="dinov2_frames"),
    "flash_attention_forward": dict(source="merv_tpu_torch/csrc/flash_fwd.cu",
                                    replaces="merv_tpu/ops/attention.py:376", main_case="llama_cache_prefill"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] {kind}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from merv_tpu_torch.ops import _build

    t = time.perf_counter()
    logs = _build.build_all(verbose=True)
    build_s = time.perf_counter() - t
    log(f"[build] {len(logs)} kernel libraries built with nvcc (sm_90a) in {build_s:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    cases = kernel_cases(dev, args.seed)
    main = main_path(dev, args.seed, args.max_new_tokens)

    kernels = []
    for name, meta in KERNELS.items():
        mine = [c for c in cases if c["kernel"] == name]
        head = next(c for c in mine if c["case"] == meta["main_case"])
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=main["launches"][name], max_abs_err=max(c["max_abs_err"] for c in mine),
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], shape=head["shape"], cases=mine,
        ))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(device=kind, nvidia_smi=smi, build_s=build_s, kernels=kernels, main_path=main), f, indent=1)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
