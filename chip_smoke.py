#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``merv_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--max-new-tokens 32]

Phases, each of which fails the run (non-zero exit, no result line) if it fails:
1. device: the card's name and ``nvidia-smi`` power limit; no CUDA -> exit 2.
2. build: ``nvcc`` compiles every ``merv_tpu_torch/csrc/*.cu`` for sm_90a.
3. kernels: each hand-written kernel against its plain PyTorch version at the
   main paths' shapes (bf16, inputs from a numpy seed), with max/mean abs
   error against a stated tolerance and CUDA-event times of the kernel, the
   plain version and one PyTorch library call (SDPA, forward + backward for
   the backward kernel: a yardstick only, the port never calls it), beside
   the shape's lower bound on this card. The flash forward's log-sum-exp is
   held row by row against the plain version's; the backward kernel is held
   twice: against the plain backward on the forward kernel's o and lse, and
   against the plain backward on the plain forward's.
4. serving path: merv-base at full width (four towers at 224 px with
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
5. training path: merv-base's align stage at full width and depth (fp32
   projectors and fusion trained, bf16 towers and LLM frozen) through
   ``get_train_strategy`` -> ``run_setup`` -> ``run_training``: 3 steps of
   global batch 32 (per-device batch 16, accumulation 2), remat on, the loss
   streamed in 256-token blocks, on seeded uint8 frames normalised on the
   card and ByteTokenizer captions, launch counters zeroed just before and
   read just after. Checks: finite losses; trainables unchanged by step 1
   (lr 0) and moved by step 3; towers and LLM bit-identical; launches per
   micro-step as predicted; on one micro-batch of 1, the loss and the
   trainables' gradients against the all-plain path, every forward-kernel
   call's output and log-sum-exp and every backward-kernel call held against
   the plain versions on the call's own inputs, and three planted faults
   (two of the backward, one of the log-sum-exp) that these checks must
   catch. One more micro-step of the
   per-device batch runs under ``torch.profiler`` for the device time by
   kernel group and the device's idle share.
6. output: ``nvidia-smi`` line, a ``{"kernels": [...]}`` line (``launches``
   from the training path, ``launches_serving`` from the serving path), and
   the last line ``{"ok": true, "device": {...}}``. Details go to
   ``chiprun_out/chip_smoke.json``.

Imports nothing of JAX or of ``merv_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
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
# K2's log-sum-exp against the plain version's, row by row:
# |lse - ref| <= LSE_REL_TOL * (1 + |ref|) where ref is finite, and +inf on
# exactly the rows where ref is +inf (no valid key). Both sum the exponentials
# of the same fp32 scores in fp32, in different orders (about 1e-6 of |lse|);
# the backward recomputes P = exp(S - lse), so an lse off by d scales the
# row's P, and its gradients, by exp(-d).
LSE_REL_TOL = 1e-4
LSE_PLANTED_OFFSET = 0.05
# training path (merv-base align stage): the recipe's global batch 32 over 3
# steps (the first at lr 0, untimed), the streamed loss's token block, the
# kernel launches one micro-step makes (K1: 23 DINOv2 + 23 LanguageBind
# layers; K2: 12 ViViT layers + 32 LLM layers twice, the forward and its
# recompute under remat; the backward: 32 LLM layers), and the limits of the
# kernels-vs-plain comparison on one micro-batch (relative difference of the
# loss, relative L2 difference of the projectors' and the fusion's gradients)
TRAIN_GLOBAL_BATCH = 32
TRAIN_STEPS = 3
TRAIN_LOSS_CHUNK = 256
TRAIN_LAUNCHES_PER_MICRO_STEP = {"small_attention_kt": 46, "flash_attention_forward": 76, "flash_attention_backward": 32}
TRAIN_LOSS_REL_TOL = 1e-2
TRAIN_GRAD_REL_TOL = 0.1


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


def hold_lse(lse, ref) -> dict:
    """K2's log-sum-exp against the plain version's ``ref`` under
    LSE_REL_TOL: the worst share of the limit over the finite rows, and
    whether +inf marks exactly the same rows."""
    import torch

    lse, ref = lse.float(), ref.float()
    empty = torch.isinf(ref) & (ref > 0)
    same_empty = bool(torch.equal(torch.isposinf(lse), empty))
    err = (lse[~empty] - ref[~empty]).abs()
    share = (err / (LSE_REL_TOL * (1 + ref[~empty].abs()))).max().item() if err.numel() else 0.0
    return dict(max_abs_err=err.max().item() if err.numel() else 0.0, worst_share_of_limit=share,
                empty_rows=int(empty.sum().item()), same_empty_rows=same_empty,
                ok=same_empty and share <= 1.0)  # a NaN share fails


def backward_mags(q, k, v, lse, do, *, causal: bool, kv_mask=None, scale=None, o_mag=None):
    """The magnitudes the backward's bf16 roundings scale with, per output
    element, in fp32: dq -> scale |dS| |K|, dk -> scale |dS|^T |Q| and
    dv -> P^T |dO| (kv heads folded as in GQA). With them ``hold`` applies to
    the gradients: each side rounds P (for dV) or dS (for dK, dQ) to bf16 once,
    at most 2**-8 of each term, and rounds its result once (2**-8 |ref|), so
    kernel and plain version differ by at most 2**-7 (|ref| + mag).

    ``o_mag``: when the two sides start from different forward outputs (the
    kernel's o against the plain version's, each within ``hold``'s limit of
    the other, 2**-7 * o_mag with o_mag = |o| + mag_o + KERNEL_ABS_TOL /
    KERNEL_REL_TOL), delta = rowsum(dO * O) differs by at most
    2**-7 * rowsum(|dO| o_mag), so P * rowsum(|dO| o_mag) joins |dS|."""
    import torch

    import merv_tpu_torch.ops.attention as A

    B, H, Tq, D = q.shape
    Hk, Tk = k.shape[1], k.shape[2]
    kr, vr = A._repeat_kv(k, v, H)
    scale = D ** -0.5 if scale is None else scale
    qf, kf, vf, dof = q.float(), kr.float(), vr.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    vis = A._visible(B, Tq, Tk, causal, kv_mask, Tk - Tq, q.device)
    p = torch.where(vis, torch.exp(s - lse.float()[..., None]), torch.zeros_like(s))
    del s
    o = A.flash_attention_forward_plain(q, k, v, causal=causal, kv_mask=kv_mask, scale=scale).float()
    ds = (p * (torch.matmul(dof, vf.transpose(-1, -2)) - (dof * o).sum(-1, keepdim=True))).abs()
    if o_mag is not None:
        ds = ds + p * (dof.abs() * o_mag.float()).sum(-1, keepdim=True)
    dq = torch.matmul(ds, kf.abs()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf.abs()) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof.abs())
    if Hk != H:
        dk = dk.view(B, Hk, H // Hk, Tk, D).sum(2)
        dv = dv.view(B, Hk, H // Hk, Tk, D).sum(2)
    return dq, dk, dv


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
        # the log-sum-exp, from a second launch that also writes o (which must not change)
        out_lse, lse = A.flash_attention_forward(q, k, v, return_lse=True, **kw)
        lse_ref = A.flash_attention_forward_plain(q, k, v, return_lse=True, **kw)[1]
        lse_h, planted = hold_lse(lse, lse_ref), hold_lse(lse + LSE_PLANTED_OFFSET, lse_ref)
        log(f"[kernel] flash_attention_forward {name:22s} lse: max_err={lse_h['max_abs_err']:.3e} "
            f"worst/limit={lse_h['worst_share_of_limit']:.4f} (|lse - ref| <= {LSE_REL_TOL:g}*(1 + |ref|)), "
            f"+inf rows {lse_h['empty_rows']} (same as plain: {lse_h['same_empty_rows']}); planted lse + "
            f"{LSE_PLANTED_OFFSET:g}: worst/limit {planted['worst_share_of_limit']:.2f} -> "
            f"{'not caught' if planted['ok'] else 'caught'}")
        if not torch.equal(out_lse, out):
            raise RuntimeError(f"flash_attention_forward/{name}: o changes when the lse is also written")
        if not lse_h["ok"]:
            raise RuntimeError(f"flash_attention_forward/{name}: lse outside its limit or +inf on other rows")
        if planted["ok"]:
            raise RuntimeError(f"flash_attention_forward/{name}: the lse check misses an offset of {LSE_PLANTED_OFFSET}")
        extra = dict(lse=lse_h, lse_planted_offset_share=planted["worst_share_of_limit"])
        if mask_kind == "row1_empty":
            torch.cuda.synchronize()
            if out[1].abs().max().item() != 0.0:
                raise RuntimeError("flash_attention_forward: a row with no valid key must be exactly 0")
            if lse_h["empty_rows"] != H * Tq:
                raise RuntimeError(f"flash_attention_forward: {lse_h['empty_rows']} +inf lse rows, not {H * Tq}")
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


def hold_from_plain_forward(q, k, v, lse, do, grads, **kw) -> dict:
    """What the backward kernel was given and gave, against the plain forward
    (the module's plain version as it stands): the forward kernel's ``lse``
    under ``hold_lse``, and the kernel's dq, dk, dv against the plain backward
    on the plain forward's o and lse, so that a fault of the kernel's o or lse
    cannot sit on both sides of the comparison."""
    import merv_tpu_torch.ops.attention as A

    o_p, lse_p = A.flash_attention_forward_plain(q, k, v, return_lse=True, **kw)
    o_mag = (o_p.float().abs() + A.flash_attention_forward_plain(q, k, v.abs(), **kw).float()
             + KERNEL_ABS_TOL / KERNEL_REL_TOL)
    return dict(lse=hold_lse(lse, lse_p), backward=hold_backward(q, k, v, o_p, lse_p, do, grads, o_mag=o_mag, **kw))


def visible_pairs(B, Tq, Tk, causal, mask, dev) -> int:
    """(query, key) pairs a head's function lets through, summed over the batch."""
    import torch

    valid = torch.ones((B, Tq, Tk), dtype=torch.bool, device=dev)
    if mask is not None:
        valid &= mask[:, None, :]
    if causal:
        valid &= torch.arange(Tk, device=dev)[None, :] <= torch.arange(Tq, device=dev)[:, None] + (Tk - Tq)
    return int(valid.sum().item())


def hold_backward(q, k, v, o, lse, do, grads, o_mag=None, **kw) -> dict:
    """dq, dk, dv of the kernel against the plain backward on q, k, v, do and
    the given o and lse (the module's plain version as it stands: a planted
    fault swaps it), each under ``hold`` with ``backward_mags``; the worst of
    the three."""
    import merv_tpu_torch.ops.attention as A

    refs = A.flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
    mags = backward_mags(q, k, v, lse, do, o_mag=o_mag, **kw)
    held = {name: hold(g, r, m) for name, g, r, m in zip(("dq", "dk", "dv"), grads, refs, mags)}
    worst = max(held.values(), key=lambda h: h["worst_share_of_limit"])
    return dict(worst, ok=all(h["ok"] for h in held.values()), per_grad=held,
                worst_mean_share=max(h["mean_abs_err"] / h["mean_limit"] for h in held.values()))


# (name, B, H, Hk, T, D, causal, mask kind): Tq == Tk, as in training
BACKWARD_CASES = [
    ("llama_training", 1, 32, 32, 3072, 128, True, None),
    ("gqa_causal", 1, 32, 8, 1088, 128, True, None),
    # ragged 1000 tokens; row 0 loses its last 100 keys, row 1 has no valid key at all
    ("ragged_fully_masked_row", 2, 8, 8, 1000, 128, True, "row1_empty"),
    ("vivit_d64", 1, 12, 12, 3137, 64, False, None),
]


def backward_cases(dev, seed: int):
    """The backward kernel against the plain backward, from the forward
    kernel's o and lse, with CUDA-event times of the kernel, the plain
    version and SDPA forward + backward (a yardstick only)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    import merv_tpu_torch.ops.attention as A

    rng = np.random.default_rng(seed + 7)
    cases = []
    for name, B, H, Hk, T, D, causal, mask_kind in BACKWARD_CASES:
        q = _randn(rng, (B, H, T, D), dev)
        k, v = (_randn(rng, (B, Hk, T, D), dev) for _ in range(2))
        do = _randn(rng, (B, H, T, D), dev)
        mask = None
        if mask_kind == "row1_empty":
            mask = torch.ones((B, T), dtype=torch.bool, device=dev)
            mask[0, T - 100:] = False
            mask[1] = False
        kw = dict(causal=causal, kv_mask=mask)
        o, lse = A.flash_attention_forward(q, k, v, return_lse=True, **kw)
        grads = A.flash_attention_backward(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        if not all(torch.isfinite(g.float()).all() for g in grads):
            raise RuntimeError(f"flash_attention_backward/{name}: non-finite gradient")
        h = hold_backward(q, k, v, o, lse, do, grads, **kw)
        fp = hold_from_plain_forward(q, k, v, lse, do, grads, **kw)
        extra = dict(lse=fp["lse"], from_plain_forward={g: {x: y for x, y in r.items() if x != "worst_at"}
                                                        for g, r in fp["backward"]["per_grad"].items()})
        if mask_kind == "row1_empty":
            if any(g[1].abs().max().item() != 0.0 for g in grads):
                raise RuntimeError("flash_attention_backward: a row with no valid key must have zero gradient")
            if fp["lse"]["empty_rows"] != H * T:
                raise RuntimeError(f"flash_attention_forward: {fp['lse']['empty_rows']} +inf lse rows, not {H * T}")
            extra["masked_row_exact_zero"] = True

        kr, vr = (k, v) if Hk == H else (k.repeat_interleave(H // Hk, 1), v.repeat_interleave(H // Hk, 1))
        leaves = [x.detach().clone().requires_grad_() for x in (q, kr, vr)]
        sdpa_mask = None
        if mask is not None:
            sdpa_mask = mask[:, None, None, :] & (torch.ones((T, T), dtype=torch.bool, device=dev).tril()
                                                  if causal else True)

        def library():
            for x in leaves:
                x.grad = None
            out = F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_mask, is_causal=causal and mask is None)
            out.backward(do)

        ms = time_ms(lambda: A.flash_attention_backward(q, k, v, o, lse, do, **kw), 10)
        plain_ms = time_ms(lambda: A.flash_attention_backward_plain(q, k, v, o, lse, do, **kw), 3)
        lib_ms = time_ms(library, 10)
        pairs = visible_pairs(B, T, T, causal, mask, dev) * H
        # read q, k, v, o, dO (bf16), lse (fp32) and the mask once; write dq, dk, dv
        bytes_moved = ((4 * q.numel() + 2 * k.numel() + 2 * v.numel()) * 2 + lse.numel() * 4
                       + (0 if mask is None else mask.numel()))
        bound_ms, bound_by = bound(bytes_moved, 10.0 * D * pairs)
        row = dict(kernel="flash_attention_backward", case=name, shape=[B, H, Hk, T, T, D], **h, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by, **extra)
        per = "; ".join(f"{g} worst/limit {x['worst_share_of_limit']:.3f} max_err {x['max_abs_err']:.3e} "
                        f"mean_err/mean_limit {x['mean_abs_err'] / x['mean_limit']:.4f}"
                        for g, x in h["per_grad"].items())
        per_plain = "; ".join(f"{g} worst/limit {x['worst_share_of_limit']:.3f} mean_err/mean_limit "
                              f"{x['mean_abs_err'] / x['mean_limit']:.4f}" for g, x in fp["backward"]["per_grad"].items())
        log(f"[kernel] flash_attention_backward {name:24s} {row['shape']} {per}; ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms(SDPA fwd+bwd)={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
        log(f"[kernel] flash_attention_backward {name:24s} against the plain backward on the plain forward's o and "
            f"lse: {per_plain}; forward kernel's lse worst/limit {fp['lse']['worst_share_of_limit']:.4f}, +inf rows "
            f"{fp['lse']['empty_rows']} (same as plain: {fp['lse']['same_empty_rows']})")
        if not h["ok"]:
            raise RuntimeError(f"flash_attention_backward/{name}: a gradient is outside its limit against the plain "
                               f"backward")
        if not fp["lse"]["ok"] or not fp["backward"]["ok"]:
            raise RuntimeError(f"flash_attention_backward/{name}: the lse, or a gradient against the plain backward "
                               f"on the plain forward's o and lse, is outside its limit")
        cases.append(row)
        del grads, leaves, o, lse
    return cases


# ---------------------------------------------------------------------------
# phase 4: the serving path
# ---------------------------------------------------------------------------


def build_merv_base(dev, seed: int, projector_dtype=None):
    """merv-base on random weights from a seeded generator on the card: towers
    and LLM stored in bf16; projectors and fusion in ``projector_dtype``
    (bf16 to serve, fp32 to train them)."""
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
        param_dtype=projector_dtype or torch.bfloat16, device=dev, generator=g,
    )
    return cfg, vidlm.eval()


def planted_faults():
    """Faulty stand-ins for the plain versions, as (module, name, function):
    kernel faults the checks should see, or show they cannot."""
    import torch

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

    def k2_causal_top_left(q, k, v, *, causal, kv_mask=None, scale=None, q_offset=None, return_lse=False):
        # q_offset dropped: the cache prefill's queries see Tk - Tq = 32 keys ahead
        return flash_plain(q, k, v, causal=causal, kv_mask=kv_mask, scale=scale, return_lse=return_lse)

    def k2_kv_mask_ignored(q, k, v, *, causal, kv_mask=None, scale=None, q_offset=None, return_lse=False):
        return flash_plain(q, k, v, causal=causal, scale=scale, q_offset=q_offset, return_lse=return_lse)

    return {
        "k1_ragged_tail_dropped": (A, "small_attention_kt_plain", k1_ragged_tail_dropped),
        "k1_scores_in_bf16": (A, "small_attention_kt_plain", k1_scores_in_bf16),
        "k2_causal_top_left": (A, "flash_attention_forward_plain", k2_causal_top_left),
        "k2_kv_mask_ignored": (A, "flash_attention_forward_plain", k2_kv_mask_ignored),
    }


def main_path(dev, seed: int, max_new_tokens: int):
    import numpy as np
    import torch

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
    for kname in SERVING_KERNELS:
        if counts[kname] <= 0:
            raise RuntimeError(f"kernel {kname} was not launched on the serving path")

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
        calls = {name: [] for name in SERVING_KERNELS}
        small, flash = A.small_attention_kt, A.flash_attention_forward

        def small_held(q, kt, v, scale):
            out = small(q, kt, v, scale)
            calls["small_attention_kt"].append(hold(out, A.small_attention_kt_plain(q, kt, v, scale),
                                                    A.small_attention_kt_plain(q, kt, v.abs(), scale)))
            return out

        def flash_held(q, k, v, **kw):
            out = flash(q, k, v, **kw)
            calls["flash_attention_forward"].append(hold(out, A.flash_attention_forward_plain(q, k, v, **kw),
                                                         A.flash_attention_forward_plain(q, k, v.abs(), **kw)))
            return out

        with patched((A, "small_attention_kt", small_held), (A, "flash_attention_forward", flash_held)):
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
# phase 5: the training path (merv-base align stage)
# ---------------------------------------------------------------------------

WORDS = ("a person walks across the room and picks up a red cup then sets it down near the window while a dog "
         "watches from the sofa outside cars pass slowly under grey clouds").split()


class CaptionVideos:
    """Align-stage items made from a seed, with AlignVideoDataset's contract:
    uint8 frames already at each tower's geometry ``[F, S, S, 3]`` (drawn
    from a small pool of random videos made at set-up), a caption of 20-60
    words tokenized with its end-of-sequence token, and its labels (the first
    token ignored)."""

    def __init__(self, n: int, resolutions, tokenizer, seed: int, pool: int = 4):
        import numpy as np

        rng = np.random.default_rng(seed)
        self.videos = [[rng.integers(0, 256, size=r, dtype=np.uint8) for r in resolutions] for _ in range(pool)]
        self.items = []
        for i in range(n):
            caption = " ".join(rng.choice(WORDS, size=int(rng.integers(20, 61))))
            ids = np.asarray(tokenizer(caption + tokenizer.eos_token, truncation=True).input_ids, np.int32)
            labels = ids.copy()
            labels[0] = -100
            self.items.append(dict(input_ids=ids, labels=labels, pool=int(rng.integers(pool))))

    def __getitem__(self, i):
        item = self.items[i]
        return dict(video_values=self.videos[item["pool"]], input_ids=item["input_ids"], labels=item["labels"],
                    is_image=False)

    def __len__(self):
        return len(self.items)


def host_copy(module) -> dict:
    """{parameter name: a copy in host memory}, to hold the module against
    after training with ``torch.equal``."""
    return {name: p.detach().cpu() for name, p in module.named_parameters()}


def changed(module, saved: dict) -> list:
    """Names of the parameters whose values differ from ``saved`` in any bit."""
    import torch

    return [name for name, p in module.named_parameters() if not torch.equal(p.detach(), saved[name].to(p.device))]


def planted_backward_faults():
    """Faulty stand-ins for the plain versions, as (module, name, function):
    faults of the training path's kernels that the call-by-call check must
    catch. The two backward faults show in a causal call's first rows: query
    0 sees one key, so its true dS is exactly 0 (P = 1, delta = dP) and
    dropping delta leaves dP there; a mask shifted by one gives key 1 a P of
    order 1 from query 0. Where attention is spread over many keys,
    delta = dO . O is small and the first fault all but vanishes. The third
    offsets the forward's log-sum-exp, which the backward recomputes P from."""
    import merv_tpu_torch.ops.attention as A

    plain, visible, forward = A.flash_attention_backward_plain, A._visible, A.flash_attention_forward_plain

    def k3_ds_without_delta(q, k, v, o, lse, do, **kw):
        # delta = rowsum(dO o O) is 0 when O is: dS = P o dP
        return plain(q, k, v, o.new_zeros(o.shape), lse, do, **kw)

    def k3_causal_shifted(q, k, v, o, lse, do, **kw):
        # each query also sees the key just after it
        shifted = lambda B, Tq, Tk, causal, mask, off, dev: visible(B, Tq, Tk, causal, mask, off + 1, dev)  # noqa
        with patched((A, "_visible", shifted)):
            return plain(q, k, v, o, lse, do, **kw)

    def k2_lse_offset(q, k, v, *, return_lse=False, **kw):
        # every row's log-sum-exp off by LSE_PLANTED_OFFSET: the backward's P scaled by exp(-offset)
        out = forward(q, k, v, return_lse=return_lse, **kw)
        return (out[0], out[1] + LSE_PLANTED_OFFSET) if return_lse else out

    return {
        "k3_ds_without_delta": (A, "flash_attention_backward_plain", k3_ds_without_delta),
        "k3_causal_shifted": (A, "flash_attention_backward_plain", k3_causal_shifted),
        "k2_lse_offset": (A, "flash_attention_forward_plain", k2_lse_offset),
    }


KERNEL_GROUPS = (  # device kernel name -> group, first match wins
    ("K1 small_attention_kt", ("small_attn_kt_kernel",)),
    ("K2 flash_attention_forward", ("flash_fwd_kernel",)),
    ("K3 flash_attention_backward", ("bwd_dkdv_kernel", "bwd_dq_kernel", "bwd_delta_kernel")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass", "Kernel2")),
)


def profile_micro_step(vidlm, transforms, batch) -> dict:
    """Device time by kernel group, and the device's idle share, over one
    training micro-step (forward, remat recompute and backward), from
    ``torch.profiler``; "not measured" if the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from merv_tpu_torch.training.train_step import make_loss_fn

    loss_fn = make_loss_fn(vidlm, remat=True, video_transforms=transforms, loss_chunk_size=TRAIN_LOSS_CHUNK)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        loss_fn(batch).backward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    for p in vidlm.parameters():
        p.grad = None
    # the device-side entries (kernels, copies, sets); operators only launch them
    kernels = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(ms for _, ms in kernels)
    if device_ms <= 0:
        log("[profile] the trace holds no device time: kernel split and idle share not measured")
        return dict(wall_ms=wall_ms, device_ms=None)
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    others = []
    for key, ms in kernels:
        g = next((g for g, names in KERNEL_GROUPS if any(n in key for n in names)), "other")
        groups[g] += ms
        if g == "other":
            others.append((ms, key))
    # one stream: kernels do not overlap, so busy time is their sum. A sum
    # above the wall time means events were counted twice: idle share not measured.
    top = [dict(ms=ms, kernel=key[:120]) for ms, key in sorted(others, reverse=True)[:6]]
    idle = 1 - device_ms / wall_ms if device_ms <= wall_ms else None
    out = dict(wall_ms=wall_ms, device_ms=device_ms, idle_share=idle, groups_ms=groups, top_other=top)
    idle_text = "not measured: device time exceeds the wall time" if idle is None else f"{idle:.4f}"
    log(f"[profile] one micro-step of {batch['input_ids'].shape[0]}: wall {wall_ms:.1f} ms, device busy "
        f"{device_ms:.1f} ms (idle share {idle_text}); " +
        ", ".join(f"{g} {ms:.1f} ms ({ms / device_ms:.3f})" for g, ms in groups.items()))
    log("[profile] largest other kernels: " + "; ".join(f"{t['ms']:.1f} ms {t['kernel']}" for t in top))
    return out


def train_path(dev, seed: int, run_dir: str):
    """merv-base's align stage through get_train_strategy -> run_setup ->
    run_training at full width and depth, then the checks of the module
    docstring's phase 5."""
    import gc
    import shutil

    import torch

    import merv_tpu_torch.ops.attention as A
    from merv_tpu_torch.training import Metrics, get_train_strategy
    from merv_tpu_torch.training.checkpointing import load_checkpoint
    from merv_tpu_torch.training.train_step import make_loss_fn
    from merv_tpu_torch.util.data_utils import PaddedCollatorForLanguageModeling

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, vidlm = build_merv_base(dev, seed, projector_dtype=torch.float32)
    per_device_batch, global_batch, max_steps = cfg.align_per_device_batch_size, TRAIN_GLOBAL_BATCH, TRAIN_STEPS
    vidlm.train()
    vidlm.freeze_backbones("align")
    transforms = [vb.get_video_transform() for vb in vidlm.video_backbones]
    res = [(nf, tf.target_size, tf.target_size, 3) for nf, tf in zip(cfg.num_frames, transforms)]
    ds = CaptionVideos(global_batch * max_steps, res, vidlm.llm_backbone.tokenizer, seed + 2)
    collator = PaddedCollatorForLanguageModeling(cfg.llm_max_length, vidlm.llm_backbone.pad_token_id, res)
    strategy = get_train_strategy(
        cfg.align_train_strategy, vidlm, stage="align", epochs=cfg.align_epochs, max_steps=max_steps,
        global_batch_size=global_batch, per_device_batch_size=per_device_batch,
        learning_rate=cfg.align_learning_rate, weight_decay=cfg.align_weight_decay,
        max_grad_norm=cfg.align_max_grad_norm, lr_scheduler_type=cfg.align_lr_scheduler_type,
        warmup_ratio=cfg.align_warmup_ratio, enable_gradient_checkpointing=True, save_checkpoint_after=1,
        loss_chunk_size=TRAIN_LOSS_CHUNK,
    )
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    strategy.run_setup(run_dir, n_train_examples=len(ds), video_transforms=transforms, seed=seed)
    trainable = vidlm.trainable_mask()
    tnames = [n for n, t in trainable.items() if t]
    init = {n: p.detach().cpu().clone() for n, p in vidlm.named_parameters() if trainable[n]}
    frozen = {k: (m, host_copy(m)) for k, m in (("towers", vidlm.video_backbones), ("llm", vidlm.llm_backbone))}
    micro = strategy.grad_accumulation_steps * max_steps
    torch.cuda.synchronize()
    log(f"[train] built {cfg.model_id} for the align stage in {time.perf_counter() - t0:.1f} s: "
        f"{sum(init[n].numel() for n in tnames) / 1e6:.2f} M trainable parameters (fp32) in {len(tnames)} tensors, "
        f"per-device batch {per_device_batch}, global batch {global_batch} (accumulation "
        f"{strategy.grad_accumulation_steps}), {max_steps} steps, T = {cfg.llm_max_length} + "
        f"{cfg.visual_feature_length}; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    metrics = Metrics(("jsonl",), "smoke", run_dir, {}, "align", grad_accumulation_steps=strategy.grad_accumulation_steps,
                      total_steps=max_steps)
    step_timings = []
    A.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    strategy.run_training(ds, collator, metrics, stage="align", seed=seed, run_dir=run_dir, num_workers=0,
                          step_timings=step_timings)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t
    counts = A.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    metrics.finalize()

    losses = [st["loss"] for st in step_timings]
    logged = [json.loads(x)["Align/Step"] for x in open(os.path.join(run_dir, "smoke.jsonl"))]
    if logged != list(range(1, max_steps + 1)):
        raise RuntimeError(f"the JSONL metrics logged steps {logged}")
    tokens = global_batch * (cfg.llm_max_length + cfg.visual_feature_length)
    for i, st in enumerate(step_timings):
        log(f"[train] step {i + 1}: {st['step_s']:.3f} s = towers {st['towers_s']:.3f} + LLM forward/backward "
            f"{st['llm_s']:.3f} + optimizer {st['optimizer_s']:.4f} (+ rest "
            f"{st['step_s'] - st['towers_s'] - st['llm_s'] - st['optimizer_s']:.3f}); loss {losses[i]:.4f}; "
            f"{tokens / st['step_s']:.0f} tokens/s")
    timed = step_timings[1:]
    step_s = sum(st["step_s"] for st in timed) / len(timed)
    split = {k: sum(st[k] for st in timed) / len(timed) for k in ("towers_s", "llm_s", "optimizer_s")}
    per_micro = {k: v / micro for k, v in counts.items()}
    log(f"[train] steps 2-{max_steps}: {step_s:.3f} s per step, {tokens / step_s:.0f} tokens/s "
        f"({tokens} tokens per step); run_training wall {train_wall:.1f} s; peak memory {peak_gib:.2f} GiB; "
        f"launches {counts} = per micro-step {per_micro} over {micro} micro-steps")

    # checks: finite losses; lr 0 on step 1; trainables moved by step 3; frozen parameters equal to their
    # saved copies; launches
    if len(losses) != max_steps or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"training losses {losses}")
    step1 = next(p for p in os.listdir(os.path.join(run_dir, "checkpoints")) if p.startswith("step-000001-"))
    after1 = load_checkpoint(os.path.join(run_dir, "checkpoints", step1))["model"]
    for n in tnames:
        key, rest = n.split(".", 1)
        if not torch.equal(after1[key][rest], init[n]):
            raise RuntimeError(f"{n} moved on step 1, whose learning rate is 0")
    moved = [n for n, p in vidlm.named_parameters() if trainable[n] and not torch.equal(p.detach().cpu(), init[n])]
    if not moved:
        raise RuntimeError(f"no trainable parameter moved in {max_steps} steps")
    for k, (m, saved) in frozen.items():
        if changed(m, saved):
            raise RuntimeError(f"frozen {k} changed during training: {changed(m, saved)[:5]}")
    del frozen
    expect = {k: v * micro for k, v in TRAIN_LAUNCHES_PER_MICRO_STEP.items()}
    if counts != expect:
        raise RuntimeError(f"training launches {counts}, predicted {expect}")
    log(f"[train] checks: {max_steps} finite losses; trainables bit-identical after step 1 (lr 0) and "
        f"{len(moved)}/{len(tnames)} tensors moved by step {max_steps}; towers and LLM bit-identical; launches as "
        f"predicted")

    profile = profile_micro_step(vidlm, transforms, strategy._put_batch(collator([ds[i] for i in range(per_device_batch)])))

    # kernels vs plain on one micro-batch of 1, every backward-kernel call held against the plain backward
    batch1 = strategy._put_batch(collator([ds[0]]))
    named = [(n, p) for n, p in vidlm.named_parameters() if trainable[n]]

    def micro_step(impl):
        for _, p in named:
            p.grad = None
        loss = make_loss_fn(vidlm, remat=True, video_transforms=transforms, loss_chunk_size=TRAIN_LOSS_CHUNK,
                            attn_impl=impl)(batch1)
        loss.backward()
        grads = {key: torch.cat([p.grad.float().flatten() for n, p in named if n.startswith(key + ".")
                                 and p.grad is not None]) for key in vidlm.trainable_module_keys}
        return loss.item(), grads

    def held_micro_step():
        """micro_step("auto") with every backward-kernel call held three ways:
        against the plain backward on the call's own inputs, its lse against
        the plain forward's, and against the plain backward on the plain
        forward's o and lse."""
        calls, kernel = [], A.flash_attention_backward

        def held(q, k, v, o, lse, do, **kw):
            grads = kernel(q, k, v, o, lse, do, **kw)
            calls.append(dict(own=hold_backward(q, k, v, o, lse, do, grads, **kw),
                              **hold_from_plain_forward(q, k, v, lse, do, grads, **kw)))
            return grads

        with patched((A, "flash_attention_backward", held)):
            micro_step("auto")
        out = dict(calls=len(calls))
        for part in ("own", "lse", "backward"):
            out[part] = dict(ok=all(c[part]["ok"] for c in calls),
                             worst_share_of_limit=max(c[part]["worst_share_of_limit"] for c in calls))
        out["worst_mean_share"] = max(c[p]["worst_mean_share"] for c in calls for p in ("own", "backward"))
        out["ok"] = all(out[part]["ok"] for part in ("own", "lse", "backward"))
        return out

    def show(h):
        return (f"own inputs worst/limit {h['own']['worst_share_of_limit']:.3f}; lse worst/limit "
                f"{h['lse']['worst_share_of_limit']:.4f}; from the plain forward's o and lse worst/limit "
                f"{h['backward']['worst_share_of_limit']:.3f}; mean err/mean limit {h['worst_mean_share']:.4f}")

    ref_loss, ref_grads = micro_step("plain")
    loss, grads = micro_step("auto")
    rel_loss = abs(loss - ref_loss) / abs(ref_loss)
    rel_grads = {k: ((grads[k] - ref_grads[k]).norm() / ref_grads[k].norm()).item() for k in grads}
    held = held_micro_step()
    log(f"[train] kernels vs plain, one micro-batch of 1 at full depth: loss {loss:.6f} vs {ref_loss:.6f} "
        f"(relative {rel_loss:.3e}, tol {TRAIN_LOSS_REL_TOL}); gradient relative L2 {rel_grads} "
        f"(tol {TRAIN_GRAD_REL_TOL}); {held['calls']} backward-kernel calls held: {show(held)}")
    if not rel_loss <= TRAIN_LOSS_REL_TOL or not all(r <= TRAIN_GRAD_REL_TOL for r in rel_grads.values()):
        raise RuntimeError("the kernel path's loss or gradients differ from the plain path's beyond their limits")
    if held["calls"] != TRAIN_LAUNCHES_PER_MICRO_STEP["flash_attention_backward"] or not held["ok"]:
        raise RuntimeError(f"call-by-call backward check failed: {held}")

    faults = {}
    for fname, fault in planted_backward_faults().items():
        with patched(fault):
            f_held = held_micro_step()
        faults[fname] = dict(held=f_held, caught=not f_held["ok"])
        log(f"[fault] {fname:24s} call by call: {show(f_held)} -> "
            f"{'caught' if faults[fname]['caught'] else 'not caught'}")
        if not faults[fname]["caught"]:
            raise RuntimeError(f"planted backward fault {fname} was not caught")
    shutil.rmtree(run_dir, ignore_errors=True)
    return dict(model=cfg.model_id, stage="align", per_device_batch=per_device_batch, global_batch=global_batch,
                grad_accumulation_steps=strategy.grad_accumulation_steps, steps=max_steps, losses=losses,
                step_timings=step_timings, step_s=step_s, split=split, tokens_per_step=tokens,
                tokens_per_s=tokens / step_s, peak_memory_gib=peak_gib, launches=counts,
                launches_per_micro_step=per_micro, loss_rel_diff=rel_loss, grad_rel_diff=rel_grads,
                held_call_by_call=held, planted_faults=faults, profile=profile)


# ---------------------------------------------------------------------------


KERNELS = {
    "small_attention_kt": dict(source="merv_tpu_torch/csrc/small_attention_kt.cu",
                               replaces="merv_tpu/ops/attention.py:540", main_case="dinov2_frames"),
    "flash_attention_forward": dict(source="merv_tpu_torch/csrc/flash_fwd.cu",
                                    replaces="merv_tpu/ops/attention.py:376", main_case="llama_cache_prefill"),
    "flash_attention_backward": dict(source="merv_tpu_torch/csrc/flash_bwd.cu",
                                     replaces="merv_tpu/ops/attention.py:791", main_case="llama_training"),
}
SERVING_KERNELS = ("small_attention_kt", "flash_attention_forward")


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

    cases = kernel_cases(dev, args.seed) + backward_cases(dev, args.seed)
    main = main_path(dev, args.seed, args.max_new_tokens)
    train = train_path(dev, args.seed, os.path.join("runs", "chip_smoke_align"))

    kernels = []
    for name, meta in KERNELS.items():
        mine = [c for c in cases if c["kernel"] == name]
        head = next(c for c in mine if c["case"] == meta["main_case"])
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=train["launches"][name], launches_serving=main["launches"].get(name, 0),
            max_abs_err=max(c["max_abs_err"] for c in mine),
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], shape=head["shape"], cases=mine,
        ))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(device=kind, nvidia_smi=smi, build_s=build_s, kernels=kernels, main_path=main,
                       train_path=train), f, indent=1)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
