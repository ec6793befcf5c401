"""Operations and bytes from shapes: the model FLOPs of a cell's work and each kernel's roofline terms.

A multiply-add is 2 operations. Model FLOPs count the work the model needs
at each request's or example's true lengths: no padding, no idle decode
slots, no recomputation under remat, logits only where they are used (the
last prompt position and each decode step when serving; the labelled
positions when training). A kernel's bytes count each input read once and
each output written once.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence


def _llm_dims(cfg: dict) -> Dict[str, int]:
    E, nh, nkv = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = E // nh
    qd, kvd, I = nh * hd, nkv * hd, cfg["intermediate_size"]
    return dict(E=E, qd=qd, kvd=kvd, I=I, V=cfg["vocab_size"], L=cfg["num_hidden_layers"],
                lin=E * qd + 2 * E * kvd + qd * E + 3 * E * I)


def vit_flops(t: dict) -> float:
    """One video through a tower as MERV taps it (penultimate layer, or all layers for ViViT)."""
    D, I, p = t["hidden_size"], t["intermediate_size"], t["patch_size"]
    g = t["image_size"] // p
    prefix = t["num_cls_tokens"] + t["num_register_tokens"]
    if t["tubelet_t"]:
        seqs, S = 1, g * g * (t["frames"] // t["tubelet_t"]) + prefix
        patch_in = t["tubelet_t"] * p * p * 3
        layers = t["num_layers"]
    else:
        seqs, S = t["frames"], g * g + prefix
        patch_in = p * p * 3
        layers = t["num_layers"] - 1
    tokens = seqs * S
    f = 2.0 * seqs * g * g * (t["frames"] // t["tubelet_t"] if t["tubelet_t"] else 1) * patch_in * D
    per_layer = 2.0 * tokens * (4 * D * D + 2 * D * I) + 4.0 * seqs * S * S * D
    if t["temporal_attn"]:
        w = min(t["temporal_frames"], t["frames"])
        per_layer += 2.0 * tokens * 4 * D * D + 4.0 * (tokens // w) * w * w * D
    return f + layers * per_layer


def visual_flops(cfg: dict) -> float:
    """Towers, projectors and fusion for one video (forward)."""
    m = cfg["merv"]
    E, Vt = cfg["hidden_size"], m["visual_feature_length"]
    Q = m["fusion_embed_dim"]
    towers = sum(vit_flops(t) for t in m["towers"])
    proj = sum(2.0 * Vt * t["hidden_size"] * E for t in m["towers"])
    n = len(m["towers"])
    fusion = 2.0 * Q * Q + 2.0 * n * E * Q + 2.0 * n * Vt * E
    return towers + proj + fusion


def projector_flops(cfg: dict) -> float:
    m = cfg["merv"]
    return sum(2.0 * m["visual_feature_length"] * t["hidden_size"] * cfg["hidden_size"] for t in m["towers"])


def prefill_flops(cfg: dict, P: int) -> float:
    """The LLM over a P-token prompt, logits at its last position."""
    d = _llm_dims(cfg)
    return d["L"] * (2.0 * P * d["lin"] + 2.0 * P * P * d["qd"]) + 2.0 * d["E"] * d["V"]


def decode_flops(cfg: dict, P: int, n_new: int) -> float:
    """n_new - 1 decode steps after a P-token prefill (the first token comes from the prefill)."""
    d = _llm_dims(cfg)
    steps = max(n_new - 1, 0)
    ctx = steps * P + steps * (steps + 1) / 2  # keys at step j: P + j
    return steps * (d["L"] * 2.0 * d["lin"] + 2.0 * d["E"] * d["V"]) + d["L"] * 4.0 * d["qd"] * ctx


def answer_flops(cfg: dict, prompt_tokens: int, new_tokens: int) -> float:
    P = cfg["merv"]["visual_feature_length"] + prompt_tokens
    return visual_flops(cfg) + prefill_flops(cfg, P) + decode_flops(cfg, P, new_tokens)


def align_example_flops(cfg: dict, text_tokens: int, labels: int) -> float:
    """One align-stage example: towers forward; projectors forward and weight gradients; fusion forward
    and backward (its inputs, the projected streams, and its learned query take gradients too); the LLM
    forward and its activation backward down to the visual tokens; the head at the labels."""
    d = _llm_dims(cfg)
    P = cfg["merv"]["visual_feature_length"] + text_tokens
    towers = sum(vit_flops(t) for t in cfg["merv"]["towers"])
    proj = projector_flops(cfg)
    fusion = visual_flops(cfg) - towers - proj
    fwd = d["L"] * (2.0 * P * d["lin"] + 2.0 * P * P * d["qd"])
    bwd = d["L"] * (2.0 * P * d["lin"] + 4.0 * P * P * d["qd"])
    head = 2.0 * labels * d["E"] * d["V"]
    return towers + 2 * proj + 3 * fusion + fwd + bwd + 2 * head


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def k1(B: int, H: int, T: int, D: int) -> Dict[str, float]:
    """Tower frame attention (``small_attention_kt``), bf16 q, kt, v in and o out."""
    return {"flops": 4.0 * B * H * T * T * D, "bytes": 4.0 * B * H * T * D * 2}


def k5(B: int, H: int, Hk: int, rows: Sequence[int], D: int) -> Dict[str, float]:
    """One decode step's cached attention (``decode_attention``), bf16 cache: each valid row's K and V
    read once, q read and o written."""
    n = float(sum(rows))
    return {"flops": 4.0 * H * D * n, "bytes": 2.0 * Hk * D * n * 2 + 2.0 * B * H * D * 2}


def k3(B: int, H: int, Hk: int, T: int, D: int) -> Dict[str, float]:
    """The causal flash backward (dq, dk, dv from q, k, v, o, lse, do): five T x T products, half
    of each under the causal mask."""
    flops = 5.0 * B * H * T * T * D
    bytes_ = (4.0 * B * H * T * D + 4.0 * B * Hk * T * D) * 2 + B * H * T * 4
    return {"flops": flops, "bytes": bytes_}


def mean(xs: Sequence[float]) -> float:
    return sum(xs) / len(xs) if xs else math.nan
