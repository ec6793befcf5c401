"""Plain float32 MERV (merv-full's layout) in PyTorch, written from the published descriptions.

Nothing here imports the program: each function takes a configuration file's
dict (``benchmark/configs/*.json``) and a dict of weights by name, and
computes with plain ``torch`` operations in float32. It is what decides
``correct``: served tokens are held against its logits, training steps
against its loss, gradient and update.

- Towers (``vit``): a pre-LN ViT with a conv-free patch embedding (a reshape
  and one matmul, as a stride-equals-kernel convolution is), cls / register
  tokens, learned position embeddings, LayerScale (DINOv2), CLIP's ``ln_pre``
  and QuickGELU (LanguageBind), LanguageBind's per-layer temporal attention
  over windows of ``temporal_frames`` frames (a temporal embedding added
  first), ViViT's 2x16x16 tubelets. Feature taps as MERV takes them: the
  penultimate layer's patch tokens (LanguageBind, DINOv2, SigLIP), the final
  layer's normed patch tokens (ViViT, all 16 temporal slices).
- Projectors (``3davg+linear``): an adaptive 3-D average pool to
  (frames, 8, 8) and a Linear to the LLM width.
- Fusion (``cross_attention_avg_lq``): one learned query against each
  encoder's token mean gives a softmax weight per encoder; the visual stream
  is the weighted sum of the projected streams.
- Qwen-2.5 decoder: RMSNorm, rotary embedding (half split, theta from the
  config), grouped-query attention with q/k/v biases, SiLU-gated MLP, the
  final norm and the head (tied for the 3B).

Departures from the published models, each also the program's: position
embeddings are used at 224 px as stored (DINOv2 is published at 518 px and
interpolates); the visual tokens sit before the text because Qwen-2.5 has no
BOS; frame preprocessing resizes with ``torch.nn.functional.interpolate``
(antialiased) rather than PIL.

``Precision`` selects how a Linear multiplies: ``fp32`` (the reference) or
``fp8`` (inputs and weights rounded to float8 e4m3 with a per-row scale, the
training cell's control; the backward passes the rounding straight through,
so gradients flow in float32 from the rounded forward).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

IGNORE_INDEX = -100
Weights = Dict[str, torch.Tensor]

LLM = "llm_backbone.decoder."


# ---------------------------------------------------------------------------
# names and shapes of the weights
# ---------------------------------------------------------------------------


def _tower_patches(t: dict) -> int:
    g = t["image_size"] // t["patch_size"]
    return g * g * (t["frames"] // t["tubelet_t"] if t["tubelet_t"] else 1)


def spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every weight of the model, (name, shape), in the order they are drawn."""
    m = cfg["merv"]
    out: List[Tuple[str, Tuple[int, ...]]] = []
    for i, t in enumerate(m["towers"]):
        p = f"video_backbones.{i}.vit."
        D, I = t["hidden_size"], t["intermediate_size"]
        ncls, nreg = t["num_cls_tokens"], t["num_register_tokens"]
        out.append((p + "pos_embed", (_tower_patches(t) + (ncls if t["pos_embed_includes_prefix"] else 0), D)))
        if ncls:
            out.append((p + "cls_token", (ncls, D)))
        if nreg:
            out.append((p + "register_tokens", (nreg, D)))
        patch_in = (t["tubelet_t"] or 1) * t["patch_size"] ** 2 * 3
        out.append((p + "patch_embed.weight", (D, patch_in)))
        if t["patch_bias"]:
            out.append((p + "patch_embed.bias", (D,)))
        if t["pre_norm"]:
            out += [(p + "pre_norm.weight", (D,)), (p + "pre_norm.bias", (D,))]
        for li in range(t["num_layers"]):
            lp = f"{p}layers.{li}."
            attn = ["attn"] + (["t_attn"] if t["temporal_attn"] else [])
            if t["temporal_attn"]:
                out += [(lp + "temporal_embedding", (t["temporal_frames"], D)),
                        (lp + "t_norm.weight", (D,)), (lp + "t_norm.bias", (D,))]
            for a in attn:
                for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
                    out += [(f"{lp}{a}.{proj}.weight", (D, D)), (f"{lp}{a}.{proj}.bias", (D,))]
            out += [(lp + "norm1.weight", (D,)), (lp + "norm1.bias", (D,)),
                    (lp + "norm2.weight", (D,)), (lp + "norm2.bias", (D,)),
                    (lp + "mlp.fc1.weight", (I, D)), (lp + "mlp.fc1.bias", (I,)),
                    (lp + "mlp.fc2.weight", (D, I)), (lp + "mlp.fc2.bias", (D,))]
            if t["use_layerscale"]:
                out += [(lp + "ls1.gamma", (D,)), (lp + "ls2.gamma", (D,))]
        out += [(p + "final_norm.weight", (D,)), (p + "final_norm.bias", (D,))]
    E, I, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    hd = E // cfg["num_attention_heads"]
    qd, kvd = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    out.append((LLM + "embed_tokens.weight", (V, E)))
    for li in range(cfg["num_hidden_layers"]):
        lp = f"{LLM}layers.{li}."
        out += [(lp + "attn.q_proj.weight", (qd, E)), (lp + "attn.q_proj.bias", (qd,)),
                (lp + "attn.k_proj.weight", (kvd, E)), (lp + "attn.k_proj.bias", (kvd,)),
                (lp + "attn.v_proj.weight", (kvd, E)), (lp + "attn.v_proj.bias", (kvd,)),
                (lp + "attn.o_proj.weight", (E, qd)),
                (lp + "mlp.gate_proj.weight", (I, E)), (lp + "mlp.up_proj.weight", (I, E)),
                (lp + "mlp.down_proj.weight", (E, I)),
                (lp + "input_norm.weight", (E,)), (lp + "post_attn_norm.weight", (E,))]
    out.append((LLM + "final_norm.weight", (E,)))
    if not cfg["tie_word_embeddings"]:
        out.append((LLM + "lm_head.weight", (V, E)))
    for i, t in enumerate(m["towers"]):
        out += [(f"projectors.{i}.projector.projector.weight", (E, t["hidden_size"])),
                (f"projectors.{i}.projector.projector.bias", (E,))]
    Q = m["fusion_embed_dim"]
    out += [("feature_fusion.Q", (1, Q)),
            ("feature_fusion.attention.q_proj.weight", (Q, Q)), ("feature_fusion.attention.q_proj.bias", (Q,)),
            ("feature_fusion.attention.k_proj.weight", (Q, E)), ("feature_fusion.attention.k_proj.bias", (Q,)),
            ("feature_fusion.attention.v_proj.weight", (Q, E)), ("feature_fusion.attention.v_proj.bias", (Q,)),
            ("feature_fusion.attention.out_proj.weight", (Q, Q)), ("feature_fusion.attention.out_proj.bias", (Q,))]
    return out


def trainable(name: str) -> bool:
    """The align stage's trainable weights: projectors and fusion."""
    return name.startswith(("projectors.", "feature_fusion."))


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------


class Precision:
    """How a Linear multiplies: ``fp32``, or ``fp8`` (e4m3, per-row absmax scale)."""

    def __init__(self, kind: str = "fp32") -> None:
        if kind not in ("fp32", "fp8"):
            raise ValueError(kind)
        self.kind = kind

    def _round(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            scale = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / 448.0
            delta = (x / scale).to(torch.float8_e4m3fn).float() * scale - x
        return x + delta

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor = None) -> torch.Tensor:
        if self.kind == "fp8":
            x, w = self._round(x), self._round(w)
        y = x @ w.t()
        return y if b is None else y + b


FP32 = Precision("fp32")


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return F.gelu(x)
    if name == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    raise ValueError(name)


def _ln(W: Weights, p: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), W[p + ".weight"], W[p + ".bias"], eps)


def _mha(W: Weights, p: str, x: torch.Tensor, heads: int, P: Precision) -> torch.Tensor:
    """Bidirectional multi-head self-attention over x [B, S, D]."""
    B, S, D = x.shape
    dh = D // heads
    q, k, v = (P.linear(x, W[f"{p}.{n}_proj.weight"], W[f"{p}.{n}_proj.bias"]).view(B, S, heads, dh).transpose(1, 2)
               for n in ("q", "k", "v"))
    att = torch.softmax((q @ k.transpose(-1, -2)) * dh ** -0.5, dim=-1)
    out = (att @ v).transpose(1, 2).reshape(B, S, D)
    return P.linear(out, W[f"{p}.o_proj.weight"], W[f"{p}.o_proj.bias"])


def _patchify(t: dict, pixels: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] (or [B, C, T, H, W] with tubelets) -> [N, patches, patch_in], (t, py, px, c) inner order."""
    p = t["patch_size"]
    if t["tubelet_t"]:
        B, C, T, H, W_ = pixels.shape
        tt, g = t["tubelet_t"], H // p
        x = pixels.reshape(B, C, T // tt, tt, g, p, g, p)
        return x.permute(0, 2, 4, 6, 3, 5, 7, 1).reshape(B, (T // tt) * g * g, tt * p * p * C)
    N, C, H, W_ = pixels.shape
    g = H // p
    x = pixels.reshape(N, C, g, p, g, p)
    return x.permute(0, 2, 4, 3, 5, 1).reshape(N, g * g, p * p * C)


def vit(W: Weights, p: str, t: dict, pixels: torch.Tensor, *, layers: int, final_norm: bool, window: int = 1,
        P: Precision = FP32) -> torch.Tensor:
    """The first ``layers`` blocks of a tower's ViT over pixels -> [N, prefix + patches, D]."""
    eps, H = t["layer_norm_eps"], t["num_heads"]
    x = P.linear(_patchify(t, pixels), W[p + "patch_embed.weight"], W.get(p + "patch_embed.bias"))
    N, _, D = x.shape
    pos = W[p + "pos_embed"]
    prefix = []
    ncls = t["num_cls_tokens"]
    if ncls:
        cls = W[p + "cls_token"].expand(N, ncls, D)
        if t["pos_embed_includes_prefix"]:
            cls, x = cls + pos[:ncls], x + pos[ncls:]
        else:
            x = x + pos
        prefix.append(cls)
    else:
        x = x + pos
    if t["num_register_tokens"]:
        prefix.append(W[p + "register_tokens"].expand(N, t["num_register_tokens"], D))
    x = torch.cat(prefix + [x], dim=1)
    if t["pre_norm"]:
        x = _ln(W, p + "pre_norm", x, eps)
    for li in range(layers):
        lp = f"{p}layers.{li}."
        if t["temporal_attn"] and window > 1:
            # attention across the frames of each window, token by token
            S = x.shape[1]
            B = N // window
            xt = x.view(B, window, S, D) + W[lp + "temporal_embedding"][:window][None, :, None, :]
            xt = xt.transpose(1, 2).reshape(B * S, window, D)
            xt = xt + _mha(W, lp + "t_attn", _ln(W, lp + "t_norm", xt, eps), H, P)
            x = xt.view(B, S, window, D).transpose(1, 2).reshape(N, S, D)
        h = _mha(W, lp + "attn", _ln(W, lp + "norm1", x, eps), H, P)
        x = x + (h * W[lp + "ls1.gamma"] if t["use_layerscale"] else h)
        y = _ln(W, lp + "norm2", x, eps)
        h = P.linear(_act(t["act"], P.linear(y, W[lp + "mlp.fc1.weight"], W[lp + "mlp.fc1.bias"])),
                     W[lp + "mlp.fc2.weight"], W[lp + "mlp.fc2.bias"])
        x = x + (h * W[lp + "ls2.gamma"] if t["use_layerscale"] else h)
    if final_norm:
        x = _ln(W, p + "final_norm", x, eps)
    return x


# ---------------------------------------------------------------------------
# frames -> towers -> projectors -> fusion
# ---------------------------------------------------------------------------


def tower_pixels(t: dict, video: torch.Tensor) -> torch.Tensor:
    """uint8 [T, H, W, 3] -> the tower's normalised input: every (T // frames)-th frame, resized
    (``resize-naive`` to S x S, or ``resize-crop``: shorter edge to ``shortest_edge``, centre crop),
    scaled and normalised -> [frames, 3, S, S] float32."""
    n = t["frames"]
    T = video.shape[0]
    if T != n:
        video = video[:: max(1, T // n)][:n]
    x = video.float().div(255.0).permute(0, 3, 1, 2)
    tf = t["transform"]
    S = t["image_size"]
    mode = tf["interpolation"]
    H, W_ = x.shape[-2:]
    if tf["resize"] == "resize-naive":
        if (H, W_) != (S, S):
            x = F.interpolate(x, size=(S, S), mode=mode, align_corners=False, antialias=True)
    elif tf["resize"] == "resize-crop":
        se = tf["shortest_edge"]
        nh, nw = (se, max(1, int(round(W_ * se / H)))) if H < W_ else (max(1, int(round(H * se / W_))), se)
        if (H, W_) != (nh, nw):
            x = F.interpolate(x, size=(nh, nw), mode=mode, align_corners=False, antialias=True)
        top, left = (nh - S) // 2, (nw - S) // 2
        x = x[:, :, top:top + S, left:left + S]
    else:
        raise ValueError(tf["resize"])
    mean = torch.tensor(tf["mean"], dtype=torch.float32, device=x.device)[:, None, None]
    std = torch.tensor(tf["std"], dtype=torch.float32, device=x.device)[:, None, None]
    return (x - mean) / std


def tower_features(W: Weights, i: int, t: dict, pixels: torch.Tensor, P: Precision = FP32) -> torch.Tensor:
    """One tower over a batch of its inputs [B, frames, 3, S, S] -> [B, frames', patches, D]: the token
    grid the projector pools, MERV's feature tap."""
    p = f"video_backbones.{i}.vit."
    B, n = pixels.shape[:2]
    L = t["num_layers"]
    fam = t["family"]
    if fam == "vivit":
        x = vit(W, p, t, pixels.transpose(1, 2), layers=L, final_norm=True, P=P)
        g = t["image_size"] // t["patch_size"]
        return x[:, 1:].reshape(B, n // t["tubelet_t"], g * g, -1)
    frames = pixels.reshape(B * n, *pixels.shape[2:])
    window = min(t["temporal_frames"], n) if t["temporal_attn"] else 1
    x = vit(W, p, t, frames, layers=L - 1, final_norm=False, window=window, P=P)
    if fam not in ("languagebind", "dinov2", "siglip"):
        raise ValueError(fam)
    x = x[:, t["num_cls_tokens"] + t["num_register_tokens"]:]
    return x.reshape(B, n, x.shape[1], x.shape[2])


def project(W: Weights, i: int, cfg: dict, grid: torch.Tensor, P: Precision = FP32) -> torch.Tensor:
    """``3davg+linear``: [B, F, N, C] -> adaptive average pool to (F, s, s) -> Linear -> [B, F s s, E]."""
    s = math.isqrt(cfg["merv"]["projector_token_length"])
    B, Fr, N, C = grid.shape
    g = math.isqrt(N)
    x = grid.reshape(B, Fr, g, g, C).permute(0, 4, 1, 2, 3)
    x = F.adaptive_avg_pool3d(x, (Fr, s, s)).permute(0, 2, 3, 4, 1).reshape(B, Fr * s * s, C)
    return P.linear(x, W[f"projectors.{i}.projector.projector.weight"], W[f"projectors.{i}.projector.projector.bias"])


def fuse(W: Weights, streams: Sequence[torch.Tensor], P: Precision = FP32) -> torch.Tensor:
    """``cross_attention_avg_lq``: softmax over encoders of q . k_e / sqrt(d), with q the projected learned
    query and k_e the projected mean token of encoder e; the streams' weighted sum."""
    f = "feature_fusion."
    stacked = torch.stack(list(streams), dim=1)  # [B, E, T, C]
    q = P.linear(W[f + "Q"], W[f + "attention.q_proj.weight"], W[f + "attention.q_proj.bias"])  # [1, d]
    k = P.linear(stacked.mean(dim=2), W[f + "attention.k_proj.weight"], W[f + "attention.k_proj.bias"])  # [B, E, d]
    w = torch.softmax((k @ q[0]) / math.sqrt(q.shape[-1]), dim=-1)  # [B, E]
    return torch.einsum("be,betc->btc", w, stacked)


def visual_tokens(W: Weights, cfg: dict, pixels: Sequence[torch.Tensor], P: Precision = FP32,
                  grids: Sequence[torch.Tensor] = None) -> torch.Tensor:
    """Per-tower inputs [B, frames, 3, S, S] -> the fused visual tokens [B, V, E]. ``grids``: the towers'
    features when already computed (they take no gradient in any stage)."""
    towers = cfg["merv"]["towers"]
    if grids is None:
        with torch.no_grad():
            grids = [tower_features(W, i, t, x, P) for i, (t, x) in enumerate(zip(towers, pixels))]
    return fuse(W, [project(W, i, cfg, g, P) for i, g in enumerate(grids)], P)


# ---------------------------------------------------------------------------
# the Qwen-2.5 decoder
# ---------------------------------------------------------------------------


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., h:], x[..., :h]], dim=-1) * sin


def decoder_hidden(W: Weights, cfg: dict, embeds: torch.Tensor, P: Precision = FP32) -> torch.Tensor:
    """Causal forward over embeds [B, T, E] at positions 0..T-1 -> the final-normed hidden states."""
    B, T, E = embeds.shape
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = E // nh
    eps = cfg["rms_norm_eps"]
    pos = torch.arange(T, dtype=torch.float32, device=embeds.device)
    inv = 1.0 / (cfg["rope_theta"] ** (torch.arange(0, hd, 2, dtype=torch.float32, device=embeds.device) / hd))
    ang = pos[:, None] * inv[None]
    cos, sin = torch.cat([ang, ang], -1).cos(), torch.cat([ang, ang], -1).sin()
    causal = torch.ones(T, T, dtype=torch.bool, device=embeds.device).tril()
    h = embeds
    for li in range(cfg["num_hidden_layers"]):
        lp = f"{LLM}layers.{li}."
        x = _rms(h, W[lp + "input_norm.weight"], eps)
        q = P.linear(x, W[lp + "attn.q_proj.weight"], W[lp + "attn.q_proj.bias"]).view(B, T, nh, hd).transpose(1, 2)
        k = P.linear(x, W[lp + "attn.k_proj.weight"], W[lp + "attn.k_proj.bias"]).view(B, T, nkv, hd).transpose(1, 2)
        v = P.linear(x, W[lp + "attn.v_proj.weight"], W[lp + "attn.v_proj.bias"]).view(B, T, nkv, hd).transpose(1, 2)
        q, k = _rope(q, cos, sin), _rope(k, cos, sin)
        k, v = k.repeat_interleave(nh // nkv, dim=1), v.repeat_interleave(nh // nkv, dim=1)
        s = (q @ k.transpose(-1, -2)) * hd ** -0.5
        att = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        out = (att @ v).transpose(1, 2).reshape(B, T, nh * hd)
        h = h + P.linear(out, W[lp + "attn.o_proj.weight"])
        x = _rms(h, W[lp + "post_attn_norm.weight"], eps)
        gate = P.linear(x, W[lp + "mlp.gate_proj.weight"])
        up = P.linear(x, W[lp + "mlp.up_proj.weight"])
        h = h + P.linear(F.silu(gate) * up, W[lp + "mlp.down_proj.weight"])
    return _rms(h, W[LLM + "final_norm.weight"], eps)


def head_weight(W: Weights, cfg: dict) -> torch.Tensor:
    return W[LLM + ("embed_tokens.weight" if cfg["tie_word_embeddings"] else "lm_head.weight")]


def embed(W: Weights, ids: torch.Tensor) -> torch.Tensor:
    return W[LLM + "embed_tokens.weight"][ids]


# ---------------------------------------------------------------------------
# what the benchmark compares
# ---------------------------------------------------------------------------


@torch.no_grad()
def served_logits(W: Weights, cfg: dict, pixels: Sequence[torch.Tensor], prompt_ids: torch.Tensor,
                  served_ids: torch.Tensor, P: Precision = FP32) -> torch.Tensor:
    """One request: towers' inputs (batch 1), its prompt ids and its served tokens -> the logits
    [n_served, V] that predict each served token (visual tokens, then the prompt, then the served
    tokens but the last)."""
    vis = visual_tokens(W, cfg, pixels, P)
    seq = torch.cat([prompt_ids, served_ids[:-1]])
    h = decoder_hidden(W, cfg, torch.cat([vis, embed(W, seq)[None]], dim=1), P)
    start = vis.shape[1] + prompt_ids.shape[0] - 1
    return P.linear(h[0, start:], head_weight(W, cfg))


def served_gaps(logits: torch.Tensor, served_ids: torch.Tensor) -> torch.Tensor:
    """How far each served token's logit lies below the best logit at its position."""
    return logits.max(dim=-1).values - logits.gather(-1, served_ids[:, None].long())[:, 0]


def example_nll(W: Weights, cfg: dict, vis: torch.Tensor, text_ids: torch.Tensor, labels: torch.Tensor,
                P: Precision = FP32) -> Tuple[torch.Tensor, int]:
    """One training example: its visual tokens [1, V, E], its text ids and labels (unpadded) ->
    (the summed next-token NLL over its labelled positions, their count)."""
    h = decoder_hidden(W, cfg, torch.cat([vis, embed(W, text_ids)[None]], dim=1), P)[0]
    full = torch.cat([torch.full((vis.shape[1],), IGNORE_INDEX, dtype=labels.dtype, device=labels.device), labels])
    target = full[1:]
    keep = target != IGNORE_INDEX
    logits = P.linear(h[:-1][keep], head_weight(W, cfg))
    nll = torch.nn.functional.cross_entropy(logits, target[keep].long(), reduction="sum")
    return nll, int(keep.sum())


class AdamW:
    """The align recipe's optimizer: the global-norm clip (no epsilon), then AdamW (0.9, 0.999, 1e-8,
    decoupled weight decay on matrices), the learning rate of linear warmup from 0 then cosine decay,
    evaluated at the update count."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, total_steps: int, warmup_ratio: float,
                 weight_decay: float, max_grad_norm: float) -> None:
        self.params, self.lr, self.total = params, lr, total_steps
        self.warmup = max(int(total_steps * warmup_ratio), 1)
        self.wd, self.max_norm = weight_decay, max_grad_norm
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    def rate(self, step: int) -> float:
        if step < self.warmup:
            return self.lr * step / self.warmup
        decay = max(self.total, self.warmup + 1) - self.warmup
        return self.lr * 0.5 * (1.0 + math.cos(math.pi * min(step - self.warmup, decay) / decay))

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Apply one update; returns the clipped gradients."""
        norm = torch.sqrt(sum(g.double().pow(2).sum() for g in grads.values())).float()
        if norm >= self.max_norm:
            grads = {n: g / norm * self.max_norm for n, g in grads.items()}
        lr = self.rate(self.count)
        self.count += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for n, p in self.params.items():
            g = grads[n]
            if self.wd and p.dim() > 1 and not n.endswith(".bias"):
                p.mul_(1 - lr * self.wd)
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(lr / c1 * self.m[n] / ((self.v[n] / c2).sqrt() + eps))
        return grads
