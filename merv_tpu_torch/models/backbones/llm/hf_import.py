"""HF Llama checkpoint -> the port's ``LlamaDecoder`` ``state_dict``
(counterpart of ``merv_tpu/models/backbones/llm/hf_import.py``).

Works from an in-memory state dict or a directory of ``*.safetensors`` shards
(an index-sharded HF snapshot: every shard is read, in name order). Linear
weights keep torch's ``(out, in)`` layout, so the mapping is by name only; an
embedding or ``lm_head`` with fewer rows than the config's vocabulary (the pad
token ``merv_tpu`` adds) gets the mean row appended, as HF's
``resize_token_embeddings`` does.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping

import torch

from merv_tpu_torch.bridge import as_tensor
from merv_tpu_torch.models.backbones.llm.transformer import DecoderConfig

_LAYER_WEIGHTS = {  # ours -> HF, under layers.<i>. / model.layers.<i>.
    "attn.q_proj": "self_attn.q_proj", "attn.k_proj": "self_attn.k_proj", "attn.v_proj": "self_attn.v_proj",
    "attn.o_proj": "self_attn.o_proj", "mlp.gate_proj": "mlp.gate_proj", "mlp.up_proj": "mlp.up_proj",
    "mlp.down_proj": "mlp.down_proj", "input_norm": "input_layernorm", "post_attn_norm": "post_attention_layernorm",
}


def load_safetensors_dir(path: Path) -> Dict[str, torch.Tensor]:
    """Every ``*.safetensors`` shard in a directory, merged into one dict."""
    from merv_tpu_torch.util.safetensors_io import load_file

    files = sorted(Path(path).glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors shards under {path}")
    state: Dict[str, torch.Tensor] = {}
    for f in files:
        state.update(load_file(f))
    return state


def _pad_vocab(w: torch.Tensor, rows: int) -> torch.Tensor:
    if w.shape[0] >= rows:
        return w
    # numpy's fp32 mean, as merv_tpu computes it, so both round it alike
    mean = torch.from_numpy(w.float().numpy().mean(axis=0, keepdims=True))
    return torch.cat([w.float(), mean.expand(rows - w.shape[0], -1)], dim=0)


def import_llama_state_dict(
    cfg: DecoderConfig, state: Mapping[str, Any], *, param_dtype: torch.dtype = torch.float32
) -> Dict[str, torch.Tensor]:
    """An HF ``LlamaForCausalLM`` state dict -> the ``state_dict`` of ``LlamaDecoder(cfg)``,
    each value rounded to ``param_dtype``."""

    def get(key: str) -> torch.Tensor:
        return as_tensor(state[key])

    out: Dict[str, torch.Tensor] = {
        "embed_tokens.weight": _pad_vocab(get("model.embed_tokens.weight"), cfg.vocab_size),
        "final_norm.weight": get("model.norm.weight"),
    }
    for i in range(cfg.num_layers):
        for ours, theirs in _LAYER_WEIGHTS.items():
            out[f"layers.{i}.{ours}.weight"] = get(f"model.layers.{i}.{theirs}.weight")
        if cfg.attention_bias:
            for p in ("q_proj", "k_proj", "v_proj"):
                out[f"layers.{i}.attn.{p}.bias"] = get(f"model.layers.{i}.self_attn.{p}.bias")
    if not cfg.tie_word_embeddings:
        # a checkpoint with tied embeddings under an untied config reuses the embedding
        head = get("lm_head.weight") if "lm_head.weight" in state else get("model.embed_tokens.weight")
        out["lm_head.weight"] = _pad_vocab(head, cfg.vocab_size)
    return {k: v.to(param_dtype) for k, v in out.items()}
