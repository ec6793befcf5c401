"""Multi-encoder fusion (counterpart of ``merv_tpu/nn/fusion.py``).

:class:`CrossAttentionAdapterLearnableQuery` is the default
``cross_attention_avg_lq`` fusion: one learned query attends over per-encoder
summaries to give per-encoder mixing weights, and the fused stream is the
weight-blended stack of the full token streams. The ``v_proj`` / ``out_proj``
parameters are kept only for the checkpoint layout (the forward never reads
them), as in ``merv_tpu``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from merv_tpu_torch.nn.core import Linear, uniform_


class _MHAProjections(nn.Module):
    """torch ``nn.MultiheadAttention``'s separate q/k/v projections + out_proj."""

    def __init__(self, d: int, kdim: int, param_dtype: torch.dtype, device: Optional[torch.device]) -> None:
        super().__init__()
        self.q_proj = Linear(d, d, param_dtype=param_dtype, device=device)
        self.k_proj = Linear(kdim, d, param_dtype=param_dtype, device=device)
        self.v_proj = Linear(kdim, d, param_dtype=param_dtype, device=device)
        self.out_proj = Linear(d, d, param_dtype=param_dtype, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        # torch MHA: xavier-uniform in-projections with zero bias (runs after
        # the Linear defaults, which init_weights applies first)
        with torch.no_grad():
            for lin in (self.q_proj, self.k_proj, self.v_proj):
                out_f, in_f = lin.weight.shape
                uniform_(lin.weight, math.sqrt(6.0 / (in_f + out_f)), generator)
                lin.bias.zero_()


class CrossAttentionAdapterLearnableQuery(nn.Module):
    """``forward(V)`` with V a list of E tensors ``[B, T, llm_dim]`` (T == token_length,
    or 1, which broadcasts) -> ``([B, token_length, llm_dim], weights [B, E])``."""

    def __init__(
        self,
        embed_dim: int = 3072,
        llm_dim: int = 4096,
        token_length: int = 8,
        averagetoken: bool = False,
        num_encoder: int = 4,
        positional_embedding: bool = False,
        param_dtype: torch.dtype = torch.float32,
        device: Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        if positional_embedding:
            raise NotImplementedError("cross_attention fusion with 'pe' is not ported yet (ROADMAP A10)")
        self.embed_dim, self.llm_dim, self.token_length = embed_dim, llm_dim, token_length
        self.averagetoken = averagetoken
        kdim = llm_dim if averagetoken else token_length * llm_dim
        self.Q = nn.Parameter(torch.empty(1, embed_dim, dtype=param_dtype, device=device), requires_grad=False)
        self.attention = _MHAProjections(embed_dim, kdim, param_dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        uniform_(self.Q, math.sqrt(6.0 / (1 + self.embed_dim)), generator)

    def forward(self, V: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        T, C = self.token_length, self.llm_dim
        for emb in V:
            if emb.shape[1] not in (T, 1):
                raise ValueError(f"fusion expects {T} (or 1) tokens per encoder, got {[tuple(e.shape) for e in V]}")
        B, E, dtype = V[0].shape[0], len(V), V[0].dtype
        stacked = torch.stack([emb.expand(B, T, C) for emb in V], dim=1)  # [B, E, T, C]

        q = self.attention.q_proj(self.Q.to(dtype)[None].expand(B, 1, self.embed_dim))
        keys = stacked.mean(dim=2) if self.averagetoken else stacked.reshape(B, E, T * C)
        k = self.attention.k_proj(keys)
        logits = torch.einsum("bqd,bed->bqe", q, k).float() / math.sqrt(self.embed_dim)
        weights = torch.softmax(logits, dim=-1).to(dtype)  # [B, 1, E]
        fused = torch.einsum("bqe,bec->bqc", weights, stacked.reshape(B, E, T * C)).reshape(B, T, C)
        return fused, weights[:, 0]
