"""LLM backbone: spec table + decoder + tokenizer + prompting
(counterpart of ``merv_tpu/models/backbones/llm/base_llm.py``), main-path
subset: ``llama2-7b-pure`` plus the tiny test backbone.

The backbone owns its :class:`LlamaDecoder` as ``self.decoder``, built on
``device`` at construction. ``inference_mode=True`` stores the parameters in
the family's half precision, the serving contract ``merv_tpu`` follows too.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Type

import torch
from torch import nn

from merv_tpu_torch.device import resolve_device
from merv_tpu_torch.models.backbones.llm.hf_import import import_llama_state_dict
from merv_tpu_torch.models.backbones.llm.prompting import PromptBuilder, PurePromptBuilder
from merv_tpu_torch.models.backbones.llm.tokenization import load_tokenizer
from merv_tpu_torch.models.backbones.llm.transformer import (
    LLAMA2_7B,
    DecoderConfig,
    LlamaDecoder,
    tiny_decoder_config,
)


@dataclass(frozen=True)
class LLMSpec:
    llm_family: str
    hf_hub_path: str
    decoder_config: DecoderConfig
    prompt_builder_cls: Type[PromptBuilder]
    half_precision_dtype: torch.dtype = torch.bfloat16
    has_bos: bool = True
    pad_token_id: int = 0
    eos_token_id: int = 2
    stop_token_id: Optional[int] = None


LLM_SPECS: Dict[str, LLMSpec] = {
    "llama2-7b-pure": LLMSpec("llama2", "meta-llama/Llama-2-7b-hf", LLAMA2_7B, PurePromptBuilder, pad_token_id=32000),
}


class LLMBackbone(nn.Module):
    def __init__(
        self,
        llm_backbone_id: str,
        llm_max_length: int = 2048,
        inference_mode: bool = False,
        spec: Optional[LLMSpec] = None,
        device: Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        if spec is None and llm_backbone_id not in LLM_SPECS:
            raise ValueError(f"LLM backbone {llm_backbone_id!r} is not ported yet (ROADMAP A10)")
        self.identifier = llm_backbone_id
        self.llm_max_length = llm_max_length
        self.inference_mode = inference_mode
        self.spec = spec if spec is not None else LLM_SPECS[llm_backbone_id]
        self._tokenizer: Any = None
        self.decoder = LlamaDecoder(self.decoder_config, device=resolve_device(device))

    @property
    def decoder_config(self) -> DecoderConfig:
        cfg = self.spec.decoder_config
        if self.inference_mode:
            cfg = dataclasses.replace(cfg, param_dtype=self.spec.half_precision_dtype)
        return cfg

    @property
    def embed_dim(self) -> int:
        return self.decoder_config.hidden_size

    @property
    def half_precision_dtype(self) -> torch.dtype:
        return self.spec.half_precision_dtype

    def import_state_dict(self, state: Mapping[str, Any], param_dtype: torch.dtype = torch.bfloat16) -> None:
        """Load an HF Llama state dict into ``self.decoder``, each value rounded
        to ``param_dtype`` first (see ``hf_import.py``). The counterpart of
        ``merv_tpu``'s ``load_state_dict``, which returns a tree; here
        ``load_state_dict`` stays torch's own."""
        self.decoder.load_state_dict(import_llama_state_dict(self.decoder_config, state, param_dtype=param_dtype))

    def embed_input_ids(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.decoder.embed_input_ids(input_ids)

    @property
    def tokenizer(self) -> Any:
        if self._tokenizer is None:
            tok = load_tokenizer(
                self.spec.hf_hub_path, model_max_length=self.llm_max_length, add_bos_token=self.spec.has_bos
            )
            if self.spec.llm_family == "llama2":
                tok.add_special_tokens({"pad_token": "<PAD>"})
            self._tokenizer = tok
        return self._tokenizer

    @property
    def prompt_builder_fn(self) -> Type[PromptBuilder]:
        return self.spec.prompt_builder_cls

    @property
    def bos_token_length(self) -> int:
        return 1 if self.spec.has_bos else 0

    @property
    def pad_token_id(self) -> int:
        return self.spec.pad_token_id

    @property
    def stop_token_id(self) -> int:
        return self.spec.stop_token_id if self.spec.stop_token_id is not None else self.spec.eos_token_id


def tiny_llm_backbone(
    llm_backbone_id: str = "tiny-pure",
    has_bos: bool = True,
    inference_mode: bool = False,
    device: Optional[torch.device] = None,
    **config_overrides: Any,
) -> LLMBackbone:
    """Small random LLM backbone with the ByteTokenizer (tests)."""
    cfg = tiny_decoder_config(**config_overrides)
    spec = LLMSpec(
        llm_family="tiny", hf_hub_path="__offline__/tiny", decoder_config=cfg,
        prompt_builder_cls=PurePromptBuilder, has_bos=has_bos, pad_token_id=0, eos_token_id=2,
    )
    return LLMBackbone(
        llm_backbone_id, llm_max_length=cfg.max_position_embeddings, spec=spec,
        inference_mode=inference_mode, device=device,
    )
