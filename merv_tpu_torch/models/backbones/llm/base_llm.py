"""LLM backbone: spec table + decoder + tokenizer + prompting
(counterpart of ``merv_tpu/models/backbones/llm/base_llm.py``): every
``llm_backbone_id`` ``merv_tpu`` registers, plus the tiny test backbone.

The backbone owns its :class:`LlamaDecoder` as ``self.decoder``, built on
``device`` at construction. ``inference_mode=True`` stores the parameters in
the family's half precision, the serving contract ``merv_tpu`` follows too
(fp16 for Qwen-2.5: a storage dtype only, the decoder computes in bf16).

Family quirks, as ``merv_tpu`` keeps them: Llama-2 / Vicuna / Llama-3 add a
``<PAD>`` token (the embedding resized to a multiple of 64); Llama-3.1 and
Qwen-2.5 pad with ``<|finetune_right_pad_id|>`` (id 128004) without a resize;
Qwen-2.5 has no BOS (``bos_token_length == 0``: the visual tokens go first);
Llama-3-chat stops at ``<|eot_id|>`` (128009) while its eos is 128001.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Type

import torch
from torch import nn

from merv_tpu_torch.device import resolve_device
from merv_tpu_torch.models.backbones.llm.hf_import import import_llama_state_dict
from merv_tpu_torch.models.backbones.llm.prompting import (
    LLaMa2ChatPromptBuilder,
    LLaMa31PromptBuilder,
    PromptBuilder,
    PurePromptBuilder,
    Qwen2PromptBuilder,
    VicunaV15ChatPromptBuilder,
)
from merv_tpu_torch.models.backbones.llm.tokenization import load_tokenizer
from merv_tpu_torch.models.backbones.llm.transformer import (
    LLAMA2_7B,
    LLAMA2_13B,
    LLAMA3_8B,
    LLAMA31_8B,
    QWEN25_3B,
    QWEN25_7B,
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
    stop_token_id: Optional[int] = None  # the generation stop id where it is not eos (llama3-chat: <|eot_id|>)


# fmt: off
LLM_SPECS: Dict[str, LLMSpec] = {
    # === LLaMa-2 Pure (Non-Chat) ===
    "llama2-7b-pure":   LLMSpec("llama2", "meta-llama/Llama-2-7b-hf", LLAMA2_7B, PurePromptBuilder, pad_token_id=32000),
    "llama2-13b-pure":  LLMSpec("llama2", "meta-llama/Llama-2-13b-hf", LLAMA2_13B, PurePromptBuilder, pad_token_id=32000),
    # === LLaMa-2 Chat ===
    "llama2-7b-chat":   LLMSpec("llama2", "meta-llama/Llama-2-7b-chat-hf", LLAMA2_7B, LLaMa2ChatPromptBuilder, pad_token_id=32000),
    "llama2-13b-chat":  LLMSpec("llama2", "meta-llama/Llama-2-13b-chat-hf", LLAMA2_13B, LLaMa2ChatPromptBuilder, pad_token_id=32000),
    # === Vicuna v1.5 ===
    "vicuna-v15-7b":    LLMSpec("llama2", "lmsys/vicuna-7b-v1.5", LLAMA2_7B, VicunaV15ChatPromptBuilder, pad_token_id=32000),
    "vicuna-v15-13b":   LLMSpec("llama2", "lmsys/vicuna-13b-v1.5", LLAMA2_13B, VicunaV15ChatPromptBuilder, pad_token_id=32000),
    # === LLaMa-3 (<PAD> added at 128256, resized to 128320) ===
    "llama3-8b-pure":   LLMSpec("llama3", "meta-llama/Meta-Llama-3-8B", LLAMA3_8B, PurePromptBuilder, pad_token_id=128256, eos_token_id=128001),
    "llama3-8b-chat":   LLMSpec("llama3", "meta-llama/Meta-Llama-3-8B-Instruct", LLAMA3_8B, LLaMa31PromptBuilder, pad_token_id=128256, eos_token_id=128001, stop_token_id=128009),
    # === LLaMa-3.1 (pad = <|finetune_right_pad_id|> 128004, no resize) ===
    "llama3.1-8b-chat": LLMSpec("llama31", "meta-llama/Llama-3.1-8B-Instruct", LLAMA31_8B, LLaMa31PromptBuilder, pad_token_id=128004, eos_token_id=128009),
    # === Qwen-2.5 Instruct (no BOS; fp16 storage; pad 128004 as merv_tpu pins it) ===
    "qwen2.5-7b-instruct": LLMSpec("qwen2", "Qwen/Qwen2.5-7B-Instruct", QWEN25_7B, Qwen2PromptBuilder, half_precision_dtype=torch.float16, has_bos=False, pad_token_id=128004, eos_token_id=151645),
    "qwen2.5-3b-instruct": LLMSpec("qwen2", "Qwen/Qwen2.5-3B-Instruct", QWEN25_3B, Qwen2PromptBuilder, half_precision_dtype=torch.float16, has_bos=False, pad_token_id=128004, eos_token_id=151645),
}
# fmt: on


class LLMBackbone(nn.Module):
    def __init__(
        self,
        llm_backbone_id: str,
        llm_max_length: int = 2048,
        inference_mode: bool = False,
        spec: Optional[LLMSpec] = None,
        device: Optional[torch.device] = None,
        sequence_parallel: bool = False,
        pipeline_parallel: bool = False,
        pp_microbatches: int = 0,
    ) -> None:
        super().__init__()
        if spec is None and llm_backbone_id not in LLM_SPECS:
            raise ValueError(f"unknown LLM backbone {llm_backbone_id!r}; known: {sorted(LLM_SPECS)}")
        self.identifier = llm_backbone_id
        self.llm_max_length = llm_max_length
        self.inference_mode = inference_mode
        self.spec = spec if spec is not None else LLM_SPECS[llm_backbone_id]
        self._tokenizer: Any = None
        # the decoder's sp / pp paths (taken only under a mesh with the axis above 1; merv_tpu's pass-through)
        self._parallel = dict(sequence_parallel=sequence_parallel, pipeline_parallel=pipeline_parallel,
                              pp_microbatches=pp_microbatches)
        self.decoder = LlamaDecoder(self.decoder_config, device=resolve_device(device))

    @property
    def decoder_config(self) -> DecoderConfig:
        cfg = self.spec.decoder_config
        if any(self._parallel.values()):
            cfg = dataclasses.replace(cfg, **self._parallel)
        if self.inference_mode:
            cfg = dataclasses.replace(cfg, param_dtype=self.spec.half_precision_dtype)
        return cfg

    @property
    def sequence_parallel(self) -> bool:
        """The decoder's ``sequence_parallel`` (taken only under an sp mesh; ``merv_tpu``'s attribute of the same name)."""
        return self.decoder.cfg.sequence_parallel

    @sequence_parallel.setter
    def sequence_parallel(self, on: bool) -> None:
        self.decoder.cfg = dataclasses.replace(self.decoder.cfg, sequence_parallel=bool(on))

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
            if self.spec.llm_family in ("llama2", "llama3"):
                tok.add_special_tokens({"pad_token": "<PAD>"})
            elif self.spec.llm_family in ("llama31", "qwen2"):
                tok.pad_token = "<|finetune_right_pad_id|>"
            if getattr(tok, "pad_token_id", None) is None or isinstance(tok.pad_token_id, str):
                tok.pad_token_id = self.spec.pad_token_id
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
    def eos_token_id(self) -> int:
        return self.spec.eos_token_id

    @property
    def stop_token_id(self) -> int:
        return self.spec.stop_token_id if self.spec.stop_token_id is not None else self.spec.eos_token_id


def tiny_llm_backbone(
    llm_backbone_id: str = "tiny-pure",
    prompt_builder_cls: Type[PromptBuilder] = PurePromptBuilder,
    has_bos: bool = True,
    inference_mode: bool = False,
    device: Optional[torch.device] = None,
    **config_overrides: Any,
) -> LLMBackbone:
    """Small random LLM backbone with the ByteTokenizer (tests)."""
    cfg = tiny_decoder_config(**config_overrides)
    spec = LLMSpec(
        llm_family="tiny", hf_hub_path="__offline__/tiny", decoder_config=cfg,
        prompt_builder_cls=prompt_builder_cls, has_bos=has_bos, pad_token_id=0, eos_token_id=2,
    )
    return LLMBackbone(
        llm_backbone_id, llm_max_length=cfg.max_position_embeddings, spec=spec,
        inference_mode=inference_mode, device=device,
    )
