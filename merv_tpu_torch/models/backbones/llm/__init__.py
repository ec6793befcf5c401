from merv_tpu_torch.models.backbones.llm.base_llm import LLM_SPECS, LLMBackbone, LLMSpec, tiny_llm_backbone
from merv_tpu_torch.models.backbones.llm.transformer import DecoderConfig, KVCache, LlamaDecoder

__all__ = ["DecoderConfig", "KVCache", "LLMBackbone", "LLMSpec", "LLM_SPECS", "LlamaDecoder", "tiny_llm_backbone"]
