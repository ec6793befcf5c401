from merv_tpu_torch.models.backbones.llm.prompting.prompters import (
    LLaMa2ChatPromptBuilder,
    LLaMa31PromptBuilder,
    PromptBuilder,
    PurePromptBuilder,
    Qwen2PromptBuilder,
    VicunaV15ChatPromptBuilder,
)

__all__ = [
    "LLaMa2ChatPromptBuilder",
    "LLaMa31PromptBuilder",
    "PromptBuilder",
    "PurePromptBuilder",
    "Qwen2PromptBuilder",
    "VicunaV15ChatPromptBuilder",
]
