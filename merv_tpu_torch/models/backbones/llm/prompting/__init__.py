from merv_tpu_torch.models.backbones.llm.prompting.prompters import PromptBuilder, PurePromptBuilder

__all__ = ["PromptBuilder", "PurePromptBuilder"]
