"""Prompt builders (counterpart of ``merv_tpu/models/backbones/llm/prompting/prompters.py``).

One generic table-driven builder and the five styles ``merv_tpu`` registers:
pure (``In: ... Out:``), Llama-2 chat (with the reference's malformed
``<<SYS>`` opening tag, kept), Vicuna-1.5, Llama-3.1 and Qwen-2 ChatML (the
last two seed the prompt with the system block and neither strip the
``<image>`` sentinel nor right-strip the prompt). Emitted strings match
``merv_tpu``'s byte for byte, since they feed tokenization.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

MERV_VL_SYSTEM_PROMPT = (
    "You are a helpful language and vision assistant. "
    "You are able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language."
)

VICUNA_SYSTEM_PROMPT = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's questions."
)

SYS_PROMPTS: Dict[str, str] = {"merv": MERV_VL_SYSTEM_PROMPT}


@dataclass(frozen=True)
class PromptStyle:
    """Static description of one chat format."""

    wrap_human: Callable[[str], str]
    wrap_gpt: Callable[[str], str]
    # How the system prompt enters the stream:
    #   'first-human'  -> prepended inside the first human wrap (llama2 chat)
    #   'prefix-human' -> plain-text prefix before the first human wrap (vicuna)
    #   'seed'         -> emitted once into the prompt at construction (llama3.1, qwen2)
    #   'none'         -> no system prompt (pure models)
    system_mode: str = "none"
    system_formatter: Callable[[str], str] = lambda s: s
    bos: str = "<s>"
    eos: str = "</s>"
    strip_image_sentinel: bool = True
    rstrip_output: bool = True


class PromptBuilder:
    """Stateful multi-turn builder; one instance per conversation."""

    def __init__(self, style: PromptStyle, model_family: str, system_prompt: Optional[str] = None) -> None:
        self.style = style
        self.model_family = model_family
        self.turn_count = 0
        self.prompt = ""

        if style.system_mode == "none":
            self.system_prompt = system_prompt
        else:
            raw = self._default_system_prompt() if system_prompt is None else system_prompt
            self.system_prompt = style.system_formatter(raw)
            if style.system_mode == "seed":
                self.prompt = self.system_prompt

    def _default_system_prompt(self) -> str:
        return SYS_PROMPTS[self.model_family]

    # -- core API (reference base_prompter.py:18-25) --------------------------------

    def add_turn(self, role: str, message: str) -> str:
        assert (role == "human") if (self.turn_count % 2 == 0) else (role == "gpt")
        if self.style.strip_image_sentinel:
            message = message.replace("<image>", "").strip()

        wrapped = self._wrap(role, message, first=self.turn_count == 0)
        self.prompt += wrapped
        self.turn_count += 1
        return wrapped

    def get_potential_prompt(self, message: str) -> str:
        # Always assumes it is the human's turn next.
        candidate = self.prompt + self._wrap("human", message, first=self.turn_count == 0)
        return self._finalize(candidate)

    def get_prompt(self) -> str:
        return self._finalize(self.prompt)

    # -- helpers ---------------------------------------------------------------------

    def _wrap(self, role: str, message: str, first: bool) -> str:
        if role == "human":
            if first and self.style.system_mode == "first-human":
                return self.style.wrap_human(self.system_prompt + message)
            if first and self.style.system_mode == "prefix-human":
                return self.system_prompt + self.style.wrap_human(message)
            return self.style.wrap_human(message)
        return self.style.wrap_gpt(message)

    def _finalize(self, prompt: str) -> str:
        # Leading BOS removed because the tokenizer re-adds it (reference
        # base_prompter.py:71-73); header-style formats keep everything.
        if not self.style.rstrip_output:
            return prompt
        return prompt.removeprefix(self.style.bos).rstrip()


def _pure_style() -> PromptStyle:
    eos = "</s>"
    return PromptStyle(
        wrap_human=lambda msg: f"In: {msg}\nOut: ",
        wrap_gpt=lambda msg: f"{msg if msg != '' else ' '}{eos}",
        system_mode="none",
    )


def _llama2_chat_style() -> PromptStyle:
    bos, eos = "<s>", "</s>"
    return PromptStyle(
        wrap_human=lambda msg: f"{bos}[INST] {msg} [/INST] ",
        wrap_gpt=lambda msg: f"{msg if msg != '' else ' '}{eos}",
        system_mode="first-human",
        # the reference's malformed opening tag "<<SYS>" (one '>'), kept for the same bytes
        system_formatter=lambda s: f"<<SYS>\n{s.strip()}\n<</SYS>>\n\n",
    )


def _vicuna_v15_style() -> PromptStyle:
    eos = "</s>"
    return PromptStyle(
        wrap_human=lambda msg: f"USER: {msg} ASSISTANT: ",
        wrap_gpt=lambda msg: f"{msg if msg != '' else ' '}{eos}",
        system_mode="prefix-human",
        system_formatter=lambda s: s.strip() + " ",
    )


def _llama31_style() -> PromptStyle:
    return PromptStyle(
        wrap_human=lambda msg: (
            f"<|start_header_id|>user<|end_header_id|>\n\n{msg}<|eot_id|>"
            f"<|start_header_id|>assistant<|end_header_id|>\n\n"
        ),
        wrap_gpt=lambda msg: f"{msg}<|eot_id|>",
        system_mode="seed",
        system_formatter=lambda s: f"<|start_header_id|>system<|end_header_id|>\n\n{s}<|eot_id|>",
        strip_image_sentinel=False,
        rstrip_output=False,
    )


def _qwen2_style() -> PromptStyle:
    return PromptStyle(
        wrap_human=lambda msg: f"<|im_start|>user\n{msg}<|im_end|>\n<|im_start|>assistant\n",
        wrap_gpt=lambda msg: f"{msg}<|im_end|>",
        system_mode="seed",
        system_formatter=lambda s: f"<|im_start|>system\n{s}<|im_end|>\n",
        strip_image_sentinel=False,
        rstrip_output=False,
    )


class PurePromptBuilder(PromptBuilder):
    def __init__(self, model_family: str, system_prompt: Optional[str] = None) -> None:
        super().__init__(_pure_style(), model_family, system_prompt)


class LLaMa2ChatPromptBuilder(PromptBuilder):
    def __init__(self, model_family: str, system_prompt: Optional[str] = None) -> None:
        super().__init__(_llama2_chat_style(), model_family, system_prompt)


class VicunaV15ChatPromptBuilder(PromptBuilder):
    def __init__(self, model_family: str, system_prompt: Optional[str] = None) -> None:
        super().__init__(_vicuna_v15_style(), model_family, system_prompt)

    def _default_system_prompt(self) -> str:
        return {"merv": VICUNA_SYSTEM_PROMPT}[self.model_family]


class LLaMa31PromptBuilder(PromptBuilder):
    def __init__(self, model_family: str, system_prompt: Optional[str] = None) -> None:
        super().__init__(_llama31_style(), model_family, system_prompt)


class Qwen2PromptBuilder(PromptBuilder):
    def __init__(self, model_family: str, system_prompt: Optional[str] = None) -> None:
        super().__init__(_qwen2_style(), model_family, system_prompt)
