"""The port's prompt builders (merv_tpu_torch) against merv_tpu's, byte for byte.

Each of the five builders (pure, Llama-2 chat, Vicuna-1.5, Llama-3.1, Qwen-2)
over a single-turn and a multi-turn conversation, with the default and a
custom system prompt: every ``add_turn`` return value, ``get_prompt`` and
``get_potential_prompt`` must equal merv_tpu's strings exactly (they feed
tokenization). That covers the reference's malformed ``<<SYS>`` tag, the
``<image>`` sentinel stripped by the pair styles and kept by Llama-3.1 and
Qwen-2, the empty answer written as one space, and the rstrip that only the
pair styles apply.
"""

import pytest

import merv_tpu.models.backbones.llm.prompting as jax_prompting
import merv_tpu_torch.models.backbones.llm.prompting as prompting

BUILDERS = ["PurePromptBuilder", "LLaMa2ChatPromptBuilder", "VicunaV15ChatPromptBuilder", "LLaMa31PromptBuilder",
            "Qwen2PromptBuilder"]
CONVERSATIONS = {
    "single": [("human", "<image>\nWhat is happening in this video?")],
    "multi": [("human", "<image>\nWhat is happening in this video? "), ("gpt", "A dog runs.  "),
              ("human", "And then?"), ("gpt", ""), ("human", "  Describe the colours <image> please.\n")],
}
SYSTEM_PROMPTS = {"default": None, "custom": "  You answer in one short sentence.  "}


@pytest.mark.parametrize("system", list(SYSTEM_PROMPTS))
@pytest.mark.parametrize("conversation", list(CONVERSATIONS))
@pytest.mark.parametrize("builder", BUILDERS)
def test_builder_emits_merv_tpus_strings(builder, conversation, system):
    want = getattr(jax_prompting, builder)("merv", system_prompt=SYSTEM_PROMPTS[system])
    got = getattr(prompting, builder)("merv", system_prompt=SYSTEM_PROMPTS[system])
    assert got.system_prompt == want.system_prompt
    assert got.get_potential_prompt("First question?") == want.get_potential_prompt("First question?")
    for role, message in CONVERSATIONS[conversation]:
        assert got.add_turn(role, message) == want.add_turn(role, message)
        assert got.get_prompt() == want.get_prompt()
        assert got.turn_count == want.turn_count
    assert got.get_potential_prompt(" <image> One more? ") == want.get_potential_prompt(" <image> One more? ")


def test_llama2_chat_keeps_the_reference_tag():
    """The reference's opening tag has one '>' too few; the port keeps it."""
    prompt = prompting.LLaMa2ChatPromptBuilder("merv").get_potential_prompt("hi")
    assert prompt.startswith("[INST] <<SYS>\n") and "\n<</SYS>>\n\n" in prompt


@pytest.mark.parametrize("builder", BUILDERS)
def test_turns_must_alternate(builder):
    for module in (jax_prompting, prompting):
        b = getattr(module, builder)("merv")
        with pytest.raises(AssertionError):
            b.add_turn("gpt", "out of turn")
