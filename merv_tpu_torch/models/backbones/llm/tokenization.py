"""Offline tokenizer (counterpart of ``merv_tpu/models/backbones/llm/tokenization.py``).

:class:`ByteTokenizer` is the deterministic byte-level tokenizer ``merv_tpu``
falls back to offline, with the same call surface (``__call__``, ``encode``,
``decode``, pad/bos/eos attributes). :func:`load_tokenizer` returns the
HF fast tokenizer where its files are on the machine and ``ByteTokenizer``
otherwise, as ``merv_tpu`` does.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Union

from merv_tpu_torch.overwatch import initialize_overwatch

overwatch = initialize_overwatch(__name__)

# Trigger strings that must tokenize to a single id (reference merv.py:239-244)
_TRIGGER_STRINGS = ["True", "False", "Yes", "No"] + [chr(ord("A") + i) for i in range(26)]


class _Batch(dict):
    """Minimal BatchEncoding: attribute access over dict."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:  # pragma: no cover
            raise AttributeError(name) from e


class ByteTokenizer:
    """Byte-level tokenizer: id = byte + 3 (0=unk, 1=bos, 2=eos); trigger
    strings and chat sentinels get dedicated single ids above the byte range."""

    def __init__(
        self,
        model_max_length: int = 2048,
        add_bos_token: bool = True,
        extra_specials: Sequence[str] = (),
    ) -> None:
        self.model_max_length = model_max_length
        self.add_bos_token = add_bos_token
        self.padding_side = "right"
        self.unk_token, self.bos_token, self.eos_token = "<unk>", "<s>", "</s>"
        self.unk_token_id, self.bos_token_id, self.eos_token_id = 0, 1, 2
        self.pad_token, self.pad_token_id = "<PAD>", 259 + len(_TRIGGER_STRINGS) + len(tuple(extra_specials))
        if not add_bos_token:
            self.bos_token = None

        self._special_to_id: Dict[str, int] = {}
        self._id_to_special: Dict[int, str] = {}
        for i, s in enumerate(list(_TRIGGER_STRINGS) + list(extra_specials)):
            sid = 259 + i
            self._special_to_id[s] = sid
            self._id_to_special[sid] = s

    def __len__(self) -> int:
        return self.pad_token_id + 1

    @property
    def vocab_size(self) -> int:
        return len(self)

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        if text in self._special_to_id:
            ids = [self._special_to_id[text]]
        else:
            ids = [3 + b for b in text.encode("utf-8")]
        if add_special_tokens and self.add_bos_token:
            ids = [self.bos_token_id] + ids
        return ids

    def __call__(
        self,
        text: Union[str, Sequence[str]],
        add_special_tokens: bool = True,
        truncation: bool = False,
        return_tensors: Optional[str] = None,
        **_: Any,
    ) -> _Batch:
        texts = [text] if isinstance(text, str) else list(text)
        all_ids = [self.encode(t, add_special_tokens) for t in texts]
        if truncation:
            all_ids = [ids[: self.model_max_length] for ids in all_ids]
        masks = [[1] * len(ids) for ids in all_ids]
        if isinstance(text, str):
            ids_out: Any = all_ids[0]
            mask_out: Any = masks[0]
        else:
            ids_out, mask_out = all_ids, masks
        if return_tensors == "pt":
            import torch

            ids_out = torch.tensor(all_ids if not isinstance(text, str) else [all_ids[0]])
            mask_out = torch.tensor(masks if not isinstance(text, str) else [masks[0]])
        elif return_tensors == "np":
            import numpy as np

            ids_out = np.asarray(all_ids if not isinstance(text, str) else [all_ids[0]])
            mask_out = np.asarray(masks if not isinstance(text, str) else [masks[0]])
        return _Batch(input_ids=ids_out, attention_mask=mask_out)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out: List[str] = []
        buf: List[int] = []

        def flush() -> None:
            if buf:
                out.append(bytes(buf).decode("utf-8", errors="replace"))
                buf.clear()

        for i in list(ids):
            i = int(i)
            if i in self._id_to_special:
                flush()
                out.append(self._id_to_special[i])
            elif i >= 3 and i < 259:
                buf.append(i - 3)
            elif not skip_special_tokens:
                flush()
                out.append({0: self.unk_token, 1: "<s>", 2: "</s>"}.get(i, f"<{i}>"))
        flush()
        return "".join(out)

    def batch_decode(self, batch: Sequence[Sequence[int]], skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    def add_special_tokens(self, mapping: Dict[str, str]) -> int:
        for key, tok in mapping.items():
            setattr(self, key, tok)
        return 0


def _online() -> bool:
    return os.environ.get("MERV_TPU_ONLINE", "0") == "1" and os.environ.get("HF_HUB_OFFLINE", "0") != "1"


def _findable(hf_hub_path: str) -> bool:
    """Whether ``AutoTokenizer`` could find ``hf_hub_path`` here: a local
    directory, a snapshot in a Hugging Face cache (``HF_HUB_CACHE``,
    ``HUGGINGFACE_HUB_CACHE``, ``TRANSFORMERS_CACHE``, ``HF_HOME/hub``, else
    ``$XDG_CACHE_HOME`` or ``~/.cache``), or the network where it is allowed.
    Where it could not, ``transformers`` is not imported: its import (and
    ``torch._dynamo``'s through it) was most of a fresh process's ``load_vid``."""
    if os.path.isdir(hf_hub_path) or _online():
        return True
    home = os.environ.get("HF_HOME") or os.path.join(
        os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache"), "huggingface")
    caches = [os.environ.get(k) for k in ("HF_HUB_CACHE", "HUGGINGFACE_HUB_CACHE", "TRANSFORMERS_CACHE")]
    folder = "models--" + hf_hub_path.replace("/", "--")
    return any(c and os.path.isdir(os.path.join(c, folder)) for c in caches + [os.path.join(home, "hub")])


def load_tokenizer(
    hf_hub_path: str,
    model_max_length: int = 2048,
    add_bos_token: bool = True,
) -> Any:
    """The HF fast tokenizer for ``hf_hub_path`` from local files (the network
    only under ``MERV_TPU_ONLINE=1``), else :class:`ByteTokenizer`. Any failure,
    ``transformers`` not being installed among them, takes the
    ``ByteTokenizer`` branch. Padding is on the right either way."""
    try:
        if not _findable(hf_hub_path):
            raise FileNotFoundError(f"no local files for {hf_hub_path}")
        from transformers import AutoTokenizer

        kwargs = dict(model_max_length=model_max_length, padding_side="right")
        try:
            tok = AutoTokenizer.from_pretrained(hf_hub_path, local_files_only=True, **kwargs)
        except Exception:
            # the network is opt-in, so an offline run falls through at once instead of retrying
            if not _online():
                raise
            tok = AutoTokenizer.from_pretrained(hf_hub_path, **kwargs)
        if tok.padding_side != "right":
            raise ValueError(f"tokenizer for {hf_hub_path} pads on the {tok.padding_side}, not the right")
        return tok
    except Exception as e:  # offline, no local files, or no transformers
        overwatch.info(f"Tokenizer for {hf_hub_path} unavailable ({type(e).__name__}); using ByteTokenizer fallback")
        return ByteTokenizer(model_max_length=model_max_length, add_bos_token=add_bos_token)
