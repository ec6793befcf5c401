"""Align / Finetune video datasets (counterpart of
``merv_tpu/preprocessing/datasets/datasets.py``), the same items bit for bit.

- **Align**: the caption-only ``{caption}{eos}`` template, ``labels[0]``
  ignored; an image becomes a video by repeating its frame.
- **Finetune**: multi-turn conversations through the LLM's PromptBuilder,
  each turn tokenized with ``add_special_tokens=(turn_idx == 0)``, human turns
  masked to ``IGNORE_INDEX`` whole, truncation to ``model_max_length``.
- Both: per-tower frame-stride subsampling ``video[::max(F) // F_e]``; an item
  that fails to load is logged and another index drawn at random;
  ``get_modality_lengths()`` for :class:`SplitModalitySampler`.

``__getitem__`` returns uint8 frames at each tower's geometry
(``VideoTransform.host_geometry``, cv2 in the dataloader's workers);
``VideoTransform.device_finish`` scales and normalises them on the card.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Type

import numpy as np

from merv_tpu_torch.models.backbones.llm.prompting import PromptBuilder
from merv_tpu_torch.models.vidlms.base_vidlm import IGNORE_INDEX
from merv_tpu_torch.preprocessing.transforms import VideoTransform
from merv_tpu_torch.preprocessing.video_io import load_video


def _subsampled_views(video: np.ndarray, num_frames: List[int], transforms: List[VideoTransform]) -> List[np.ndarray]:
    """Per-tower stride subsample + host geometry -> uint8 [F_e, S, S, C]."""
    out = []
    for tf, nf in zip(transforms, num_frames):
        frames = video[:: max(num_frames) // nf][:nf]
        out.append(tf.host_geometry(frames))
    return out


def _image_as_video(image_path: Path, num_frames: int) -> np.ndarray:
    from PIL import Image

    image = Image.open(image_path).convert("RGB")
    arr = np.asarray(image, np.uint8)
    return np.repeat(arr[None], num_frames, axis=0)


def _modality_lengths(examples: List[Dict[str, Any]]) -> List[Tuple[bool, int]]:
    """(has an image or a video, word count of all turns) per example."""
    return [("image" in ex or "video" in ex, sum(len(turn["value"].split()) for turn in ex["conversations"]))
            for ex in examples]


class AlignVideoDataset:
    def __init__(
        self,
        chat_json: Path,
        image_dir: Path,
        video_dir: Path,
        video_transforms: List[VideoTransform],
        tokenizer: Any,
        num_frames: List[int],
    ) -> None:
        self.chat_json, self.image_dir = chat_json, image_dir
        self.tokenizer = tokenizer
        self.video_dir, self.video_transforms = video_dir, video_transforms
        self.dataset_type = "align"
        self.num_frames = num_frames
        self.prompt_template = "{caption}" + self.tokenizer.eos_token

        with open(self.chat_json, "r") as f:
            self.examples = json.load(f)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        try:
            conversation = self.examples[idx]["conversations"]
            assert (
                (len(conversation) == 2)
                and ("<image>" not in conversation[-1]["value"])
                and ("<video>" not in conversation[-1]["value"])
            ), "Unexpected text!"

            caption = self.prompt_template.format(caption=conversation[-1]["value"].strip())
            input_ids = np.asarray(self.tokenizer(caption, truncation=True).input_ids, np.int32)
            labels = copy.deepcopy(input_ids)
            labels[0] = IGNORE_INDEX

            video_values: List[Optional[np.ndarray]] = [None for _ in self.video_transforms]
            is_image = False
            if "image" in self.examples[idx]:
                video = _image_as_video(self.image_dir / self.examples[idx]["image"], max(self.num_frames))
                video_values = _subsampled_views(video, self.num_frames, self.video_transforms)
                is_image = True
            if "video" in self.examples[idx]:
                video = load_video(self.video_dir / self.examples[idx]["video"], num_frames=max(self.num_frames))
                video_values = _subsampled_views(video, self.num_frames, self.video_transforms)
        except Exception as e:
            print(f"Error in processing example {idx}!")
            print(e)
            return self.__getitem__(np.random.randint(0, self.__len__() - 1))

        return dict(video_values=video_values, input_ids=input_ids, labels=labels, is_image=is_image)

    def get_modality_lengths(self) -> List[Tuple[bool, int]]:
        return _modality_lengths(self.examples)

    def __len__(self) -> int:
        return len(self.examples)


class FinetuneVideoDataset:
    def __init__(
        self,
        instruct_json: Path,
        image_dir: Path,
        video_dir: Path,
        video_transforms: List[VideoTransform],
        tokenizer: Any,
        prompt_builder_fn: Type[PromptBuilder],
        num_frames: List[int],
    ) -> None:
        self.instruct_json, self.image_dir = instruct_json, image_dir
        self.tokenizer = tokenizer
        self.video_dir, self.video_transforms = video_dir, video_transforms
        self.prompt_builder_fn = prompt_builder_fn
        self.dataset_type = "finetune"
        self.num_frames = num_frames

        with open(self.instruct_json, "r") as f:
            self.examples = json.load(f)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        try:
            conversation = self.examples[idx]["conversations"]
            prompt_builder = self.prompt_builder_fn(model_family="merv")
            input_ids: List[int] = []
            labels: List[int] = []

            for turn_idx, turn in enumerate(conversation):
                msg = prompt_builder.add_turn(turn["from"], turn["value"])
                # a fast tokenizer adds a token to a string that ends in whitespace
                msg = msg.rstrip()
                turn_input_ids = self.tokenizer(msg, add_special_tokens=turn_idx == 0).input_ids
                turn_labels = (
                    [IGNORE_INDEX] * len(turn_input_ids) if (turn_idx % 2) == 0 else list(turn_input_ids)
                )
                input_ids.extend(turn_input_ids)
                labels.extend(turn_labels)

            max_len = getattr(self.tokenizer, "model_max_length", 2048)
            input_ids_arr = np.asarray(input_ids[:max_len], np.int32)
            labels_arr = np.asarray(labels[:max_len], np.int32)

            video_values: List[Optional[np.ndarray]] = [None for _ in self.video_transforms]
            is_image = False
            if "image" in self.examples[idx]:
                labels_arr[0] = IGNORE_INDEX
                video = _image_as_video(self.image_dir / self.examples[idx]["image"], max(self.num_frames))
                video_values = _subsampled_views(video, self.num_frames, self.video_transforms)
                is_image = True
            if "video" in self.examples[idx]:
                labels_arr[0] = IGNORE_INDEX
                video = load_video(self.video_dir / self.examples[idx]["video"], num_frames=max(self.num_frames))
                video_values = _subsampled_views(video, self.num_frames, self.video_transforms)
        except Exception as e:
            print(f"Error in processing example {idx}!")
            print(e)
            return self.__getitem__(np.random.randint(0, self.__len__() - 1))

        return dict(video_values=video_values, input_ids=input_ids_arr, labels=labels_arr, is_image=is_image)

    def get_modality_lengths(self) -> List[Tuple[bool, int]]:
        return _modality_lengths(self.examples)

    def __len__(self) -> int:
        return len(self.examples)
