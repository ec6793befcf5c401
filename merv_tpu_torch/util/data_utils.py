"""Batch collation (counterpart of ``merv_tpu/util/data_utils.py``), numpy as there.

Right-pads ``input_ids`` with ``pad_token_id`` and ``labels`` with
IGNORE_INDEX, ``attention_mask = input_ids != pad``, per-encoder dummy zero
videos for text-only rows, and ``is_multimodal`` / ``multimodal_indices`` /
``is_image``. Sequences pad to ``model_max_length`` by default (fixed shapes,
as ``merv_tpu`` pads for one compiled program; the port keeps it so both
packages see the same batches); ``pad_to_max_length=False`` pads to the
batch's longest row.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from merv_tpu_torch.models.vidlms.base_vidlm import IGNORE_INDEX


@dataclass
class PaddedCollatorForLanguageModeling:
    model_max_length: int
    pad_token_id: int
    default_video_resolutions: List[Tuple[int, ...]]
    padding_side: str = "right"
    pixel_values_dtype: Any = np.uint8
    pad_to_max_length: bool = True

    def __post_init__(self) -> None:
        assert self.padding_side == "right", "only right padding supported (training contract)"
        self.dummy_video_values = [
            np.zeros(res, dtype=self.pixel_values_dtype) for res in self.default_video_resolutions
        ]

    def __call__(self, instances: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        B = len(instances)
        if self.pad_to_max_length:
            T = self.model_max_length
        else:
            T = min(max(len(i["input_ids"]) for i in instances), self.model_max_length)

        input_ids = np.full((B, T), self.pad_token_id, np.int32)
        labels = np.full((B, T), IGNORE_INDEX, np.int32)
        for b, inst in enumerate(instances):
            ids = np.asarray(inst["input_ids"], np.int32)[:T]
            lbl = np.asarray(inst["labels"], np.int32)[:T]
            input_ids[b, : len(ids)] = ids
            labels[b, : len(lbl)] = lbl
        attention_mask = input_ids != self.pad_token_id

        video_values_in = [inst["video_values"] for inst in instances]
        is_image = np.asarray([bool(inst["is_image"]) for inst in instances])
        is_multimodal = np.asarray([vv[0] is not None for vv in video_values_in])
        multimodal_indices = np.flatnonzero(is_multimodal).astype(np.int64)
        video_values = [
            np.stack([
                (vv[e] if vv[e] is not None else self.dummy_video_values[e]).astype(self.pixel_values_dtype)
                for vv in video_values_in
            ])
            for e in range(len(self.dummy_video_values))
        ]
        return dict(
            video_values=video_values,
            input_ids=input_ids,
            attention_mask=attention_mask,
            labels=labels,
            multimodal_indices=multimodal_indices,
            is_multimodal=is_multimodal,
            is_image=is_image,
        )
