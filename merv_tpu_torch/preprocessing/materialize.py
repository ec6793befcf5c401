"""Dataset factory (counterpart of ``merv_tpu/preprocessing/materialize.py``).

The collator's dummy videos (for text-only rows) are the uint8 host-geometry
shapes ``(F_e, S, S, 3)`` of each tower: the datasets return resized uint8
frames, and ``VideoTransform.device_finish`` normalises them on the card.
"""

from __future__ import annotations

from typing import Any, List, Tuple, Type

from merv_tpu_torch.conf.datasets import DatasetConfig
from merv_tpu_torch.models.backbones.llm.prompting import PromptBuilder
from merv_tpu_torch.preprocessing.datasets import AlignVideoDataset, FinetuneVideoDataset
from merv_tpu_torch.preprocessing.transforms import VideoTransform
from merv_tpu_torch.util.data_utils import PaddedCollatorForLanguageModeling

DATASET_INITIALIZER = {
    "align": AlignVideoDataset,
    "full-align": AlignVideoDataset,
    "second_align": AlignVideoDataset,
    "finetune": FinetuneVideoDataset,
    "full-finetune": FinetuneVideoDataset,
    "second_finetune": FinetuneVideoDataset,
}


def host_video_resolutions(
    video_transforms: List[VideoTransform], num_frames: List[int]
) -> List[Tuple[int, int, int, int]]:
    """uint8 host-geometry shapes per tower: (F_e, S_e, S_e, 3)."""
    return [(nf, tf.target_size, tf.target_size, 3) for tf, nf in zip(video_transforms, num_frames)]


def get_dataset_and_collator(
    stage: str,
    dataset_cfg: DatasetConfig,
    video_transforms: List[VideoTransform],
    tokenizer: Any,
    prompt_builder_fn: Type[PromptBuilder],
    num_frames: List[int],
    default_video_resolutions: List[Tuple[int, ...]] = None,
    padding_side: str = "right",
) -> Tuple[Any, PaddedCollatorForLanguageModeling]:
    if stage not in DATASET_INITIALIZER:
        raise ValueError(f"Stage `{stage}` is not supported!")
    dataset_root_dir = dataset_cfg.dataset_root_dir
    if default_video_resolutions is None:
        default_video_resolutions = host_video_resolutions(video_transforms, num_frames)

    collator = PaddedCollatorForLanguageModeling(
        tokenizer.model_max_length,
        tokenizer.pad_token_id,
        default_video_resolutions,
        padding_side=padding_side,
    )

    if stage.endswith("align"):
        annotation_json, image_dir = dataset_cfg.align_stage_components
        dataset = AlignVideoDataset(
            dataset_root_dir / annotation_json,
            dataset_root_dir / image_dir,
            dataset_root_dir / image_dir,
            video_transforms,
            tokenizer,
            num_frames=num_frames,
        )
        return dataset, collator

    annotation_json, image_dir = dataset_cfg.finetune_stage_components
    dataset = FinetuneVideoDataset(
        dataset_root_dir / annotation_json,
        dataset_root_dir / image_dir,
        dataset_root_dir / image_dir,
        video_transforms,
        tokenizer,
        prompt_builder_fn=prompt_builder_fn,
        num_frames=num_frames,
    )
    return dataset, collator
