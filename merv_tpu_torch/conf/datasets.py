"""Dataset configuration registry (counterpart of ``merv_tpu/conf/datasets.py``).

A :class:`DatasetConfig` names the annotation JSON and the media directory of
each training stage, relative to ``dataset_root_dir``; ``--dataset.type``
picks a registered variant on the pretrain command line.
"""

from dataclasses import dataclass, field
from enum import Enum, unique
from pathlib import Path
from typing import Tuple

from merv_tpu_torch.conf.registry import ChoiceRegistry


@dataclass
class DatasetConfig(ChoiceRegistry):
    # fmt: off
    dataset_id: str                                 # Unique ID that fully specifies a dataset variant

    # Dataset Components for each Stage in < align | finetune >
    align_stage_components: Tuple[Path, Path]       # (annotation json, media dir) for `align` stage
    finetune_stage_components: Tuple[Path, Path]    # (annotation json, media dir) for `finetune` stage

    dataset_root_dir: Path                          # Root; component paths are relative to it
    # fmt: on


# LLaVA-v15 + Valley for alignment, LLaVa-v15 + VideoChatGPT for finetuning
@dataclass
class VideoLLaVA_Config(DatasetConfig):
    dataset_id: str = "videollava"

    align_stage_components: Tuple[Path, Path] = field(
        default_factory=lambda: (
            Path("download/videollava/valley_llavaimage.json"),
            Path("download/videollava/"),
        )
    )
    finetune_stage_components: Tuple[Path, Path] = field(
        default_factory=lambda: (
            Path("download/videollava/videochatgpt_llavaimage_tune.json"),
            Path("download/videollava/"),
        )
    )
    dataset_root_dir: Path = Path("data/")


@unique
class DatasetRegistry(Enum):
    VIDEOLLAVA = VideoLLaVA_Config

    @property
    def dataset_id(self) -> str:
        return self.value.dataset_id


for dataset_variant in DatasetRegistry:
    DatasetConfig.register_subclass(dataset_variant.dataset_id, dataset_variant.value)
