"""Dataset download command (counterpart of ``scripts/preprocess.py``).

    python -m merv_tpu_torch.cli.preprocess --dataset_id <DATASET_ID> [--root_dir data]

Fetches and extracts every component of a registered dataset
(:mod:`merv_tpu_torch.preprocessing.download`; this needs network access) and,
for ``llava-v1.5-instruct``, converts OCR-VQA's GIF / PNG images to the JPG
names its annotations expect. An unknown ``--dataset_id`` is refused before
anything is fetched.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import merv_tpu_torch.conf.registry as draccus
from merv_tpu_torch.overwatch import initialize_overwatch
from merv_tpu_torch.preprocessing import download

overwatch = initialize_overwatch(__name__)


@dataclass
class PreprocessConfig:
    # fmt: off
    dataset_id: str = "llava-v1.5-instruct"     # Dataset to fetch (see merv_tpu_torch/preprocessing/download.py)
    root_dir: Path = Path("data")               # Root directory for datasets
    # fmt: on


@draccus.wrap()
def preprocess(cfg: PreprocessConfig) -> None:
    overwatch.info(f"Downloading & Extracting `{cfg.dataset_id}` to `{cfg.root_dir / 'download'}`")
    download.download_extract(cfg.dataset_id, root_dir=cfg.root_dir)

    # OCR-VQA images ship as GIF/PNG; the annotations expect JPG
    if cfg.dataset_id == "llava-v1.5-instruct":
        download.convert_to_jpg(cfg.root_dir / "download" / cfg.dataset_id / "ocr_vqa" / "images")


if __name__ == "__main__":
    preprocess()
