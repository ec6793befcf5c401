"""Dataset downloader (counterpart of ``merv_tpu/preprocessing/download.py``).

The registry of dataset components (annotation JSONs and media archives),
download, extraction with a path-traversal guard, and the OCR-VQA pass that
converts images to JPG. The URLs are the public sources ``merv_tpu`` names:
:func:`download_with_progress` and :func:`download_extract` need network
access (``requests``) and are not run by the tests; extraction and conversion
work on local files.
"""

from __future__ import annotations

import os
import shutil
import tarfile
import zipfile
from pathlib import Path
from typing import Dict, List, TypedDict

from merv_tpu_torch.overwatch import initialize_overwatch

overwatch = initialize_overwatch(__name__)


class DatasetComponent(TypedDict, total=False):
    name: str
    extract: bool
    extract_type: str
    url: str
    do_rename: bool


# fmt: off
DATASET_REGISTRY: Dict[str, List[DatasetComponent]] = {
    # === LLaVa v1.5 Dataset(s) — alignment + instruct-tuning stages ===
    "llava-laion-cc-sbu-558k": [
        {"name": "chat.json", "extract": False,
         "url": "https://huggingface.co/datasets/liuhaotian/LLaVA-Pretrain/resolve/main/blip_laion_cc_sbu_558k.json",
         "do_rename": True},
        {"name": "images", "extract": True, "extract_type": "directory",
         "url": "https://huggingface.co/datasets/liuhaotian/LLaVA-Pretrain/resolve/main/images.zip",
         "do_rename": False},
    ],
    "llava-v1.5-instruct": [
        {"name": "llava_v1_5_mix665k.json", "extract": False,
         "url": "https://huggingface.co/datasets/liuhaotian/LLaVA-Instruct-150K/resolve/main/llava_v1_5_mix665k.json",
         "do_rename": True},
        {"name": "coco/train2017", "extract": True, "extract_type": "directory",
         "url": "http://images.cocodataset.org/zips/train2017.zip", "do_rename": True},
        {"name": "gqa/images", "extract": True, "extract_type": "directory",
         "url": "https://downloads.cs.stanford.edu/nlp/data/gqa/images.zip", "do_rename": True},
        {"name": "ocr_vqa/images", "extract": True, "extract_type": "directory",
         "url": "https://huggingface.co/datasets/qnguyen3/ocr_vqa/resolve/main/ocr_vqa.zip", "do_rename": True},
        {"name": "textvqa/train_images", "extract": True, "extract_type": "directory",
         "url": "https://dl.fbaipublicfiles.com/textvqa/images/train_val_images.zip", "do_rename": True},
        {"name": "vg/VG_100K", "extract": True, "extract_type": "directory",
         "url": "https://cs.stanford.edu/people/rak248/VG_100K_2/images.zip", "do_rename": True},
        {"name": "vg/VG_100K_2", "extract": True, "extract_type": "directory",
         "url": "https://cs.stanford.edu/people/rak248/VG_100K_2/images2.zip", "do_rename": True},
    ],
    # === Video-LLaVA (Valley + VideoChatGPT): hosted as a HF dataset repo;
    #     fetch with `huggingface-cli download LanguageBind/Video-LLaVA` ===
}
# fmt: on


def convert_to_jpg(image_dir: Path) -> None:
    """OCR-VQA images: write a JPG beside each GIF / PNG (the original is kept)."""
    from PIL import Image

    overwatch.info(f"Converting all Images in `{image_dir}` to JPG")
    for image_path in sorted(Path(image_dir).iterdir()):
        if image_path.suffix in (".jpg", ".jpeg") or image_path.is_dir():
            continue
        jpg_path = image_path.with_suffix(".jpg")
        if image_path.suffix in (".png", ".gif"):
            Image.open(image_path).convert("RGB").save(jpg_path)
        else:
            overwatch.info(f"Skipping `{image_path}` with unexpected suffix")


def download_with_progress(url: str, download_dir: Path, chunk_size_bytes: int = 1024 * 64) -> Path:
    import requests

    overwatch.info(f"Downloading {url}")
    dest = Path(download_dir) / Path(url).name
    if dest.exists():
        return dest
    with requests.get(url, stream=True, timeout=60) as r:
        r.raise_for_status()
        with open(dest, "wb") as f:
            for chunk in r.iter_content(chunk_size=chunk_size_bytes):
                f.write(chunk)
    return dest


def _safe_member(name: str, dest: Path) -> None:
    """Reject members that would escape dest (path traversal, the CVE-2007-4559
    class: these archives come from third-party dataset hosts)."""
    resolved = (dest / name).resolve()
    if not str(resolved).startswith(str(Path(dest).resolve()) + os.sep):
        raise ValueError(f"archive member escapes extraction dir: {name!r}")


def extract_with_progress(archive_path: Path, download_dir: Path, extract_type: str, cleanup: bool = False) -> Path:
    overwatch.info(f"Extracting {archive_path}")
    if str(archive_path).endswith(".zip"):
        with zipfile.ZipFile(archive_path) as zf:
            names = zf.namelist()
            for n in names:
                _safe_member(n, Path(download_dir))
            zf.extractall(download_dir)
            out = Path(download_dir) / names[0].split("/")[0]
    elif str(archive_path).endswith((".tar.gz", ".tgz", ".tar")):
        with tarfile.open(archive_path) as tf:
            names = tf.getnames()
            # "data" filter (py3.12+): strips absolute paths, blocks .. escapes,
            # device nodes and unsafe links
            tf.extractall(download_dir, filter="data")
            out = Path(download_dir) / names[0].split("/")[0]
    else:
        raise ValueError(f"cannot extract {archive_path}")
    if cleanup:
        archive_path.unlink()
    if extract_type == "directory":
        return out
    return Path(download_dir)


def download_extract(dataset_id: str, root_dir: Path) -> None:
    """Fetch and extract every component of a registered dataset."""
    if dataset_id not in DATASET_REGISTRY:
        raise ValueError(f"Dataset `{dataset_id}` not in registry: {list(DATASET_REGISTRY)}")
    download_dir = Path(root_dir) / "download" / dataset_id
    download_dir.mkdir(parents=True, exist_ok=True)

    for component in DATASET_REGISTRY[dataset_id]:
        target = download_dir / component["name"]
        if target.exists():
            overwatch.info(f"`{target}` exists; skipping")
            continue
        archive = download_with_progress(component["url"], download_dir)
        if component.get("extract"):
            extracted = extract_with_progress(archive, download_dir, component.get("extract_type", "directory"))
            if component.get("do_rename") and extracted != target:
                target.parent.mkdir(parents=True, exist_ok=True)
                shutil.move(str(extracted), str(target))
        elif component.get("do_rename") and archive.name != Path(component["name"]).name:
            target.parent.mkdir(parents=True, exist_ok=True)
            shutil.move(str(archive), str(target))
