"""A random-init run directory of merv-full for serving on random weights
(counterpart of ``scripts/make_randinit_run.py``).

Writes ``runs/merv-full-randinit/``: ``config.json`` with merv-full's model
dict (``{"model": ...}``, key for key ``merv_tpu``'s), and a checkpoint of
the projectors and the fusion in fp32, random from a seeded generator,
written by the port's ``training/checkpointing.py``
(``checkpoints/step-.../checkpoint.pt`` and the ``latest-checkpoint``
pointer). The model is built on the ``meta`` device, so the 7B LLM and the
towers are never made; ``load_vid(..., allow_random_weights=True)`` fills
them at load time. The eval and serve commands then run the whole path::

    python -m merv_tpu_torch.cli.make_randinit_run
    python -m merv_tpu_torch.cli.eval_mcq --model_path runs/merv-full-randinit \\
        --eval_dataset dummy_mcq --batch_size 2 --max_new_tokens 16 --allow_random_weights true

The outputs are meaningless (random weights): this proves the path, not the
model. ``merv_tpu``'s script writes an Orbax checkpoint into the same
directory, which only ``merv_tpu``'s ``load_vid`` reads; a directory holding
one is refused rather than mixed with the port's checkpoint.
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import torch

RUN_DIR = Path("runs") / "merv-full-randinit"

# merv-full's model dict as scripts/make_randinit_run.py:38-52 writes it
MERV_FULL_MODEL = {
    "model_id": "merv-full",
    "arch_specifier": "3davg+linear",
    "feature_fusion": "cross_attention_avg_lq",
    "video_backbone_ids": ["languagebind-video-noclass", "dinov2-video-all-tokens",
                           "vivit-google-b-all-no-cls-16frames", "siglip-vit-b16-224px-all-no-cls"],
    "llm_backbone_id": "llama2-7b-pure",
    "image_resize_strategy": "resize-naive",
    "llm_max_length": 2048,
    "num_frames": [16, 16, 32, 16],
    "projector_token_length": 64,
    "visual_feature_length": 1024,
}
TRAINABLE = ("projectors", "feature_fusion")


def orbax_files(run_dir: Path) -> list:
    """``merv_tpu``'s Orbax checkpoint files under ``run_dir/checkpoints``."""
    return sorted(str(p) for p in (Path(run_dir) / "checkpoints").rglob("_METADATA"))


def write_run_dir(run_dir: Path = RUN_DIR, device: Optional[Any] = None, seed: int = 0,
                  model: Optional[Dict[str, Any]] = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """``config.json`` with ``model`` (merv-full's model dict unless given)
    and the align-stage layout the released checkpoints use: projectors and
    fusion only, fp32, random from a generator seeded with ``seed`` on
    ``device`` (the card unless ``"cpu"``), written by ``save_checkpoint``.
    The directory is written fresh; one that holds ``merv_tpu``'s Orbax files
    is refused. Returns the saved state dicts (on the CPU)."""
    from merv_tpu_torch.benchkit import META, build_merv
    from merv_tpu_torch.device import make_generator, resolve_device
    from merv_tpu_torch.nn.core import init_weights
    from merv_tpu_torch.training.checkpointing import save_checkpoint

    dev = resolve_device(device)
    model = MERV_FULL_MODEL if model is None else model
    run_dir = Path(run_dir)
    theirs = orbax_files(run_dir)
    if theirs:
        raise FileExistsError(f"{run_dir} holds merv_tpu's Orbax checkpoint ({theirs[0]}); the port writes its own "
                              "checkpoint format and will not mix the two in one directory: remove it or pick another")
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    (run_dir / "config.json").write_text(json.dumps({"model": model}))
    vidlm = build_merv(model, device=META, projector_dtype=torch.float32)
    g = make_generator(dev, seed)
    saved = {}
    for key in TRAINABLE:
        module = getattr(vidlm, key).to_empty(device=dev)
        init_weights(module, g)
        saved[key] = {n: t.detach().cpu().clone() for n, t in module.state_dict().items()}
    save_checkpoint(run_dir, 1, 0, 0.0, vidlm, list(TRAINABLE))
    return saved


def main(argv: Optional[Sequence[str]] = None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="where the random projectors are drawn: the card unless 'cpu'")
    args = ap.parse_args(argv)
    write_run_dir(RUN_DIR, device=args.device)
    print(f"run dir ready: {RUN_DIR}")
    return RUN_DIR


if __name__ == "__main__":
    main()
