"""Export vision-tower weights to ``$MERV_TPU_TOWER_DIR`` safetensors
(counterpart of ``scripts/export_towers.py``).

Each torch checkpoint is converted once into ``{identifier}.safetensors``,
which :func:`~merv_tpu_torch.models.backbones.video.vision_import.load_pretrained_tower`
reads. The stored keys are the checkpoint's own torch names: the port's
mapping happens at load time, so one export serves every token mode of a
tower family. Each file is checked by loading it back into the tower
through ``load_pretrained_tower``.

    python -m merv_tpu_torch.cli.export_towers --out /path/to/towers \\
        --towers languagebind-video-noclass hiera-base-plus-video \\
        --source languagebind=/path/to/LanguageBind_Video_merge \\
        --source hiera=/path/to/hiera_base_plus_16x224.mae_k400.pth [--device cpu]

Local sources, the routes the port takes:
- languagebind: an HF snapshot directory (safetensors / pytorch_model.bin)
  or a torch checkpoint; its ``vision_model.*`` keys;
- hiera: the original repository's ``.pth`` (torch-hub layout, ``model_state``).

``merv_tpu``'s timm and HF-cache routes (DINOv2, SigLIP, ViViT) and
``--online`` (the hubs) need packages and a network the port does not have
(ROADMAP, out of reach): they raise, naming it.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Dict, Optional, Sequence

from merv_tpu_torch.models import materialize
from merv_tpu_torch.overwatch import initialize_overwatch

overwatch = initialize_overwatch(__name__)

DEFAULT_TOWERS = [
    "languagebind-video-noclass",
    "dinov2-video-all-tokens",
    "vivit-google-b-all-no-cls-16frames",
    "siglip-vit-b16-224px-all-no-cls",
    "hiera-base-plus-video",
]
LOCAL_FAMILIES = ("languagebind", "hiera")


def _family(identifier: str) -> str:
    for fam in ("languagebind", "dinov2", "vivit", "siglip", "hiera"):
        if identifier.startswith(fam):
            return fam
    raise ValueError(f"unknown tower family for {identifier}")


def export_tower(identifier: str, out_dir: Path, sources: Dict[str, str], online: bool,
                 device: Optional[str] = None) -> Path:
    """One tower: its local checkpoint -> ``out_dir/{identifier}.safetensors``,
    loaded back into the tower (built on ``device``) to check it."""
    from merv_tpu_torch.models.backbones.video.vision_import import (
        extract_hiera_state,
        extract_languagebind_state,
        load_pretrained_tower,
    )
    from merv_tpu_torch.util.safetensors_io import save_file

    fam = _family(identifier)
    if online:
        raise NotImplementedError("--online (fetching from the HF hub or torch hub) is not ported (ROADMAP, out of "
                                  "reach: no network); pass local checkpoints with --source")
    if fam not in LOCAL_FAMILIES:
        raise NotImplementedError(f"{identifier}: merv_tpu exports {fam} from the timm / HF transformers cache, which "
                                  "the port does not read (ROADMAP, out of reach); only languagebind and hiera "
                                  "export from a local --source")
    state = (extract_languagebind_state if fam == "languagebind" else extract_hiera_state)(sources.get(fam), online)
    (backbone,), _ = materialize.get_video_backbone_and_transform([identifier], "resize-naive", [16], device=device)

    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{identifier}.safetensors"
    save_file(state, out_path)
    os.environ["MERV_TPU_TOWER_DIR"] = str(out_dir)  # the real load path, for the check
    load_pretrained_tower(backbone)
    n = sum(p.numel() for p in backbone.parameters())
    overwatch.info(f"exported {identifier}: {len(state)} tensors -> {out_path} ({n / 1e6:.1f}M params verified)")
    return out_path


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=Path(os.environ.get("MERV_TPU_TOWER_DIR", "towers")))
    ap.add_argument("--towers", nargs="+", default=DEFAULT_TOWERS)
    ap.add_argument("--source", action="append", default=[], metavar="FAMILY=PATH",
                    help="local checkpoint, e.g. languagebind=/ckpts/LanguageBind_Video_merge")
    ap.add_argument("--online", action="store_true", help="fetch from the hubs (not ported: raises)")
    ap.add_argument("--device", default=None, help="where the check builds each tower: the card unless 'cpu'")
    args = ap.parse_args(argv)
    from merv_tpu_torch.device import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: raise before any work
    sources = dict(s.split("=", 1) for s in args.source)
    failures = []
    for ident in args.towers:
        try:
            export_tower(ident, args.out, sources, args.online, args.device)
        except Exception as e:  # each tower on its own: report all that failed
            overwatch.error(f"export failed for {ident}: {type(e).__name__}: {e}")
            failures.append(ident)
    if failures:
        raise SystemExit(f"failed towers: {failures}")
    overwatch.info(f"all towers exported; set MERV_TPU_TOWER_DIR={args.out}")


if __name__ == "__main__":
    main()
