"""Answer a question about a video with a trained MERV (the port's ``scripts/quick_start.py``).

    python -m merv_tpu_torch.quick_start --run-dir runs/<run> [--video assets/video_demo.mp4]
        [--allow-random-weights] [--device cpu]

The run directory holds ``config.json`` and ``checkpoints/`` (see
:func:`merv_tpu_torch.load_vid`); a registry id such as ``merv-full`` would
need a download, which the port does not do.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from merv_tpu_torch.models.load_vid import load_vid


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run-dir", required=True, type=Path)
    ap.add_argument("--video", type=Path, default=Path("assets/video_demo.mp4"))
    ap.add_argument("--allow-random-weights", action="store_true",
                    help="random towers / LLM where their weights are missing (outputs are meaningless)")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()

    vidlm, model_cfg = load_vid(args.run_dir, get_model_cfg=True, allow_random_weights=args.allow_random_weights,
                                device=args.device)
    prompt_builder = vidlm.llm_backbone.prompt_builder_fn(model_family="merv")
    prompt_builder.add_turn(role="human", message="What is happening in this video?")
    prompt_text = prompt_builder.get_prompt()
    print(vidlm.generate(args.video, prompt_text, do_sample=False, max_new_tokens=512,
                         num_frames=model_cfg.num_frames))


if __name__ == "__main__":
    main()
