"""Host input pipeline: video decode and the towers' transforms (counterpart
of ``scripts/bench_loader.py``).

The host's cost of one training or evaluation sample for the four towers of
merv-full: decoding 32 frames (the most any tower takes, sampled uniformly)
and each tower's ``host_geometry`` (cv2 resize / crop) on its share of them.
Reports samples/s on one worker, and how many dataloader workers keep up
with the card's multimodal prefill rate, which this bench measures on the
bench model (towers, projectors and fusion, the LLM prefill at
``BENCH_LLM_LAYERS``, default 32, batch 1; CUDA events over 5 prefills) in
place of the TPU rate ``merv_tpu`` writes in.

The clip is synthesised once (a moving gradient, mp4v through cv2) at
``BENCH_LOADER_VIDEO`` (default ``bench_loader.mp4`` in the temporary
directory). Decoding uses the port's ``video_io`` backends in their order
(its own FFmpeg decoder, then cv2, then imageio); the result line names the
one that opened the clip (``video_backend``): a host without the libav
headers has no native decoder, and then cv2 decodes.

Usage: ``python -m merv_tpu_torch.bench.loader [--seconds 10] [--device cpu]``.
Prints the launch counts, then one JSON line: ``metric``, ``value``,
``unit``, ``workers_to_saturate_device``, ``video_backend``,
``prefill_videos_per_sec`` and the device.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from merv_tpu_torch import benchkit
from merv_tpu_torch.device import resolve_device

IDS = ["languagebind-video-noclass", "dinov2-video-all-tokens", "vivit-google-b-all-no-cls-16frames",
       "siglip-vit-b16-224px-all-no-cls"]
FRAMES = [16, 16, 32, 16]
PREFILLS = 5


def make_fixture(path: Path, seconds: int = 10, fps: int = 30, size: int = 320) -> Path:
    """A test clip (a moving gradient, mp4v), written once."""
    import cv2

    if path.exists():
        return path
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (size, size))
    assert w.isOpened(), "cv2 VideoWriter unavailable"
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for t in range(seconds * fps):
        frame = np.stack([(127 + 127 * np.sin(6.28 * (xx + t / 40.0))), (127 + 127 * np.cos(6.28 * (yy - t / 55.0))),
                          np.full_like(xx, (t * 3) % 255)], axis=-1).astype(np.uint8)
        w.write(frame)
    w.release()
    return path


@torch.inference_mode()
def prefill_videos_per_sec(dev: torch.device) -> tuple:
    """(multimodal prefills a second of the bench model at batch 1 on ``dev``, prefills run)."""
    layers = int(os.environ.get("BENCH_LLM_LAYERS", "32"))
    model = benchkit.make_bench_params(benchkit.build_model(layers, tiny=dev.type == "cpu", device=dev))
    from merv_tpu_torch.models.generation import prefill

    ids = torch.full((1, 64), 5, dtype=torch.long, device=dev)
    ids[:, 0] = 1
    mask = torch.ones_like(ids)
    videos = [torch.zeros((1, *vb.default_video_resolution), dtype=torch.bfloat16, device=dev)
              for vb in model.video_backbones]

    calls = [0]

    def one():
        calls[0] += 1
        embeds, emask = model.build_inputs_embeds(ids, mask, videos)
        prefill(model.llm_backbone.decoder, embeds, emask.long(), embeds.shape[1])

    return 1e3 / benchkit.stage_ms(one, dev, PREFILLS), calls[0]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=10.0, help="measurement window")
    ap.add_argument("--device", default=None, help="the card unless 'cpu' (the tiny model's prefill)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    from merv_tpu_torch.models.materialize import get_video_backbone_and_transform
    from merv_tpu_torch.preprocessing.video_io import BACKENDS, load_video, open_video

    default = os.path.join(tempfile.gettempdir(), "bench_loader.mp4")
    fixture = make_fixture(Path(os.environ.get("BENCH_LOADER_VIDEO", default)))
    reader = open_video(str(fixture))
    backend = next(name for name, cls in BACKENDS.items() if isinstance(reader, cls))
    reader.close()
    _, transforms = get_video_backbone_and_transform(IDS, "resize-naive", FRAMES, device=benchkit.META)
    def one_sample():
        video = load_video(str(fixture), num_frames=max(FRAMES), backend=backend)  # [32, H, W, C] uint8
        return [tf.host_geometry(video[:: max(FRAMES) // nf]) for tf, nf in zip(transforms, FRAMES)]

    one_sample()  # warm the decoder's index and any lazy set-up
    n, t0 = 0, time.perf_counter()
    while (dt := time.perf_counter() - t0) < args.seconds:
        one_sample()
        n += 1
    rate = n / dt
    device_rate, prefills = prefill_videos_per_sec(dev)
    return benchkit.emit({
        "metric": "host pipeline samples/sec/worker (decode 32f + 4 transforms)",
        "value": round(rate, 2), "unit": "samples/sec",
        "workers_to_saturate_device": round(device_rate / rate, 1),
        "video_backend": backend, "prefill_videos_per_sec": round(device_rate, 3), "prefills": prefills,
    }, dev)


if __name__ == "__main__":
    main()
