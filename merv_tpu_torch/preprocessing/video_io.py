"""Host-side video decode (counterpart of ``merv_tpu/preprocessing/video_io.py``).

The same readers, backend order and sampling as ``merv_tpu``, so both
packages decode a file to the same bytes: uniform ``np.linspace`` frame
sampling over ``[clip_start_sec, clip_end_sec]`` or up to ``end_frame``, the
NaN clip-time guard, frame-directory datasets (VLEP's 3 fps ``*.jpg`` dumps,
ShareGPT's ``*.jpeg`` dirs), GIFs through PIL, and the chunked re-decode of
two known-bad TVQA files.

Backends, the first that opens the file wins (``open_video``):
- ``native``: the FFmpeg decoder of :mod:`merv_tpu_torch.native` (indexed
  seek and ``get_batch(frame_ids)``);
- ``cv2``: OpenCV's VideoCapture, grabbing forward to each sorted frame id;
- ``imageio``: decodes the whole file.

Output is uint8 ``[T, H, W, C]`` numpy on the host; decoding never touches the
card (the per-tower transforms run there).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_KNOWN_BAD_CHUNKED = {"l0w4V7yPdPJQQphx.mp4", "x4oT5lcBVwKl9s27.mp4"}


class VideoReaderBase:
    """decord.VideoReader-equivalent surface: len, avg_fps, get_batch."""

    def __len__(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def get_avg_fps(self) -> float:  # pragma: no cover - abstract
        raise NotImplementedError

    def get_batch(self, frame_ids: Sequence[int]) -> np.ndarray:  # pragma: no cover - abstract
        raise NotImplementedError

    def close(self) -> None:
        pass


class NativeVideoReader(VideoReaderBase):
    """The C++ FFmpeg decoder (:mod:`merv_tpu_torch.native`)."""

    def __init__(self, path: str) -> None:
        from merv_tpu_torch.native import videodec  # raises if disabled or unbuildable

        self._r = videodec.VideoReader(path)

    def __len__(self) -> int:
        return self._r.num_frames()

    def get_avg_fps(self) -> float:
        return self._r.avg_fps()

    def get_batch(self, frame_ids: Sequence[int]) -> np.ndarray:
        return self._r.get_batch(list(int(i) for i in frame_ids))

    def close(self) -> None:
        self._r.close()


class Cv2VideoReader(VideoReaderBase):
    def __init__(self, path: str) -> None:
        import cv2

        self._cv2 = cv2
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise IOError(f"cv2 cannot open video {path}")
        self._n = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self._fps = float(self._cap.get(cv2.CAP_PROP_FPS)) or 30.0
        if self._n <= 0:
            # some containers report no count: count by grabbing
            n = 0
            while self._cap.grab():
                n += 1
            self._n = n
            self._cap.release()
            self._cap = cv2.VideoCapture(path)

    def __len__(self) -> int:
        return self._n

    def get_avg_fps(self) -> float:
        return self._fps

    def get_batch(self, frame_ids: Sequence[int]) -> np.ndarray:
        cv2, cap = self._cv2, self._cap
        wanted = sorted(set(int(i) for i in frame_ids))
        frames = {}
        cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
        pos = 0
        for fid in wanted:
            while pos <= fid:
                if not cap.grab():
                    break
                pos += 1
            # the most recently grabbed frame (pos - 1 == fid unless the stream ended)
            ok, frame = cap.retrieve()
            if not ok or frame is None:
                if frames:
                    frames[fid] = frames[max(frames)]
                    continue
                raise IOError(f"cv2 failed to decode frame {fid}")
            frames[fid] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        return np.stack([frames[int(i)] for i in frame_ids])

    def close(self) -> None:
        self._cap.release()


class ImageioVideoReader(VideoReaderBase):
    def __init__(self, path: str) -> None:
        import imageio.v3 as iio

        self._frames = iio.imread(path, plugin=None)  # [T, H, W, C]
        meta = {}
        try:
            meta = iio.immeta(path)
        except Exception:  # no metadata: the 30 fps default below
            pass
        self._fps = float(meta.get("fps", 30.0))

    def __len__(self) -> int:
        return len(self._frames)

    def get_avg_fps(self) -> float:
        return self._fps

    def get_batch(self, frame_ids: Sequence[int]) -> np.ndarray:
        return np.stack([self._frames[int(i)] for i in frame_ids])


BACKENDS = {"native": NativeVideoReader, "cv2": Cv2VideoReader, "imageio": ImageioVideoReader}


def open_video(path: str, backend: str = "auto") -> VideoReaderBase:
    """The first backend (native, cv2, imageio; or only ``backend``) that opens
    ``path``; ``IOError`` naming the last failure when none does."""
    order = tuple(BACKENDS) if backend == "auto" else (backend,)
    last: Optional[Exception] = None
    for name in order:
        try:
            return BACKENDS[name](path)
        except Exception as e:  # try the next backend
            last = e
    raise IOError(f"no video backend could open {path}: {last}")


def _load_frame_dir(video_path: Path, num_frames: int, clip_start_sec: float, clip_end_sec: Optional[float]) -> np.ndarray:
    import cv2

    p = str(video_path).lower()
    if "vlep" in p:  # 3 fps frame dumps
        fps_in_dir = 3
        images = sorted(str(x) for x in Path(video_path).glob("*.jpg"))
        assert len(images) > 0, f"video directory contains no frames to load video - {video_path}"
        total_secs = len(images) / fps_in_dir
        if clip_end_sec is None:
            clip_end_sec = total_secs
        ids = np.linspace(
            clip_start_sec * fps_in_dir, min(len(images) - 1, clip_end_sec * fps_in_dir - 1), num_frames
        ).astype(int)
    elif "sharegpt" in p:  # jpeg dirs
        images = sorted(str(x) for x in Path(video_path).glob("*.jpeg"))
        assert len(images) > 0, f"video directory contains no frames to load video - {video_path}"
        ids = np.linspace(0, len(images) - 1, num_frames).astype(int)
    else:
        raise NotImplementedError(f"unknown frame-dir dataset layout: {video_path}")
    out = []
    for fid in ids:
        img = cv2.imread(images[int(min(fid, len(images) - 1))])
        out.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    return np.stack(out)


def load_video(
    video_path,
    num_frames: int = 8,
    clip_start_sec: float = 0.0,
    clip_end_sec: Optional[float] = None,
    end_frame: Optional[int] = None,
    backend: str = "auto",
) -> np.ndarray:
    """Decode and uniformly sample a video -> uint8 [T, H, W, C]."""
    if clip_start_sec is not None and math.isnan(clip_start_sec):
        clip_start_sec = 0.0
    if clip_end_sec is not None and math.isnan(clip_end_sec):
        clip_end_sec = None

    video_path = Path(video_path)
    if video_path.is_dir():
        return _load_frame_dir(video_path, num_frames, clip_start_sec, clip_end_sec)

    if video_path.suffix == ".gif":
        from PIL import Image, ImageSequence

        im = Image.open(str(video_path))
        frames = np.stack([np.array(f.convert("RGB")) for f in ImageSequence.Iterator(im)], 0)
        ids = np.linspace(0, frames.shape[0] - 1, num_frames).astype(int)
        return frames[ids]

    reader = open_video(str(video_path), backend=backend)
    try:
        n = len(reader)
        fps = reader.get_avg_fps()
        total_secs = n / fps
        if end_frame is None or end_frame < 0:
            if clip_end_sec is None:
                clip_end_sec = total_secs
            ids = np.linspace(clip_start_sec * fps, min(n - 1, clip_end_sec * fps - 1), num_frames).astype(int)
        else:
            ids = np.linspace(0, min(n - 1, end_frame), num_frames).astype(int)
        ids = np.clip(ids, 0, max(n - 1, 0))

        if video_path.name in _KNOWN_BAD_CHUNKED:
            # two corrupt TVQA files decode only in chunks of 8
            assert num_frames == 32
            chunks = [reader.get_batch(ids[8 * i : 8 * i + 8]) for i in range(4)]
            return np.concatenate(chunks, 0)
        return reader.get_batch(ids)
    finally:
        reader.close()
