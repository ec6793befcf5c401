"""Per-tower video preprocessing (counterpart of ``merv_tpu/preprocessing/transforms.py``).

``VideoTransform.__call__`` maps a uint8 ``[T, H, W, C]`` video to normalized
``[T, C, S, S]`` (``[C, T, S, S]`` for LanguageBind) float32 on the video's
device: the geometry (resize / shortest-edge resize + center crop /
letterbox) runs as one ``torch.nn.functional.interpolate`` with antialiasing,
the counterpart of ``jax.image.resize`` (also antialiased when it shrinks),
then scale and normalize. So the video goes to the card once, as uint8.
The training path splits that in two, as ``merv_tpu`` does:
:meth:`VideoTransform.host_geometry` resizes uint8 frames on the host (cv2,
in the dataloader's workers) and :meth:`VideoTransform.device_finish` scales,
normalises and transposes a batch of them on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)
HIERA_MEAN = (0.45, 0.45, 0.45)
HIERA_STD = (0.225, 0.225, 0.225)


@dataclass(frozen=True)
class VideoTransform:
    """uint8/float ``[T, H, W, C]`` -> normalized ``[T, C, S, S]`` (or ``[C, T, S, S]``)."""

    target_size: int = 224
    resize_strategy: str = "resize-naive"
    shortest_edge: Optional[int] = None  # resize-crop (e.g. ViViT 256 -> crop 224)
    interpolation: str = "bicubic"
    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD
    channels_first_time: bool = False

    def _resize(self, x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
        """x [T, C, H, W] float -> [T, C, *size]."""
        if tuple(x.shape[-2:]) == tuple(size):
            return x
        mode = {"bicubic": "bicubic", "bilinear": "bilinear"}[self.interpolation]
        return F.interpolate(x, size=size, mode=mode, align_corners=False, antialias=True)

    def _shortest_edge_size(self, H: int, W: int) -> Tuple[int, int]:
        """resize-crop: the size whose shorter edge is ``shortest_edge`` (default S)."""
        se = self.shortest_edge or self.target_size
        return (se, max(1, int(round(W * se / H)))) if H < W else (max(1, int(round(H * se / W))), se)

    def geometry(self, x: torch.Tensor) -> torch.Tensor:
        """[T, C, H, W] float in [0, 1] -> [T, C, S, S] (resize / crop / letterbox)."""
        T, C, H, W = x.shape
        S = self.target_size
        if self.resize_strategy == "resize-naive":
            return self._resize(x, (S, S))
        if self.resize_strategy == "resize-crop":
            nh, nw = self._shortest_edge_size(H, W)
            x = self._resize(x, (nh, nw))
            top, left = (nh - S) // 2, (nw - S) // 2
            return x[:, :, top : top + S, left : left + S]
        if self.resize_strategy == "letterbox":
            m = max(H, W)
            pad_h, pad_w = (m - H) // 2, (m - W) // 2
            canvas = torch.empty((T, C, m, m), dtype=x.dtype, device=x.device)
            canvas[:] = torch.tensor(self.mean, dtype=x.dtype, device=x.device)[:, None, None]
            canvas[:, :, pad_h : pad_h + H, pad_w : pad_w + W] = x
            return self._resize(canvas, (S, S))
        raise ValueError(f"Unknown resize strategy {self.resize_strategy!r}")

    def host_geometry(self, video: Any) -> np.ndarray:
        """uint8 [T, H, W, C] numpy -> uint8 [T, S, S, C] numpy (resize / crop /
        letterbox by cv2, ``merv_tpu``'s host half of the transform, bit for bit;
        ``merv_tpu``'s optional horizontal flip, off by default, is not ported)."""
        import cv2

        video = np.asarray(video)
        assert video.ndim == 4, video.shape
        T, H, W, C = video.shape
        S = self.target_size
        interp = {"bicubic": cv2.INTER_CUBIC, "bilinear": cv2.INTER_LINEAR}[self.interpolation]

        def resize_all(frames, size_hw):
            return np.stack([cv2.resize(f, (size_hw[1], size_hw[0]), interpolation=interp) for f in frames])

        if self.resize_strategy == "resize-naive":
            out = resize_all(video, (S, S))
        elif self.resize_strategy == "resize-crop":
            nh, nw = self._shortest_edge_size(H, W)
            out = resize_all(video, (nh, nw))
            top, left = (nh - S) // 2, (nw - S) // 2
            out = out[:, top : top + S, left : left + S]
        elif self.resize_strategy == "letterbox":
            m = max(H, W)
            pad_h, pad_w = (m - H) // 2, (m - W) // 2
            fill = np.asarray([int(round(v * 255)) for v in self.mean], video.dtype)
            canvas = np.empty((T, m, m, C), video.dtype)
            canvas[...] = fill
            canvas[:, pad_h : pad_h + H, pad_w : pad_w + W] = video
            out = resize_all(canvas, (S, S))
        else:
            raise ValueError(f"Unknown resize strategy {self.resize_strategy!r}")
        return np.ascontiguousarray(out)

    def __call__(self, video: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(video).float().div(255.0).permute(0, 3, 1, 2)  # [T, C, H, W]
        x = self.geometry(x)
        mean = torch.tensor(self.mean, dtype=torch.float32, device=x.device)[:, None, None]
        std = torch.tensor(self.std, dtype=torch.float32, device=x.device)[:, None, None]
        x = (x - mean) / std
        if self.channels_first_time:
            x = x.transpose(0, 1)  # [C, T, S, S]
        return x.contiguous()

    def device_finish(self, x: torch.Tensor) -> torch.Tensor:
        """uint8/float ``[..., T, S, S, C]`` (already at this tower's geometry)
        -> normalized float32 ``[..., T, C, S, S]`` (``[..., C, T, S, S]`` for
        ``channels_first_time``), batched, on ``x``'s device."""
        mean = torch.tensor(self.mean, dtype=torch.float32, device=x.device)
        std = torch.tensor(self.std, dtype=torch.float32, device=x.device)
        x = (x.float() / 255.0 - mean) / std
        nd = x.dim()
        x = x.permute(*range(nd - 4), nd - 4, nd - 1, nd - 3, nd - 2)  # [..., T, C, S, S]
        if self.channels_first_time:
            x = x.transpose(nd - 4, nd - 3)
        return x.contiguous()


def subsample_frames(video: torch.Tensor, num_frames: int) -> torch.Tensor:
    """Stride-subsample a [T, ...] video to num_frames (reference merv.py:804-806)."""
    T = video.shape[0]
    if T == num_frames:
        return video
    stride = max(1, T // num_frames)
    return video[::stride][:num_frames]
