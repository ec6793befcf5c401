"""Per-tower video preprocessing (counterpart of ``merv_tpu/preprocessing/transforms.py``).

``VideoTransform.__call__`` maps a uint8 ``[T, H, W, C]`` video to normalized
``[T, C, S, S]`` (``[C, T, S, S]`` for LanguageBind) float32 on the video's
device: the geometry (resize / shortest-edge resize + center crop /
letterbox) runs as one ``torch.nn.functional.interpolate`` with antialiasing,
the counterpart of ``jax.image.resize`` (also antialiased when it shrinks),
then scale and normalize. So the video goes to the card once, as uint8.
:meth:`VideoTransform.device_finish` is the training path's second half: a
batch of uint8 frames already at the tower's geometry is scaled, normalised
and transposed on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


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

    def geometry(self, x: torch.Tensor) -> torch.Tensor:
        """[T, C, H, W] float in [0, 1] -> [T, C, S, S] (resize / crop / letterbox)."""
        T, C, H, W = x.shape
        S = self.target_size
        if self.resize_strategy == "resize-naive":
            return self._resize(x, (S, S))
        if self.resize_strategy == "resize-crop":
            se = self.shortest_edge or S
            if H < W:
                nh, nw = se, max(1, int(round(W * se / H)))
            else:
                nh, nw = max(1, int(round(H * se / W))), se
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
