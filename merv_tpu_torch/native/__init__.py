"""Native (C++) host components (counterpart of ``merv_tpu/native``).

``videodec``: the FFmpeg video decoder, ``videodec.cpp``, a byte-for-byte
copy of ``merv_tpu``'s, bound with ``ctypes``. It is built at first use with
``g++`` and the libav* libraries into ``merv_tpu_torch/_build/`` (a directory
``.gitignore`` lists), never beside the source. A SHA-256 of the source and
the command is kept beside the library, and a library whose record differs
is rebuilt, never opened: a fresh checkout stamps every file with one mtime,
so the mtime cannot tell a stale or foreign binary. Set
``MERV_TPU_NO_NATIVE=1`` to disable it and fall back to the cv2 / imageio
readers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

_SRC = Path(__file__).resolve().parent / "videodec.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_SO = BUILD_DIR / "libvideodec.so"
_HASH = BUILD_DIR / "libvideodec.so.srchash"

_LIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"]
_CMD = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]


def _src_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(_CMD + _LIBS).encode())
    h.update(_SRC.read_bytes())
    return h.hexdigest()


def _build() -> None:
    """Compile into a file of this process's own, then move it in place:
    processes that build at once never open a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_suffix(f".so.tmp{os.getpid()}")
    proc = subprocess.run(_CMD + ["-o", str(tmp), str(_SRC)] + _LIBS, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise ImportError(f"building the native video decoder failed:\n{proc.stderr[-2000:]}")
    os.replace(tmp, _SO)
    _HASH.write_text(_src_hash())


def _load() -> ctypes.CDLL:
    if os.environ.get("MERV_TPU_NO_NATIVE", "0") == "1":
        raise ImportError("native decode disabled via MERV_TPU_NO_NATIVE")
    if not _SO.exists() or not _HASH.exists() or _HASH.read_text().strip() != _src_hash():
        _build()
    lib = ctypes.CDLL(str(_SO))
    lib.vr_open.restype = ctypes.c_void_p
    lib.vr_open.argtypes = [ctypes.c_char_p]
    lib.vr_num_frames.restype = ctypes.c_int64
    lib.vr_num_frames.argtypes = [ctypes.c_void_p]
    lib.vr_fps.restype = ctypes.c_double
    lib.vr_fps.argtypes = [ctypes.c_void_p]
    lib.vr_width.restype = ctypes.c_int
    lib.vr_width.argtypes = [ctypes.c_void_p]
    lib.vr_height.restype = ctypes.c_int
    lib.vr_height.argtypes = [ctypes.c_void_p]
    lib.vr_last_error.restype = ctypes.c_char_p
    lib.vr_last_error.argtypes = [ctypes.c_void_p]
    lib.vr_get_batch.restype = ctypes.c_int
    lib.vr_get_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.vr_get_batch_resized.restype = ctypes.c_int
    lib.vr_get_batch_resized.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.vr_close.restype = None
    lib.vr_close.argtypes = [ctypes.c_void_p]
    return lib


_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_lock = threading.Lock()


def get_lib() -> ctypes.CDLL:
    """The loaded decoder library, built first if missing or stale. Raises
    ``ImportError`` when disabled or when it cannot be built, and then again
    on every later call without trying again: a machine without g++ or the
    libav* headers pays for one failed compile, not one per video. Only the
    message is kept: a kept exception would keep, through its traceback, the
    frames of every caller it was raised into (and the model they hold)."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _load()
            except (ImportError, OSError) as e:  # OSError: no g++, or a library the loader refuses
                _error = str(e)
        if _error is not None:
            raise ImportError(_error)
        return _lib


class _VideoReader:
    """decord.VideoReader-style handle over the C ABI."""

    def __init__(self, path: str) -> None:
        lib = get_lib()
        self._lib = lib
        self._h = lib.vr_open(str(path).encode())
        if not self._h:
            raise IOError(f"native decoder cannot open {path}")

    def num_frames(self) -> int:
        return int(self._lib.vr_num_frames(self._h))

    def avg_fps(self) -> float:
        return float(self._lib.vr_fps(self._h))

    @property
    def width(self) -> int:
        return int(self._lib.vr_width(self._h))

    @property
    def height(self) -> int:
        return int(self._lib.vr_height(self._h))

    @staticmethod
    def _ids(frame_ids: Sequence[int]):
        return (ctypes.c_int64 * len(frame_ids))(*[int(i) for i in frame_ids])

    def get_batch(self, frame_ids: List[int]) -> np.ndarray:
        n = len(frame_ids)
        out = np.empty((n, self.height, self.width, 3), np.uint8)
        rc = self._lib.vr_get_batch(
            self._h, self._ids(frame_ids), n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        )
        if rc < 0:
            raise IOError(f"native decode failed: {self._lib.vr_last_error(self._h).decode()}")
        return out

    def get_batch_resized(self, frame_ids: List[int], width: int, height: int, bicubic: bool = True) -> np.ndarray:
        """Decode and resize in one pass (sws_scale to the target size)."""
        n = len(frame_ids)
        out = np.empty((n, height, width, 3), np.uint8)
        rc = self._lib.vr_get_batch_resized(
            self._h, self._ids(frame_ids), n, width, height, int(bicubic),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if rc < 0:
            raise IOError(f"native decode failed: {self._lib.vr_last_error(self._h).decode()}")
        return out

    def close(self) -> None:
        if self._h:
            self._lib.vr_close(self._h)
            self._h = None

    def __del__(self) -> None:  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class videodec:  # namespace mirroring `from merv_tpu_torch.native import videodec`
    VideoReader = _VideoReader
