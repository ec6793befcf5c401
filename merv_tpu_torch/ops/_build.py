"""Build ``merv_tpu_torch/csrc/*.cu`` with ``nvcc`` and load them with ``ctypes``.

Each source is compiled on its own into ``merv_tpu_torch/_build/lib<name>.so``
(a directory ``.gitignore`` lists) with a plain C interface: no PyTorch
headers, so one source builds in seconds. :func:`build_all` starts one
``nvcc`` per source at once and waits for all of them. A library is rebuilt
only when its source's SHA-256 changes (recorded beside it), so the sources in
the checkout are the only inputs. ``ptxas`` reports each kernel's registers,
spills and shared memory (``-Xptxas -v``); the report is kept beside the
library (:func:`build_log`).

Nothing here runs at import time: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH / $CUDA_HOME/bin): the CUDA kernels cannot be built")


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest(src: Path) -> str:
    h = hashlib.sha256(src.read_bytes())
    for dep in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _paths(name: str):
    return BUILD_DIR / f"lib{name}.so", BUILD_DIR / f"lib{name}.so.sha256"


def build_log(name: str) -> str:
    """What nvcc printed when it last built ``csrc/<name>.cu`` ("" if never)."""
    log = BUILD_DIR / f"lib{name}.log"
    return log.read_text() if log.exists() else ""


def _is_fresh(src: Path) -> bool:
    lib, stamp = _paths(src.stem)
    return lib.exists() and stamp.exists() and stamp.read_text() == _digest(src)


def build_all() -> Dict[str, str]:
    """Compile every stale source in parallel; returns {name: nvcc output}.
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s in sources() if not _is_fresh(s)]
    if not todo:
        return {}
    nvcc = find_nvcc()
    procs = {}
    for src in todo:
        lib, _ = _paths(src.stem)
        tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[src] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for src, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[src.stem] = out
        if proc.returncode != 0:
            failed.append(f"--- {src.name} (rc {proc.returncode}) ---\n{out}")
            continue
        lib, stamp = _paths(src.stem)
        os.replace(tmp, lib)
        (BUILD_DIR / f"lib{src.stem}.log").write_text(out)
        stamp.write_text(_digest(src))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if stale."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            src = CSRC_DIR / f"{name}.cu"
            if not src.exists():
                raise FileNotFoundError(src)
            if not _is_fresh(src):
                build_all()
            lib = ctypes.CDLL(str(_paths(name)[0]))
            lib.merv_cuda_error_string.argtypes = [ctypes.c_int]
            lib.merv_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def bind(name: str, fn_name: str, argtypes) -> ctypes.CDLL:
    """:func:`load`, with ``fn_name``'s argument types set (a pointer passed
    without them would be cut to 32 bits) and an int return code."""
    lib = load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.merv_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
