"""What every driver shares: the cell being run, the clock and events on either device, the card's
description, the kernel timer and peaks (copied from ``merv_tpu_torch.benchkit``: ``graph_ms`` and the
H100 SXM peaks), the profiler slice and its reduction, and CUDA-event spans from module hooks."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 rate and dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12


@dataclass
class Cell:
    name: str
    cfg: dict  # the configuration file
    mix: dict  # the traffic mix file
    limits: dict  # the cell's limits on the numbers compared for ``correct``
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_process: float  # perf_counter at the process's start
    compute_dtype: torch.dtype = torch.bfloat16  # the program's (the CPU tests hold an fp32 program tightly)
    obs: Dict[str, Any] = field(default_factory=dict)  # what the per-layer readers read
    checks: Dict[str, Dict[str, float]] = field(default_factory=dict)  # compared numbers and their limits


def load_by_path(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the clock and events on the card or, in the CPU tests, on the host
# ---------------------------------------------------------------------------


def sync(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


class Event:
    """A CUDA event on the card; the host clock elsewhere (CPU runs are synchronous)."""

    def __init__(self, dev: torch.device) -> None:
        self.cuda = dev.type == "cuda"
        self.ev = torch.cuda.Event(enable_timing=True) if self.cuda else None
        self.t = 0.0

    def record(self) -> "Event":
        if self.cuda:
            self.ev.record()
        else:
            self.t = time.perf_counter()
        return self

    def synchronize(self) -> None:
        if self.cuda:
            self.ev.synchronize()

    def ms_to(self, end: "Event") -> float:
        return self.ev.elapsed_time(end.ev) if self.cuda else (end.t - self.t) * 1e3


class Spans:
    """CUDA-event spans around a module's forward (pre-hook -> hook), kept while ``on``; the events
    are read after the window, so the window never waits on them. ``when(args, kwargs)`` picks calls."""

    def __init__(self, dev: torch.device, modules, when: Optional[Callable[..., bool]] = None) -> None:
        self.dev, self.when, self.on = dev, when, False
        self.pairs: List[List[Event]] = []
        self._open: Dict[int, Event] = {}
        self._handles = []
        for m in modules:
            self._handles.append(m.register_forward_pre_hook(self._pre, with_kwargs=True))
            self._handles.append(m.register_forward_hook(self._post, with_kwargs=True))

    def _pre(self, mod, args, kwargs):
        if self.on and (self.when is None or self.when(args, kwargs)):
            self._open[id(mod)] = Event(self.dev).record()

    def _post(self, mod, args, kwargs, out):
        start = self._open.pop(id(mod), None)
        if start is not None:
            self.pairs.append([start, Event(self.dev).record()])

    def total_ms(self) -> float:
        return sum(a.ms_to(b) for a, b in self.pairs)

    def remove(self) -> None:
        for h in self._handles:
            h.remove()


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def device_fields(dev: torch.device, peak_bytes: int) -> Dict[str, Any]:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1, "memory_peak_bytes": peak_bytes,
            "nvidia_smi": power_limit()}


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def free(dev: torch.device) -> None:
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def strict_fp32() -> None:
    """The reference's float32 is float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ---------------------------------------------------------------------------
# kernel timers (benchkit's) and the least time
# ---------------------------------------------------------------------------


def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device ms of one call of ``fn``: ``calls`` calls captured in one CUDA graph, replayed ``replays``
    times between two CUDA events (host launch cost cannot hide in it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (calls * replays)
    del graph
    return ms


def least_ms(flops: float, bytes_moved: float) -> float:
    """The least time the card could take: the larger of operations over the bf16 peak and bytes over
    the HBM rate."""
    return max(flops / BF16_FLOPS_PER_S, bytes_moved / HBM_BYTES_PER_S) * 1e3


# ---------------------------------------------------------------------------
# the profiler slice
# ---------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the port's kernels: the launch counter's name -> a part of the device kernel's name
PORT_KERNELS = {"small_attention_kt": "small_attn_kernel<true", "flash_attention_forward": "flash_fwd_kernel",
                "flash_attention_backward": "bwd_dq_kernel", "decode_attention": "decode_attention_kernel"}


class ProfileSlice:
    """``torch.profiler`` over a few seconds of the window, reduced after the window: the device's busy
    time (the union of its operations' intervals), the longest operations by name, the longest idle
    gaps labelled by what the host ran at their middle, the kernel records by name and the device time
    of kernels launched by CUDA-graph replays."""

    def __init__(self, dev: torch.device, trace_path: Path) -> None:
        self.dev, self.path = dev, trace_path
        self.prof = None
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        # the device's activity (kernels, copies, sets and the runtime calls that launched them) on the card;
        # no host operator records there, whose cost would stretch the host-bound admission they measure
        self.prof = profile(activities=[ProfilerActivity.CUDA] if self.dev.type == "cuda" else [ProfilerActivity.CPU])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        sync(self.dev)
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    @property
    def started(self) -> bool:
        return self.prof is not None

    def reduce(self) -> Dict[str, Any]:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        self.path.unlink()
        dev_ev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        host = [e for e in events if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver")]
        window_s = self.t1 - self.t0
        if not dev_ev:
            return {"window_s": window_s, "busy_s": 0.0}
        iv = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in dev_ev)
        busy, gaps = 0.0, []
        cur_s, cur_e = iv[0]
        for s, e in iv[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        by_name: Dict[str, float] = {}
        kernels: Dict[str, int] = {}
        for e in dev_ev:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e.get("dur", 0.0)) * 1e-6
            if e.get("cat") == "kernel":
                kernels[e["name"]] = kernels.get(e["name"], 0) + 1
        graph_corr = {e["args"].get("correlation") for e in host if e["name"] == "cudaGraphLaunch"}
        graph_us = sum(float(e.get("dur", 0.0)) for e in dev_ev
                       if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in graph_corr)
        gaps.sort(key=lambda g: g[0] - g[1])
        host.sort(key=lambda e: float(e["ts"]))

        def doing(t: float) -> str:
            best = None
            for e in host:
                ts = float(e["ts"])
                if ts > t:
                    break
                if ts + float(e.get("dur", 0.0)) >= t:
                    best = e["name"]
            return best or "host python"

        return {
            "window_s": window_s,
            "busy_s": busy * 1e-6,
            "device_ops": sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:10],
            "idle_gaps": [[doing((a + b) / 2), (b - a) * 1e-6] for a, b in gaps[:10]],
            "records": {k: sum(n for name, n in kernels.items() if part in name) for k, part in PORT_KERNELS.items()},
            "graph_kernel_s": graph_us * 1e-6,
            "trace_span_s": (iv[-1][1] - iv[0][0]) * 1e-6,
        }


def summary(obs: Dict[str, Any]) -> Dict[str, Any]:
    """The run's readings without the long lists, for one line on standard error."""
    out = {k: v for k, v in obs.items() if k not in ("profile", "probes")}
    if "profile" in obs:
        out["profile"] = {k: v for k, v in obs["profile"].items() if k not in ("device_ops", "idle_gaps")}
    if "probes" in obs:
        out["probes"] = {k: {"ms": v["ms"], "shape": v["shape"]} for k, v in obs["probes"].items()}
    return out


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that only a checkout's first run
    builds; libraries that might load JAX are told not to."""
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ.setdefault("USE_TF", "0")
