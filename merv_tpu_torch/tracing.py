"""Spans of the program's own work, on the clock of ``torch.profiler``'s trace.

A span is a named stretch of one thread's host time: its parent (the
innermost span open on that thread), a request id (its own, or its
parent's when it is given none; a tuple of ids for a batched prefill) and,
with ``device``, a pair of CUDA events on the current stream that give the
device time of the work it queued. The events are read at :func:`drain`,
after one synchronize, so recording never waits on the card; none is
recorded while the stream is capturing a CUDA graph. :func:`event` records
an instant. The serving engine and the train step mark each of their layer
boundaries with one span (the names and the metrics that read them are
listed in ``PERF.md`` §3).

Recording is on after :func:`enable` and while a ``torch.profiler`` session
runs, so that a profiled run carries the program's spans without being told.
Otherwise :func:`span` returns one shared no-op context: no clock read, no
allocation, no CUDA event. Finished spans wait in a bounded buffer, which
drops the oldest first and counts what it dropped (:func:`dropped`).

The clock. Host times come from ``perf_counter_ns`` (the monotonic clock)
and are mapped to the wall clock through one ``(time_ns, perf_counter_ns)``
pair, taken by :func:`anchor` at :func:`enable` and at the first span of a
profiler session. The profiler's Chrome trace stamps its events at
``baseTimeNanoseconds + ts * 1000`` on the wall clock, anchored once when it
starts, so :func:`chrome_events` lays spans on its timeline.

``timings=``: given a dict, a span synchronises the device at both ends (when
it has one) and adds its seconds under ``key``, whether recording is on or
not. That is the split the ``timings=`` arguments of ``MERV.generate``,
``generation.generate`` and the train step return.

``ProfilerTrace`` is the operator's trace: ``torch.profiler`` over a stretch
of the program, exported as one Chrome trace with the spans merged in
(``MERV_TPU_PROFILE=<dir>`` for training steps 3-8, ``run_training``).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Deque, Dict, List, Optional, Tuple, Union

import torch
import torch.autograd.profiler as _autograd_profiler  # its ``_is_profiler_enabled`` is set while a session runs

DEFAULT_CAPACITY = 1 << 16

_ON = False
_ANCHORED_FOR_PROFILER = False
_BUF: Deque["Span"] = deque(maxlen=DEFAULT_CAPACITY)
_DROPPED = 0
_IDS = itertools.count(1)  # span ids (next() on it is atomic under the GIL)
_LOCK = threading.Lock()
_LOCAL = threading.local()
_OFFSET_NS = time.time_ns() - time.perf_counter_ns()  # wall clock - monotonic clock, from the last anchor


@dataclass
class Span:
    """One finished span (or, with ``instant``, an event). Times are on the wall clock, in ns."""

    name: str
    id: int
    parent: Optional[int]
    thread: int  # the native id of the thread that ran it
    request: Any  # a request id, a tuple of ids, or None
    start_ns: int
    end_ns: int = 0
    index: Optional[int] = None  # e.g. a micro-step's index
    device_ms: Optional[float] = None  # device spans: CUDA-event time (host time where the device is not CUDA)
    instant: bool = False
    events: Optional[Tuple[Any, Any]] = None  # CUDA events until drain()

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


def anchor() -> Tuple[int, int]:
    """Take the ``(time_ns, perf_counter_ns)`` pair that maps span times to the wall clock."""
    global _OFFSET_NS
    p0 = time.perf_counter_ns()
    wall = time.time_ns()
    p1 = time.perf_counter_ns()
    mono = (p0 + p1) // 2
    _OFFSET_NS = wall - mono
    return wall, mono


def enable(capacity: int = DEFAULT_CAPACITY) -> None:
    """Record spans until :func:`disable`, keeping at most ``capacity`` finished ones."""
    global _ON, _BUF, _DROPPED
    with _LOCK:
        _BUF = deque(maxlen=capacity)
        _DROPPED = 0
    anchor()
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


def recording() -> bool:
    return _ON or _autograd_profiler._is_profiler_enabled


def dropped() -> int:
    """Finished spans the buffer dropped (oldest first) since :func:`enable`."""
    return _DROPPED


def drain() -> List[Span]:
    """The finished spans, oldest first, with their device times resolved (one synchronize), and an
    empty buffer. The next profiler session takes a new anchor."""
    global _ANCHORED_FOR_PROFILER
    with _LOCK:
        spans = list(_BUF)
        _BUF.clear()
        _ANCHORED_FOR_PROFILER = False
    if any(s.events is not None for s in spans):
        torch.cuda.synchronize()
    for s in spans:
        if s.events is not None:
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            s.events = None
    return spans


def _stack() -> List[Span]:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
        _LOCAL.thread = threading.get_native_id()
    return st


def _push(rec: Span) -> None:
    global _DROPPED
    with _LOCK:
        if len(_BUF) == _BUF.maxlen:
            _DROPPED += 1
        _BUF.append(rec)


def _on_card(device: Union[bool, torch.device]) -> bool:
    if isinstance(device, torch.device):
        return device.type == "cuda"
    return bool(device) and torch.cuda.is_initialized()


def _sync(device: Union[bool, torch.device]) -> None:
    if _on_card(device):
        torch.cuda.synchronize(device if isinstance(device, torch.device) else None)


def _record(name: str, request: Any, index: Optional[int], instant: bool = False) -> Span:
    global _ANCHORED_FOR_PROFILER
    if not _ON and not _ANCHORED_FOR_PROFILER:
        anchor()
        _ANCHORED_FOR_PROFILER = True
    st = _stack()
    parent = st[-1] if st else None
    if request is None and parent is not None:
        request = parent.request
    return Span(name, next(_IDS), None if parent is None else parent.id, _LOCAL.thread, request,
                time.perf_counter_ns() + _OFFSET_NS, index=index, instant=instant)


class _Span:
    __slots__ = ("name", "request", "index", "device", "timings", "key", "rec", "t0")

    def __init__(self, name: str, request: Any, index: Optional[int], device: Union[bool, torch.device],
                 timings: Optional[Dict[str, float]], key: Optional[str]) -> None:
        self.name, self.request, self.index, self.device = name, request, index, device
        self.timings, self.key = timings, key
        self.rec: Optional[Span] = None
        self.t0 = 0.0

    def __enter__(self) -> "_Span":
        if self.timings is not None:
            _sync(self.device)
            self.t0 = time.perf_counter()
        if recording():
            rec = self.rec = _record(self.name, self.request, self.index)
            if _on_card(self.device) and not torch.cuda.is_current_stream_capturing():
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                rec.events = (ev, None)
            _stack().append(rec)
        return self

    def __exit__(self, *exc: Any) -> None:
        rec = self.rec
        if rec is not None and rec.events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            rec.events = (rec.events[0], ev)
        if self.timings is not None:
            _sync(self.device)
            self.timings[self.key] = self.timings.get(self.key, 0.0) + time.perf_counter() - self.t0
        if rec is not None:
            rec.end_ns = time.perf_counter_ns() + _OFFSET_NS
            if self.device and rec.events is None and not _on_card(self.device):
                rec.device_ms = rec.host_ms  # work off the card runs in the host's time
            st = _stack()
            if st and st[-1] is rec:
                st.pop()
            _push(rec)


class _NoSpan:
    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None


_NOOP = _NoSpan()


def span(name: str, *, request: Any = None, index: Optional[int] = None, device: Union[bool, torch.device] = False,
         timings: Optional[Dict[str, float]] = None, key: Optional[str] = None):
    """A context manager that records one span named ``name`` (see the module's text). ``device``: True
    (the current CUDA device, where CUDA is in use) or a ``torch.device`` also times the queued work on the
    device. ``timings`` / ``key``: synchronise at both ends and add the seconds to ``timings[key]``."""
    if timings is None and not _ON and not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name, request, index, device, timings, key)


def event(name: str, *, request: Any = None) -> None:
    """Record an instant (a request's submit, first token, finish)."""
    if not _ON and not _autograd_profiler._is_profiler_enabled:
        return
    rec = _record(name, request, None, instant=True)
    rec.end_ns = rec.start_ns
    _push(rec)


def chrome_events(spans: List[Span], base_ns: int, pid: Optional[int] = None) -> List[Dict[str, Any]]:
    """Chrome-trace ``X`` (spans) and ``i`` (instants) events at ``ts = (wall_ns - base_ns) / 1000`` µs,
    one track a thread; ``args`` hold the id, the parent, the request, the index and the device ms."""
    pid = os.getpid() if pid is None else pid
    out = []
    for s in spans:
        args: Dict[str, Any] = {"id": s.id, "parent": s.parent}
        if s.request is not None:
            args["request"] = list(s.request) if isinstance(s.request, tuple) else s.request
        if s.index is not None:
            args["index"] = s.index
        if s.device_ms is not None:
            args["device_ms"] = s.device_ms
        ev = {"name": s.name, "cat": "program", "ph": "i" if s.instant else "X", "pid": pid, "tid": s.thread,
              "ts": (s.start_ns - base_ns) / 1e3, "args": args}
        if s.instant:
            ev["s"] = "t"
        else:
            ev["dur"] = (s.end_ns - s.start_ns) / 1e3
        out.append(ev)
    return out


class ProfilerTrace:
    """``torch.profiler`` (the device's activity on the card, the host's operators on a CPU run) from
    :meth:`start` to :meth:`stop`, exported to ``path`` as a Chrome trace that also holds the program's
    spans of that stretch."""

    def __init__(self, path: Union[str, Path]) -> None:
        self.path = Path(path)
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        self.prof = profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU])
        self.prof.__enter__()
        enable()

    def stop(self) -> Path:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        disable()
        spans = drain()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        trace = json.loads(self.path.read_text())
        trace["traceEvents"].extend(chrome_events(spans, int(trace.get("baseTimeNanoseconds", 0))))
        self.path.write_text(json.dumps(trace))
        self.prof = None
        return self.path
