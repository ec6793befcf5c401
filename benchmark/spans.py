"""The program's own spans (``merv_tpu_torch.tracing``) in a traced run, and what is read from them.

The program records spans while a ``torch.profiler`` session runs, so a traced run holds those of its
profiled slice. They are drained once, after the window, by the first reader that asks, and kept on the
cell for the others. A program without the recorder gives none, and every reader then returns None.

``split`` lays the spans on the profiler's trace (``tracing.chrome_events``, through the trace's
``baseTimeNanoseconds``) and splits the slice's device-idle time by the innermost span open on the
program's main thread at each idle interval's middle (``benchmark/idle_split.py`` prints it).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence

from benchmark.harness import DEVICE_CATS

# the spans that mark the thread the engine or the train step runs on
MAIN_SPANS = ("engine.admit", "engine.chunk", "train.step")
# a span's host interval holds a runtime call to this many µs either side (the two clocks' anchors)
CLOCK_SLACK_US = 50.0


def program_spans(cell) -> List[Any]:
    """The finished spans of the run, drained once and kept on the cell (not in ``obs``, which the
    readings line prints)."""
    spans = getattr(cell, "_program_spans", None)
    if spans is None:
        try:
            from merv_tpu_torch import tracing
        except ImportError:  # a program without the recorder
            spans = []
        else:
            spans = tracing.drain()
        cell._program_spans = spans
    return spans


def ancestors(span, by_id: Dict[int, Any]) -> List[str]:
    out = []
    while span.parent is not None and span.parent in by_id:
        span = by_id[span.parent]
        out.append(span.name)
    return out


def under(spans: Sequence[Any], name: str, ancestor: str) -> List[Any]:
    """The spans named ``name`` with an ancestor named ``ancestor``."""
    by_id = {s.id: s for s in spans}
    return [s for s in spans if s.name == name and ancestor in ancestors(s, by_id)]


def device_ms(spans: Iterable[Any]) -> List[float]:
    return [s.device_ms for s in spans if s.device_ms is not None]


def requests(span) -> int:
    return len(span.request) if isinstance(span.request, tuple) else 1


def per_micro(cell, name: str) -> Optional[float]:
    """Device ms of the spans ``name`` under ``train.micro``, per ``train.micro``."""
    spans = program_spans(cell)
    micro = [s for s in spans if s.name == "train.micro"]
    ms = device_ms(under(spans, name, "train.micro"))
    return sum(ms) / len(micro) if micro and ms else None


def idle_intervals(events: Sequence[Dict[str, Any]]) -> List[List[float]]:
    """The gaps (µs) between the union of the device's kernel, copy and set intervals."""
    iv = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
                if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    gaps = []
    if not iv:
        return gaps
    cur = iv[0][1]
    for s, e in iv[1:]:
        if s > cur:
            gaps.append([cur, s])
        cur = max(cur, e)
    return gaps


def split(doc: Dict[str, Any], spans: Sequence[Any]) -> Dict[str, Any]:
    """The slice's idle seconds by the innermost main-thread span open at each gap's middle (``"none"``
    outside every span), the share of them under ``engine.admit``, how many of the slice's
    ``cudaGraphLaunch`` calls lie inside a ``chunk.replay`` span (to ``CLOCK_SLACK_US``), and the spans'
    count and device ms by name."""
    events = doc["traceEvents"]
    marks = []
    if spans:  # a program without the recorder has none, and its idle all falls under "none"
        from merv_tpu_torch.tracing import chrome_events

        marks = chrome_events(list(spans), int(doc.get("baseTimeNanoseconds", 0)))
    main = next((e["tid"] for e in marks if e["name"] in MAIN_SPANS), None)
    mine = sorted((e for e in marks if e["ph"] == "X" and e["tid"] == main), key=lambda e: e["ts"])
    by_id = {e["args"]["id"]: e for e in mine}

    def innermost(t: float) -> Optional[Dict[str, Any]]:
        best = None
        for e in mine:
            if e["ts"] > t:
                break
            if e["ts"] + e["dur"] >= t:
                best = e  # spans nest on a thread: the latest start that still holds t is the innermost
        return best

    def under_admit(e: Dict[str, Any]) -> bool:
        while e is not None:
            if e["name"] == "engine.admit":
                return True
            e = by_id.get(e["args"]["parent"])
        return False

    by_span: Dict[str, float] = {}
    total = admit = 0.0
    for a, b in idle_intervals(events):
        e = innermost((a + b) / 2)
        sec = (b - a) * 1e-6
        by_span[e["name"] if e else "none"] = by_span.get(e["name"] if e else "none", 0.0) + sec
        total += sec
        admit += sec if e is not None and under_admit(e) else 0.0
    replays = [(e["ts"] - CLOCK_SLACK_US, e["ts"] + e["dur"] + CLOCK_SLACK_US) for e in mine
               if e["name"] == "chunk.replay"]
    launches = [e for e in events if e.get("ph") == "X" and e.get("name") == "cudaGraphLaunch"]
    inside = sum(any(a <= float(e["ts"]) and float(e["ts"]) + float(e.get("dur", 0.0)) <= b for a, b in replays)
                 for e in launches)
    device: Dict[str, List[float]] = {}
    for sp in spans:
        if sp.device_ms is not None:
            n_ms = device.setdefault(sp.name, [0, 0.0])
            n_ms[0] += 1
            n_ms[1] += sp.device_ms
    return {"idle_by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
            "idle_admit_share": admit / total if total else None,
            "graph_launches": {"total": len(launches), "in_chunk_replay": inside},
            "device_ms_by_span": device}
