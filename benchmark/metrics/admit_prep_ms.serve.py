"""Host ms of request preparation on the engine's thread per admission, from the program's own spans:
the ``admit.prepare`` (inline, when the request was not prefetched) and ``admit.prefetch_wait`` (the join
of the prefetch thread) spans of the profiled slice, over the ``towers`` spans under ``engine.admit``."""

from benchmark.spans import program_spans, under


def read(cell):
    spans = program_spans(cell)
    n = len(under(spans, "towers", "engine.admit"))
    if not n:
        return None
    return sum(s.host_ms for s in spans if s.name in ("admit.prepare", "admit.prefetch_wait")) / n
