"""Device ms of the LLM's prefill and first-token sample per admitted request, from the program's own
spans: the CUDA events of the ``admit.prefill`` spans in the profiled slice, over the requests they
carry."""

from benchmark.spans import program_spans, requests


def read(cell):
    spans = [s for s in program_spans(cell) if s.name == "admit.prefill" and s.device_ms is not None]
    n = sum(requests(s) for s in spans)
    return sum(s.device_ms for s in spans) / n if n else None
