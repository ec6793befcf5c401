"""Device ms of the four towers per answer, from the program's own spans: the CUDA events of the
``towers`` spans under ``engine.admit`` (one a request, at batch 1) in the profiled slice, over their
count."""

from benchmark.spans import device_ms, program_spans, under


def read(cell):
    ms = device_ms(under(program_spans(cell), "towers", "engine.admit"))
    return sum(ms) / len(ms) if ms else None
