"""Device ms per micro-step of the backward (the remat recompute included), from the program's own spans:
the CUDA events of the ``train.backward`` spans under ``train.micro`` in the profiled slice, over the
``train.micro`` spans there."""

from benchmark.spans import per_micro


def read(cell):
    return per_micro(cell, "train.backward")
