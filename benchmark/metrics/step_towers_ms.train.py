"""Device ms of the four towers per micro-step, from the program's own spans: the CUDA events of the
``towers`` spans under ``train.micro`` in the profiled slice, over the ``train.micro`` spans there."""

from benchmark.spans import per_micro


def read(cell):
    return per_micro(cell, "towers")
