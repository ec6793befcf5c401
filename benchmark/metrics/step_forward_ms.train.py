"""Device ms per micro-step of the model's forward past the towers (projectors, fusion, splice, the LLM's
forward and the chunked loss), from the program's own spans: the CUDA events of the ``train.forward``
spans under ``train.micro`` in the profiled slice, over the ``train.micro`` spans there."""

from benchmark.spans import per_micro


def read(cell):
    return per_micro(cell, "train.forward")
