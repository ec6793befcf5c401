"""Device ms of the LLM's prefill per answer: CUDA events from hooks on the decoder around its calls with
more than one position."""


def read(cell):
    return cell.obs.get("prefill_ms")
