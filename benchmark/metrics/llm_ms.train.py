"""Device ms of a micro-step outside the towers: CUDA events around each window step, over its
micro-steps, less the towers' hook time (projectors, fusion, the LLM's forward, recompute and backward,
the loss and the optimizer)."""


def read(cell):
    o = cell.obs
    if o.get("towers_ms") is None or not o.get("step_ms"):
        return None
    return o["step_ms"] * o["steps"] / o["micro_steps"] - o["towers_ms"]
