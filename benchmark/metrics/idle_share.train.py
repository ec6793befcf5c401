"""Share of the profiled slice in which no operation ran on the device (``torch.profiler``: the union of
kernel, copy and set intervals against the slice's length)."""


def read(cell):
    p = cell.obs.get("profile")
    if not p or not p.get("busy_s"):
        return None
    return max(0.0, 1.0 - p["busy_s"] / p["window_s"])
