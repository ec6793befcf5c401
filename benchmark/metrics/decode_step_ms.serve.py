"""Device ms of one decode step of every slot: the device time of the kernels the captured decode chunks
launched in the profiled slice (kernels correlated to a CUDA-graph launch), over the decode steps the
engine counted in that slice."""


def read(cell):
    p = cell.obs.get("profile")
    if not p or not p.get("decode_steps") or not p.get("graph_kernel_s"):
        return None
    return p["graph_kernel_s"] * 1e3 / p["decode_steps"]
