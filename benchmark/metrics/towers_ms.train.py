"""Device ms of the four towers per micro-step: CUDA events from hooks on each video backbone, over the
window's micro-steps."""


def read(cell):
    return cell.obs.get("towers_ms")
