"""Device ms of the four towers per answer: CUDA events from hooks on each video backbone, over the
window's admissions."""


def read(cell):
    return cell.obs.get("towers_ms")
