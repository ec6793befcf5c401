"""Share of the engine's host time spent in admission over the window (``EngineStats``: the window's
admit_s over admit_s + decode_s): time in which the host queued towers and prefills, not decode chunks."""


def read(cell):
    s, c = cell.obs.get("start"), cell.obs.get("closed")
    if not s or not c:
        return None
    admit, decode = c["admit_s"] - s["admit_s"], c["decode_s"] - s["decode_s"]
    return admit / (admit + decode) if admit + decode > 0 else None
