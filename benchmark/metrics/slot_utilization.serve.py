"""Share of the window's decode slot-steps that served a live request (``EngineStats`` slot-steps)."""


def read(cell):
    s, c = cell.obs.get("start"), cell.obs.get("closed")
    if not s or not c:
        return None
    active, idle = c["active"] - s["active"], c["idle"] - s["idle"]
    return active / (active + idle) if active + idle > 0 else None
