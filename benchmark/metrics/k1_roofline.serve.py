"""K1's share of its roofline, in percent: the least time (the larger of its operations over 989 TFLOP/s and its
bytes over 3.35 TB/s, from ``benchmark/flops.py``) over its graph-replay time at the cell's shapes, timed
after the window through the port's public op."""

from benchmark.harness import least_ms


def read(cell):
    p = cell.obs.get("probes", {}).get("k1")
    if not p or not p["ms"] > 0:
        return None
    return 100.0 * least_ms(p["flops"], p["bytes"]) / p["ms"]
