"""Model FLOPs of the work completed in the window (``benchmark/flops.py`` at the true lengths: no
padding, no recompute) over the window's time, in percent of the bf16 peak, 989 TFLOP/s."""

from benchmark.harness import BF16_FLOPS_PER_S


def read(cell):
    o = cell.obs
    if not o.get("span_s") or not o.get("model_flops"):
        return None
    return 100.0 * o["model_flops"] / o["span_s"] / BF16_FLOPS_PER_S
