"""A traced run of one cell whose profiled slice is also split by the program's own spans.

    python3 -m benchmark.idle_split --workload <cell> --seed <n> --seconds <s> [--whole-window]

The run is ``python3 -m benchmark.run ... --trace 1``'s, result line included. Its slice also keeps a copy
of the profiler's trace, and the readings line on standard error gains, under ``profile``
(``benchmark.spans.split``): ``idle_by_span``, the slice's device-idle seconds by the innermost span open
on the program's main thread at each idle interval's middle; ``idle_admit_share``, the share of that
idle time under ``engine.admit``; ``graph_launches``, the slice's ``cudaGraphLaunch`` calls and how many
lie inside a ``chunk.replay`` span, the check that the spans and the trace share one clock. The readings
also carry the window's end-to-end values (``end_to_end``), which a traced result line leaves out.
``--whole-window`` records spans from the window's start, so that the span readers read the same
requests and steps as the harness's hooks; by default, as in ``benchmark.run``, the program records them
while the slice's profiler runs.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional

from benchmark import harness, run, spans


class SplitSlice(harness.ProfileSlice):
    """The harness's slice, keeping the exported trace for :func:`result_line`."""

    last: Optional["SplitSlice"] = None

    def reduce(self) -> Dict[str, Any]:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))  # a profile exports once: the harness reads this file
        self.doc = json.loads(self.path.read_text())
        SplitSlice.last = self
        prof, self.prof = self.prof, _Exported()
        try:
            return super().reduce()
        finally:
            self.prof = prof


class _Exported:
    """A profile whose trace is already at the path the harness's reduce reads."""

    def export_chrome_trace(self, path: str) -> None:
        pass


_result_line = run.result_line


def result_line(cell, e2e_values: Dict[str, float], *args, **kwargs) -> Dict[str, Any]:
    prof, sl = cell.obs.get("profile"), SplitSlice.last
    if prof is not None and sl is not None:
        prof.update(spans.split(sl.doc, spans.program_spans(cell)))
    cell.obs["end_to_end"] = dict(e2e_values)  # the traced window's rates, which its result line leaves out
    return _result_line(cell, e2e_values, *args, **kwargs)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    harness.ProfileSlice = SplitSlice
    run.result_line = result_line
    args = list(sys.argv[1:] if argv is None else argv)
    if "--whole-window" in args:  # record spans from the window's start (the drivers reset the peak there)
        args.remove("--whole-window")
        reset_peak = harness.reset_peak

        def reset_and_record(dev) -> None:
            from merv_tpu_torch import tracing

            reset_peak(dev)
            tracing.enable()

        harness.reset_peak = reset_and_record
    return run.main(args + ["--trace", "1"])


if __name__ == "__main__":
    main()
