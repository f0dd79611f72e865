"""What the port's tracing costs when it is on: a benchmark cell's window
with `profiling.enable()` (spans recorded, eager device spans timed, no
profiler) against the same window with tracing off, alternated in one
process on one set-up (off, on, on, off per round).

    python3 tools/tracing_cost.py --workload simplenerf_bf16.train --seconds 20 --rounds 2

Prints one JSON line: the cell's end-to-end metric of each window, off and
on, the medians, and the spans recorded while on.
"""

import argparse
import json
import shutil
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 16)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness
    from simplenerf_torch.utils import profiling

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = harness.Cell(args.workload)
    kind = cell.kind()
    workdir = Path(tempfile.mkdtemp(prefix="tracing_cost_"))
    try:
        st = kind.setup(cell, args.seed, device, workdir)
        got = {"off": [], "on": []}
        spans = 0
        for _ in range(args.rounds):
            for mode in ("off", "on", "on", "off"):
                profiling.reset()
                (profiling.enable if mode == "on" else profiling.disable)()
                _, value, _ = kind.window(st, cell, args.seconds, device)
                profiling.disable()
                got[mode].append(value)
                spans = max(spans, len(profiling.records()))
        metric = cell.traffic["metric"]
        med = {m: statistics.median(v) for m, v in got.items()}
        print(json.dumps({"workload": cell.name, "metric": metric, "windows": got,
                          "median": med, "on_over_off": med["on"] / med["off"],
                          "spans_per_window": spans, "card": harness.smi("name,power.limit")}))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
