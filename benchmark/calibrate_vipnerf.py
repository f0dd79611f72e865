"""Readings that the ViP-NeRF cell's limits are set from: `calibrate.py`'s
training readings with the cell's own kind (kinds/vip_train.py, its plain
reference reference_vipnerf.py) and faults (faults_vipnerf.py: its two and
those of faults.py).

    python3 benchmark/calibrate_vipnerf.py --workload vipnerf_bf16.vip_train \
        --seeds 11 12 13 ... [--control] [--faults no_prior primary_dir half alter] \
        [--fault-seeds 3]

Prints one JSON line per reading. The benchmark's own runs do not run this.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import calibrate, faults_vipnerf, harness, reference  # noqa: E402
from benchmark.kinds import vip_train  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibration needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.Cell(args.workload)
    against = [("control", reference.CONTROL[cell.dtype])] if args.control else []
    # calibrate.train_readings drives the module-level `train` and `faults`.
    calibrate.train, calibrate.faults = vip_train, faults_vipnerf
    print("card:", harness.smi(), flush=True)
    for i, seed in enumerate(args.seeds):
        fault_names = args.faults if args.fault_seeds is None or i < args.fault_seeds else []
        for r in calibrate.train_readings(cell, seed, device, against, fault_names):
            print(json.dumps(r, default=str), flush=True)
        calibrate._free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
