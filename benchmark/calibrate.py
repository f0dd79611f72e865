"""Readings that the limits of `limits/<cell>.json` are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 13 ... \
        [--control] [--witness tf32x3] [--faults half alter] [--fault-seeds 3]

In one process, for each seed: the program's compared steps (training) or a
sample of frames (render) against the reference in the configuration's
precision, as a run compares them; with --control, the control (the
reference in the next precision below, in the program's place) against the
same reference; with --witness, the reference in another precision in the
program's place (training; "tf32x3": the float32 kernels' scheme); with
--faults, the program with each planted fault, on the first --fault-seeds
seeds. Prints one JSON line per reading. The benchmark's own runs do not
run this.
"""

import argparse
import contextlib
import gc
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import faults, harness, reference  # noqa: E402
from benchmark.kinds import render, train  # noqa: E402


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def train_readings(cell, seed, device, against: list, fault_names) -> list:
    out = []
    ref = None
    for label, fault in [("program", None)] + [(f"fault_{f}", f) for f in fault_names]:
        workdir = Path(tempfile.mkdtemp(prefix="snerf_cal_"))
        try:
            with (faults.planted(fault, cell) if fault else contextlib.nullcontext()):
                st = train.setup(cell, seed, device, workdir)
            train.release(st)
            _free(device)
            if ref is None:
                ref = train.reference_steps(st, cell, device)
            cmp = train.compare(st["got"], ref)
            out.append({"seed": seed, "what": label, **cmp["numbers"], "where": cmp["where"],
                        "replayed": cmp["replayed"]})
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    for label, precision in against:
        cmp = train.compare(train.as_got(train.reference_steps(st, cell, device, precision)), ref)
        out.append({"seed": seed, "what": label, **cmp["numbers"], "where": cmp["where"]})
    return out


def render_readings(cell, seed, device, against: list, fault_names) -> list:
    out = []
    st = render.setup(cell, seed, device, None)
    render.render_frames(st, n=cell.traffic["check_frames"])
    for f in fault_names:
        with faults.planted(f, cell):
            bad = {"frames": []}
            bad.update({k: st[k] for k in ("tester", "poses", "next")})
            bad["next"] = 0
            render.render_frames(bad, n=cell.traffic["check_frames"])
        st[f"fault_{f}"] = bad["frames"]
    render.release(st)
    _free(device)
    cmp = render.check(st, cell, seed, device)
    out.append({"seed": seed, "what": "program", **cmp["numbers"]})
    for f in fault_names:
        cmp = render.check(dict(st, frames=st[f"fault_{f}"]), cell, seed, device)
        out.append({"seed": seed, "what": f"fault_{f}", **cmp["numbers"]})
    for label, precision in against:
        def answer(pose, pixels, precision=precision):
            return reference.render_frame(st["raw"], st["cfg"], st["params"], pose, precision,
                                          device, pixels=pixels)

        cmp = render.check(st, cell, seed, device, answer=answer)
        out.append({"seed": seed, "what": label, **cmp["numbers"]})
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--witness", nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibration needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.Cell(args.workload)
    against = [("control", reference.CONTROL[cell.dtype])] if args.control else []
    against += [(f"witness_{w}", w) for w in args.witness]
    print("card:", harness.smi(), flush=True)
    fn = train_readings if cell.traffic["kind"] == "train" else render_readings
    for i, seed in enumerate(args.seeds):
        fault_names = args.faults if args.fault_seeds is None or i < args.fault_seeds else []
        for r in fn(cell, seed, device, against, fault_names):
            print(json.dumps(r, default=str), flush=True)
        _free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
