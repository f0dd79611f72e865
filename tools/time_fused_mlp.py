"""The four fused-MLP kernels timed through their wrappers at the training
step's shapes, one JSON line per run, so that two checkouts can be compared
run by run.

    python3 tools/time_fused_mlp.py                 # this checkout's kernels
    python3 tools/time_fused_mlp.py --parent DIR    # DIR's package and kernels
    python3 tools/time_fused_mlp.py --dtype float32 --step   # float32, and the step and a frame

Needs one CUDA card. The operands are chip_smoke.py's (its seeds and
shapes; bf16 unless --dtype float32): the fine MLP at 4096 rays x 192
samples (seed 3, as chip_smoke.py times it, and seed 192, as
tools/probe_fused_mlp.py times it) and the coarse trio at 4096 x 64
(seed 5). Each wrapper is timed three ways:

  - CUDA events around `iters` calls after one warm-up, as chip_smoke.py
    does (10 calls for a forward, 5 for a backward), and around 20 calls
    for a forward, as the probe does;
  - the host's time per call until the wrapper returns (`host_ms`, the
    perf counter around the same calls, no synchronisation inside the
    loop): above the device time, the wrapper is bound by the host (a
    wrapper that synchronises inside waits for the card there too);
  - torch.profiler over 5 calls: per call, the device time of the kernel
    itself (the events whose name holds "fused_mlp" or "colsum") and of
    every device operation the call issues (the packing included); for a
    backward also its passes over 3 calls (chip_smoke.bwd_pass_ms: row
    pass, weight pass, column sums, and each column sum apart).

Beside each wrapper at the step's shapes: its plain version's time (CUDA
events, `plain_ms`), and beside each backward the per-dW torch.matmul on
a seeded stash of the step's shape (chip_smoke.weight_pass_yardsticks,
`weight_library_ms`), and the stash bytes the weight pass's producers
issue (`weight_issued_gb`, a count from the plan).

The fine forward is timed once before and once after three calls of the
64k-ray x 192 serving chunk, the shape the probe times just before it.
With --step it also times, in the same compute type and through the
checkout's package, the published recipe's training step through the loop
and through the CUDA graph and one 756x1008 frame through
`Tester.predict_frame` (chip_smoke.step_time and frame_time, on a fresh
seeded scene). Run it alternately on two checkouts, one process each
(parent / change / change / parent ...), to read each side's spread;
unpack `git archive <commit>` into a gitignored directory such as
build/parent for --parent.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def profile_ms(fn, calls: int = 5) -> tuple[float, float]:
    """(kernel ms, all device ms) per call of fn, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernel = total = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3 / calls
            total += ms
            if "fused_mlp" in e.name or "colsum" in e.name:
                kernel += ms
    return kernel, total


def host_ms(fn, iters: int) -> float:
    """Host milliseconds per call of fn until it returns, after a warm-up."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = 1e3 * (time.perf_counter() - start) / iters
    torch.cuda.synchronize()
    return ms


def timings(fn, iters: tuple[int, ...], plan=None) -> dict:
    """Event and profiler times of fn; with a backward's plan, also its
    passes (row, weight, column sums, each column sum apart)."""
    import chip_smoke

    out = {f"events_{n}": chip_smoke.cuda_time_ms(fn, iters=n) for n in iters}
    out["host_ms"] = host_ms(fn, iters[0])
    out["kernel_ms"], out["device_ms"] = profile_ms(fn)
    if plan is not None:  # a parent's plan may have no slices: one launch a sum
        sums = tuple(2 if n > 1 else 1 for n in getattr(plan, "slices", (1, 1, 1)))
        out.update(chip_smoke.bwd_pass_ms(fn, sums=sums))
    return out


def library(row: dict, label: str, plan, rows: int, ns: int) -> None:
    """The per-dW torch.matmul on a seeded stash of the plan's shape into
    `row` (chip_smoke.weight_pass_yardsticks; float32 without TF32)."""
    import torch

    import chip_smoke

    dname = chip_smoke.dname_of(plan.wts.dtype)
    torch.cuda.empty_cache()
    ys = chip_smoke.weight_pass_yardsticks(label, plan, rows, chip_smoke._sum_shapes(plan, rows, ns),
                                           dname)
    row["weight_library_ms"] = ys["weight_library_ms"]
    row["weight_issued_gb"] = ys["weight_issued_gb"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="a checkout of an earlier commit whose package and kernels to time")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the kernels' compute type")
    ap.add_argument("--step", action="store_true",
                    help="also time the training step (loop and graph) and a 756x1008 frame")
    args = ap.parse_args()
    import torch

    import chip_smoke  # this checkout's: its helpers import the package lazily

    if args.parent:
        sys.path.insert(0, str(args.parent.resolve()))
    from simplenerf_torch.fields.mlp import MLPConfig
    from simplenerf_torch.ops import build, fused_mlp

    if not torch.cuda.is_available():
        raise SystemExit("the timing needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    cd = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    nr, fine_ns, coarse_ns = chip_smoke.STEP_RAYS, chip_smoke.FINE_NS, chip_smoke.COARSE_NS
    out = {"checkout": str(build.CSRC.parents[2]), "card": chip_smoke.card_line(),
           "dtype": args.dtype}

    ops = chip_smoke.kernel_operands(MLPConfig(), nr, fine_ns, cd, seed=3)
    alt = chip_smoke.kernel_operands(MLPConfig(), nr, fine_ns, cd, seed=192)
    dp = chip_smoke.cotangents(ops[0].n_planes, nr, fine_ns, seed=4)
    out["fwd fine seed 3"] = timings(lambda: fused_mlp.fused_apply(*ops), (10, 20))
    out["fwd fine seed 192"] = timings(lambda: fused_mlp.fused_apply(*alt), (10, 20))
    plan = fused_mlp.pack_bwd_program(*ops[:2], nr * fine_ns)
    out["bwd fine"] = timings(lambda: fused_mlp.fused_bwd(*ops, dp), (5,), plan)
    out["fwd fine seed 3"]["plain_ms"] = chip_smoke.cuda_time_ms(
        lambda: fused_mlp.fused_apply_reference(*ops), iters=3)
    out["bwd fine"]["plain_ms"] = chip_smoke.cuda_time_ms(
        lambda: fused_mlp.fused_bwd_reference(*ops, dp), iters=2)
    library(out["bwd fine"], "fused_mlp_bwd", plan, nr * fine_ns, fine_ns)

    ens, kps, lo, hvxs = chip_smoke.ensemble_operands(nr, coarse_ns, cd, seed=5)
    edp = chip_smoke.cotangents(ens.n_planes, nr, coarse_ns, seed=6)
    out["ens fwd trio"] = timings(lambda: fused_mlp.fused_apply_ensemble(ens, kps, lo, hvxs), (10, 20))
    plan = fused_mlp.pack_bwd_program(ens, kps, nr * coarse_ns)
    out["ens bwd trio"] = timings(lambda: fused_mlp.fused_ens_bwd(ens, kps, lo, hvxs, edp), (5,), plan)
    out["ens fwd trio"]["plain_ms"] = chip_smoke.cuda_time_ms(
        lambda: fused_mlp.fused_apply_ensemble_reference(ens, kps, lo, hvxs), iters=3)
    out["ens bwd trio"]["plain_ms"] = chip_smoke.cuda_time_ms(
        lambda: fused_mlp.fused_ens_bwd_reference(ens, kps, lo, hvxs, edp), iters=2)
    library(out["ens bwd trio"], "fused_mlp_ens_bwd", plan, nr * coarse_ns, coarse_ns)
    del ens, kps, lo, hvxs, edp, plan

    serve = chip_smoke.kernel_operands(MLPConfig(), chip_smoke.CHUNK_RAYS, 192, cd, seed=192)
    for _ in range(3):
        fused_mlp.fused_apply(*serve)
    out["fwd fine seed 3, after serving chunks"] = timings(lambda: fused_mlp.fused_apply(*ops), (10, 20))
    out["fwd fine seed 192, after serving chunks"] = timings(lambda: fused_mlp.fused_apply(*alt),
                                                            (10, 20))
    del ops, alt, dp, serve
    torch.cuda.empty_cache()
    if args.step:
        with tempfile.TemporaryDirectory() as tmp:
            work = Path(tmp)
            out["frame"] = chip_smoke.frame_time(work, args.dtype)
            out["step"] = chip_smoke.step_time(work / "db", dname=args.dtype)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
