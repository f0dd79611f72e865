#!/usr/bin/env python3
"""Chip smoke for simplenerf_torch: train and serve the published SimpleNeRF on one CUDA card.

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, in order (any failure raises and the script exits non-zero
without a result):
  1. device: the card's name and power limit, as nvidia-smi reports them;
  2. build: compile every CUDA source with nvcc, one process per source,
     all started together, and print each kernel's ptxas registers and
     spill bytes;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the published width (8x256 trunk, 1x128 views, PE 10/4), for the main,
     points-augmentation, Lambertian and visibility-head MLPs, 64 and 192
     samples per ray, float32 and bfloat16, on 1037 rays: the forward's
     planes, and the backward's every dW, db and dhvx; the coarse trio
     through the ensemble kernels, forward and backward, at 1037 x 64;
     then all of them at the training step's shapes (4096 x 64 trio,
     4096 x 192 main);
  4. serve: a seeded synthetic scene (189x252, 6 frames, 3 for training),
     the published bf16 recipe with seeded random weights in a checkpoint,
     `runner.start_testing` over its test frames, then one 756x1008 request
     through `Tester.predict_frame`; the launch counters must show the
     kernel served every chunk, and a 4096-ray crop of the frame is held
     against the plain path;
  5. train: on the same scene, the published bf16 recipe with the
     consistency ramp at 10 so that all nine losses carry weight,
     `runner.start_training` for 40 steps: a checkpoint and
     logs/scalars.jsonl appear, every loss is finite, MSE01 falls, and the
     launch counters show one ensemble forward, one ensemble backward, one
     forward and one backward per step; then one step's parameter
     gradients through the kernels against the plain versions swapped in
     (same params, batch and draws), in float32 and bfloat16;
  6. chunks: the forward kernel at the chunk shapes serving gives it (64k
     rays x 64 / 192 samples for the 756x1008 frame, one test frame's
     chunk, and a 41,152-ray chunk), held against its plain version; at the
     64k shapes it is also timed with CUDA events after warm-up, beside the
     plain version and the card's bound;
  7. timing: each kernel at the training step's shapes (CUDA events after
     warm-up) beside its plain version and its bound, each backward's row
     pass, weight pass and column sums apart and each of its three column
     sums apart (torch.profiler's kernel events); for each backward the
     weight pass's bound from the distinct stash slots it reads (beside
     its FLOP bound), the stash bytes its producers issue, per-dW
     torch.matmul on a seeded stash of the step's shape and torch.sum at
     each column sum's shape; seconds per training step (median of 40
     after 3 of warm-up), rays/s, and a torch.profiler breakdown of the
     step's device time by kernel.
The last line is {"ok": true, "device": {...}}; the line before it holds the
per-kernel JSON (a backward's row also has row_ms, weight_ms, sums_ms,
sums_parts_ms (partials, dW partials, dhvx), weight_library_ms and
sums_library_ms (measured; the weight pass's and column sums' bounds are
printed on its `time` lines), its bf16 row kernel's ptxas registers and
spill bytes, row_ptxas, and the weight kernel's, weight_ptxas; a
forward's row has its bf16 kernel's ptxas, fwd_ptxas, and the share of
its bound, bound_share = bound_ms / ms; the serving chunks carry the
same). A
forward's `time` line also counts the weight bytes its producer issues
per launch (blocks x the packed slab image), and a backward's the stash
bytes its weight pass's producers issue: counts, not readings of the
card's traffic.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (dense): tensor-core bf16 and CUDA-core
# float32 rates, and HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
CHUNK_RAYS = 64 * 1024
# Kernel vs plain version on the same inputs: max abs error over the raw
# head planes, which are a few 1e-2 in size at this seeded init. float32
# differs only in summation order; in bf16 an order difference can flip one
# bf16 rounding of an activation (2^-8 relative), which propagates. Each
# limit is a few times the largest sound reading; every broken variant of
# tools/probe_fused_mlp.py reads above it (readings in PERF.md).
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 2e-3}
# Served crop vs the plain path, max abs error: rgb and acc per ray, sigma
# and rgb per sample (a wrong plane at a sample of little weight shows only
# there), and NDC depth, a ratio sum(w z) / (acc + 1e-6), on the rays whose
# acc reaches ACC_FLOOR: on emptier rays a sigma at the ReLU's edge switches
# a ray between empty (depth 0) and one sample's depth. At this seeded init
# the coarse level's acc is ~0.06 and the fine level's is below 1e-3.
CROP_TOL = 1e-3
ACC_FLOOR = 1e-3
# Backward kernels vs plain versions: each gradient tensor's error as a
# norm, ||got - want|| / ||want||, with one limit for the weights (every dW
# and db, sums over all rows) and one for dhvx (per-ray sums over ns rows).
# The two versions sum in other orders, so an activation within rounding of
# 0 can fall on the other side of the ReLU and change that row's whole
# cotangent below it (tools/probe_fused_mlp_bwd.py counts these flips and
# shows they account for the float32 difference); a norm over the whole
# tensor keeps one row small, where a largest-entry error does not. Sound
# readings at most 9.8e-4 / 1.8e-4 (float32 weights / dhvx) and 5.6e-3 /
# 2.6e-3 (bf16); a kernel that drops the ragged last 64 rows from dW reads
# 2.5e-2 and more (PERF.md).
GRAD_TOL = {"float32": {"weights": 3e-3, "dhvx": 1e-3},
            "bfloat16": {"weights": 1.2e-2, "dhvx": 8e-3}}
# One training step through the kernels vs through the plain versions:
# every parameter's gradient, max abs error relative to its largest value.
# The fine samples depend on the coarse weights, so the two runs' inputs
# drift apart with the coarse kernels' rounding (readings: PERF.md).
STEP_TOL = {"float32": 5e-4, "bfloat16": 1e-2}
STEP_RAYS, COARSE_NS, FINE_NS = 4096, 64, 192


def fail(msg: str):
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from nvcc's
    -Xptxas -v output (bytes of spill stores and loads)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, {}).update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m[1])
    return out


def kernel_label(entry: str) -> str:
    """A mangled kernel entry's name and operand type, e.g. 'fused_mlp_bwd_rows_kernel bf16':
    the first of its length-prefixed names that ends in _kernel, and the template argument."""
    pos = entry.find("_ZN") + 3
    while (m := re.match(r"\d+", entry[pos:])) and pos > 2:
        start = pos + len(m[0])
        pos = start + int(m[0])
        if entry[start:pos].endswith("_kernel"):
            rest = entry[pos:]
            return entry[start:pos] + (" bf16" if rest.startswith("I13__nv_bfloat16") else
                                       " f32" if rest.startswith("If") else "")
    return entry


def cuda_time_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_operands(cfg, nr, ns, dtype, seed):
    """Seeded parameters and inputs of one fused evaluation, on the card."""
    import torch

    from simplenerf_torch.fields import mlp

    g = torch.Generator().manual_seed(seed)
    params = mlp.init(g, cfg, device="cuda")
    pts = (torch.rand((nr * ns, 3), generator=g) * 2 - 1).cuda()
    dirs = torch.nn.functional.normalize(torch.randn((nr, 3), generator=g), dim=-1).cuda()
    return mlp.fused_operands(params, cfg, pts, dirs, ns, dtype)


def check_planes(label: str, dname: str, got, want, kernel: str = "fused_mlp_fwd") -> float:
    """Max abs error of the kernel's planes against the plain version's; fails past KERNEL_TOL."""
    import torch

    err = torch.stack([(a - b).abs().max() for a, b in zip(got, want)]).nan_to_num(float("inf"))
    err = err.max().item()
    scale = max(b.abs().max().item() for b in want)
    print(f"kernel {kernel} {label} {dname}: max abs err {err:.3e} "
          f"(tol {KERNEL_TOL[dname]:g}; planes up to {scale:.3e})", flush=True)
    if not err <= KERNEL_TOL[dname]:
        fail(f"{kernel} disagrees with its plain version: {label} {dname}")
    return err


PUBLISHED = {
    "main": {},
    "points_aug": {"points_sigma_pe_degree": 3},
    "lambertian": {"use_view_dirs": False, "view_dependent_rgb": False},
    "visibility": {"predict_visibility": True},
}
TRIO = ("main", "points_aug", "lambertian")


def dname_of(dtype) -> str:
    import torch

    return "bfloat16" if dtype == torch.bfloat16 else "float32"


def rel_err(got, want) -> float:
    """Max abs error relative to the plain version's largest value."""
    err = (got.float() - want.float()).abs().max().nan_to_num(float("inf")).item()
    return err / max(want.abs().max().item(), 1e-30)


def norm_err(got, want) -> float:
    """||got - want|| / ||want|| in float64; inf where got is not finite."""
    err = (got.double() - want.double()).norm().nan_to_num(float("inf")).item()
    return err / max(want.double().norm().item(), 1e-30)


def grad_group(key: str) -> str:
    return "dhvx" if "dhvx" in key else "weights"


def check_grads(kernel: str, label: str, dname: str, got: dict, want: dict) -> dict:
    """Norm errors of the gradients against GRAD_TOL, by group; fails past
    it. Returns the worst norm error and the worst largest-entry error."""
    errs = {k: norm_err(got[k], want[k]) for k in want}
    for group, tol in GRAD_TOL[dname].items():
        mine = {k: e for k, e in errs.items() if grad_group(k) == group}
        if not mine:
            continue
        worst = max(mine, key=mine.get)
        print(f"kernel {kernel} {label} {dname} {group}: worst norm err {mine[worst]:.3e} "
              f"({worst}; tol {tol:g}), median {statistics.median(mine.values()):.3e} over "
              f"{len(mine)} gradients", flush=True)
        if not mine[worst] <= tol:
            fail(f"{kernel} disagrees with its plain version: {label} {dname} {worst}")
    return {"norm": max(errs.values()), "max_rel": max(rel_err(got[k], want[k]) for k in want)}


def cotangents(n_planes: int, nr: int, ns: int, seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((n_planes, nr, ns), generator=g, device="cuda")


def ensemble_operands(nr: int, ns: int, dtype, seed: int):
    """Seeded coarse trio (published widths) and inputs on the card."""
    import torch

    from simplenerf_torch.fields import mlp

    g = torch.Generator().manual_seed(seed)
    members = []
    for name in TRIO:
        cfg = mlp.MLPConfig(**PUBLISHED[name])
        members.append((mlp.init(g, cfg, device="cuda"), cfg))
    pts = (torch.rand((nr * ns, 3), generator=g) * 2 - 1).cuda()
    dirs = torch.nn.functional.normalize(torch.randn((nr, 3), generator=g), dim=-1).cuda()
    return mlp.ensemble_operands(members, pts, dirs, ns, dtype)


def single_check(name: str, nr: int, ns: int, dtype) -> dict:
    """Forward and backward kernels of one MLP vs their plain versions."""
    from simplenerf_torch.fields.mlp import MLPConfig
    from simplenerf_torch.ops import fused_mlp

    dname = dname_of(dtype)
    ops = kernel_operands(MLPConfig(**PUBLISHED[name]), nr, ns, dtype, seed=len(name) + ns)
    spec = ops[0]
    label = f"{name} {nr} rays x {ns}"
    fwd = check_planes(label, dname, fused_mlp.fused_apply(*ops), fused_mlp.fused_apply_reference(*ops))
    dp = cotangents(spec.n_planes, nr, ns, seed=ns)
    dkp, dhvx = fused_mlp.fused_bwd(*ops, dp)
    want, want_hvx = fused_mlp.fused_bwd_reference(*ops, dp)
    if spec.has_hvx:
        dkp, want = {**dkp, "dhvx": dhvx}, {**want, "dhvx": want_hvx}
    bwd = check_grads("fused_mlp_bwd", label, dname, dkp, want)
    return {"fwd": fwd, "bwd": bwd}


def ensemble_check(nr: int, ns: int, dtype) -> dict:
    from simplenerf_torch.ops import fused_mlp

    dname = dname_of(dtype)
    ens, kps, lo, hvxs = ensemble_operands(nr, ns, dtype, seed=nr + ns)
    label = f"trio {nr} rays x {ns}"
    got = fused_mlp.fused_apply_ensemble(ens, kps, lo, hvxs)
    want = fused_mlp.fused_apply_ensemble_reference(ens, kps, lo, hvxs)
    fwd = check_planes(label, dname, got, want, kernel="fused_mlp_ens_fwd")
    dp = cotangents(ens.n_planes, nr, ns, seed=ns + 1)
    dkps, dhvxs = fused_mlp.fused_ens_bwd(ens, kps, lo, hvxs, dp)
    wkps, whvxs = fused_mlp.fused_ens_bwd_reference(ens, kps, lo, hvxs, dp)
    got_all, want_all = {}, {}
    for name, a, b in zip(TRIO, dkps, wkps):
        got_all.update({f"{name}.{k}": v for k, v in a.items()})
        want_all.update({f"{name}.{k}": v for k, v in b.items()})
    for i, (a, b) in enumerate(zip(dhvxs, whvxs)):
        got_all[f"dhvx{i}"], want_all[f"dhvx{i}"] = a, b
    bwd = check_grads("fused_mlp_ens_bwd", label, dname, got_all, want_all)
    return {"fwd": fwd, "bwd": bwd}


def check_train_kernels() -> dict:
    """Every kernel, forward and gradients, at the published width: 1037
    rays for each MLP kind, then the training step's shapes. Returns the
    worst errors by kernel and dtype; the launches made here are not the
    main path's."""
    import torch

    from simplenerf_torch.ops import fused_mlp

    saved = {f: f.launches for f in (fused_mlp.fused_apply, fused_mlp.fused_bwd,
                                     fused_mlp.fused_apply_ensemble, fused_mlp.fused_ens_bwd)}
    worst: dict = {}  # (kernel, dtype name, "err" | "norm") -> worst reading

    def keep(kernel, dtype, e):
        errs = {"err": e} if isinstance(e, float) else {"err": e["max_rel"], "norm": e["norm"]}
        for what, err in errs.items():
            key = (kernel, dname_of(dtype), what)
            worst[key] = max(worst.get(key, 0.0), err)

    for dtype in (torch.float32, torch.bfloat16):
        for name in PUBLISHED:
            for ns in (COARSE_NS, FINE_NS):
                e = single_check(name, 1037, ns, dtype)
                keep("fused_mlp_fwd", dtype, e["fwd"])
                keep("fused_mlp_bwd", dtype, e["bwd"])
        for nr, ns in ((1037, COARSE_NS), (STEP_RAYS, COARSE_NS)):
            e = ensemble_check(nr, ns, dtype)
            keep("fused_mlp_ens_fwd", dtype, e["fwd"])
            keep("fused_mlp_ens_bwd", dtype, e["bwd"])
        e = single_check("main", STEP_RAYS, FINE_NS, dtype)
        keep("fused_mlp_fwd", dtype, e["fwd"])
        keep("fused_mlp_bwd", dtype, e["bwd"])
        torch.cuda.empty_cache()
    for f, n in saved.items():
        f.launches = n
    return worst


@contextlib.contextmanager
def plain_versions():
    """The four kernels' plain versions in place of their launches."""
    import torch

    from simplenerf_torch.ops import fused_mlp as fm

    saved = (fm._fwd, fm.fused_bwd, fm._ens_fwd, fm.fused_ens_bwd)
    fm._fwd = lambda *a: torch.stack(fm.fused_apply_reference(*a))
    fm.fused_bwd = fm.fused_bwd_reference
    fm._ens_fwd = lambda *a: torch.stack(fm.fused_apply_ensemble_reference(*a))
    fm.fused_ens_bwd = fm.fused_ens_bwd_reference
    try:
        yield
    finally:
        fm._fwd, fm.fused_bwd, fm._ens_fwd, fm.fused_ens_bwd = saved


def train_config(**overrides) -> dict:
    """The published bf16 recipe on the synthetic scene, consistency from step 10."""
    from simplenerf_torch.drivers import presets

    kw = dict(compute_dtype="bfloat16", scene_id="blobs", consistency_start_iter=10,
              num_iterations=40)
    kw.update(overrides)
    cfg = presets.simplenerf_config(**kw)
    cfg["log_interval"] = 10
    return cfg


def train(work: Path, db: Path) -> dict:
    """The training path through `runner.start_training`; returns its launches."""
    import numpy as np
    import torch

    from simplenerf_torch.drivers import runner
    from simplenerf_torch.ops import fused_mlp

    cfg = train_config()
    steps = cfg["num_iterations"]
    counters = (fused_mlp.fused_apply_ensemble, fused_mlp.fused_ens_bwd, fused_mlp.fused_apply,
                fused_mlp.fused_bwd)
    # The main path: counters at 0 just before, read just after.
    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    run_dir = runner.start_training(cfg, db, work / "runs")
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in counters}
    print(f"train: start_training, {steps} steps of the published bf16 recipe in {t_train:.1f} s "
          f"incl. set-up; launches {launches}", flush=True)
    if any(n != steps for n in launches.values()):
        fail(f"expected {steps} launches of each kernel, got {launches}")
    scene = run_dir / "blobs"
    if not (scene / f"saved_models/Model_Iter{steps:06}.msgpack").exists():
        fail("no checkpoint after training")
    rows = [json.loads(line) for line in (scene / "logs/scalars.jsonl").read_text().splitlines()]
    losses = [k for k in rows[-1] if k not in ("iter", "time", "lr", "rays_per_s")]
    for r in rows:
        print("train: " + ", ".join(f"{k} {r[k]:.4g}" for k in ["iter"] + losses), flush=True)
    if len(losses) != 10 or not all(np.isfinite(r[k]) for r in rows for k in losses):
        fail(f"losses missing or not finite: {losses}")
    if not rows[-1]["MSE01"] < rows[0]["MSE01"]:
        fail("MSE01 did not fall during training")
    return {"launches": launches, "s": t_train, "run_dir": run_dir}


def step_gradients(db: Path, dtype_name: str) -> float:
    """One training step's parameter gradients through the kernels and
    through the plain versions, from the same params, batch and draws."""
    import torch

    from simplenerf_torch.data.factory import get_data_loader
    from simplenerf_torch.data.preprocessor import ScenePreprocessor
    from simplenerf_torch.training.trainer import Trainer

    cfg = train_config(compute_dtype=dtype_name)
    cfg["resume_training"] = False
    raw = get_data_loader(cfg, db, "train").load_data()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(cfg, Path(tmp), ScenePreprocessor(cfg, "train", raw))
        it = 20  # the consistency losses carry weight
        idx = trainer.train_pp.next_indices(it)

        def grads():
            for p in trainer.leaves:
                p.grad = None
            total, _ = trainer.loss(trainer.batch(*idx), it, generator=trainer.step_generator(it))
            total.backward()
            return [p.grad.clone() for p in trainer.leaves]

        kern = grads()
        with plain_versions():
            plain = grads()
    errs = [rel_err(a, b) for a, b in zip(kern, plain)]
    worst = max(errs)
    names = leaf_paths(trainer.params)
    print(f"step gradients {dtype_name}: kernels vs plain versions, worst rel err {worst:.3e} "
          f"({names[errs.index(worst)]} of {len(errs)} tensors; tol {STEP_TOL[dtype_name]:g}); "
          f"median {statistics.median(errs):.3e}", flush=True)
    if not worst <= STEP_TOL[dtype_name]:
        fail(f"a training step's gradients disagree with the plain versions ({dtype_name})")
    return worst


def leaf_paths(tree, prefix: str = "") -> list:
    """Names of a params tree's leaves in `checkpoints.flat_leaves` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_paths(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_paths(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def bwd_pass_ms(fn, calls: int = 3, sums=(1, 1, 1)) -> dict:
    """Device time per call of a backward kernel's three passes (row pass,
    weight pass, column sums), from torch.profiler's kernel events over
    `calls` calls after one warm-up. `sums`: the launches of each of the
    three column sums (partials, dW partials, dhvx) in a call, in launch
    order (two where a sum is split into slices); sums_parts_ms gives each
    sum apart, sums_ms their total."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {"row_ms": 0.0, "weight_ms": 0.0, "sums_ms": 0.0}
    parts = {"fused_mlp_bwd_rows_kernel": "row_ms", "fused_mlp_bwd_wgrad_kernel": "weight_ms",
             "fused_mlp_bwd_weights_kernel": "weight_ms", "colsum_kernel": "sums_ms"}
    colsums = []
    for e in prof.events():
        key = next((v for k, v in parts.items() if k in e.name), None)
        if e.device_type == DeviceType.CUDA and key:
            ms = e.time_range.elapsed_us() / 1e3
            out[key] += ms / calls
            if key == "sums_ms":
                colsums.append((e.time_range.start, ms))
    colsums = [ms for _, ms in sorted(colsums)]
    if len(colsums) == calls * sum(sums):  # else the profiler lost events: no split
        owner = [i for i, n in enumerate(sums) for _ in range(n)] * calls
        out["sums_parts_ms"] = [sum(ms for o, ms in zip(owner, colsums) if o == i) / calls
                                for i in range(len(sums))]
    return out


def slab_gb(spec, rows: int) -> float:
    """GB of weight slabs one bf16 forward launch issues: every 128-row block
    copies the whole packed slab image once. A count of what the producer
    asks for, not a measurement of L2 traffic."""
    from simplenerf_torch.ops import fused_mlp

    return -(-rows // 128) * fused_mlp.sm90_plan(spec).w_index.size * 2 / 1e9


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def weight_pass_yardsticks(label: str, plan, rows: int, sum_shapes) -> dict:
    """The backward's weight pass and column sums against what the card and
    PyTorch would take for the same work, on a seeded stash of the step's
    shape: the weight pass's bounds (the distinct stash slots it reads,
    each once, over HBM's rate; its FLOP over the bf16 peak), the stash
    bytes its producers issue (a count from the plan), one torch.matmul of
    the two slots per dW (N calls), and torch.sum at each column sum's
    shape (the same function, one call each)."""
    import torch

    maps = plan.maps
    used = {int(j[m]) for j in plan.tasks.tolist() for m in (1, 4)}  # each job's A and G maps
    slot_bytes = sum(int(maps[m][1]) for m in used) * rows * 2
    flops = sum(2 * k * m * rows for *_, k, m, _off in plan.dws)
    g = torch.Generator(device="cuda").manual_seed(11)
    stash = torch.randn(plan.stash_cols * rows, generator=g, device="cuda").to(torch.bfloat16)

    def slot(c, w):
        return stash[c * rows : (c + w) * rows].view(rows, w)

    matmul_ms = cuda_time_ms(lambda: [torch.matmul(slot(a, aw).T, slot(gs, gw))
                                      for a, aw, gs, gw, *_ in plan.dws], iters=3)
    del stash
    sums_ms = []
    for S, L, C in sum_shapes:
        x = torch.randn((S, L, C), generator=g, device="cuda")
        sums_ms.append(cuda_time_ms(lambda: torch.sum(x, dim=1), iters=10))
        del x
    torch.cuda.empty_cache()
    out = {"weight_bytes_gb": slot_bytes / 1e9, "weight_issued_gb": plan.wgrad_bytes / 1e9,
           "weight_bound_ms": 1e3 * slot_bytes / PEAK_BYTES,
           "weight_flop_bound_ms": 1e3 * flops / PEAK_FLOPS["bfloat16"],
           "weight_library_ms": matmul_ms, "weight_library_calls": len(plan.dws),
           "sums_library_ms": sums_ms,
           "sums_bound_ms": [1e3 * 4 * S * C * (L + 1) / PEAK_BYTES for S, L, C in sum_shapes]}
    print(f"time {label} weight pass yardsticks: {out['weight_bytes_gb']:.2f} GB of distinct stash "
          f"slots, bound {out['weight_bound_ms']:.3f} ms (bytes; FLOP {out['weight_flop_bound_ms']:.3f} "
          f"ms); {out['weight_issued_gb']:.2f} GB issued by its producers (a count from the plan); "
          f"torch.matmul per dW ({len(plan.dws)} calls) {matmul_ms:.3f} ms; column sums at "
          + ", ".join(f"{S}x{L}x{C}" for S, L, C in sum_shapes) + ": torch.sum "
          + ", ".join(f"{ms:.3f}" for ms in sums_ms) + " ms, bounds "
          + ", ".join(f"{ms:.3f}" for ms in out["sums_bound_ms"]) + " ms", flush=True)
    return out


def _sum_shapes(plan, rows: int, ns: int) -> list:
    """(S, L, C) of a backward's three column sums: partials, dW partials, dhvx."""
    return [(1, -(-rows // 128), plan.part_w), (1, plan.n_chunks, plan.dw_total),
            (plan.n_hvx * (rows // ns), ns, plan.hvx_w)]


def time_train_kernels() -> dict:
    """Each kernel at the training step's shapes (bf16), CUDA events after
    warm-up, beside its plain version and its bound; each backward's passes
    (profiler) beside the weight pass's and column sums' yardsticks."""
    import torch

    from simplenerf_torch.fields.mlp import MLPConfig
    from simplenerf_torch.ops import fused_mlp

    saved = {f: f.launches for f in (fused_mlp.fused_apply, fused_mlp.fused_bwd,
                                     fused_mlp.fused_apply_ensemble, fused_mlp.fused_ens_bwd)}
    out = {}
    bf16 = torch.bfloat16

    def wbytes(kps):
        return sum(v.numel() for kp in kps for v in kp.values()) * 2

    def sum_launches(plan):
        return tuple(2 if n > 1 else 1 for n in plan.slices)

    # Fine: one MLP, 4096 x 192.
    spec, kp, lo, hi, hvx = ops = kernel_operands(MLPConfig(), STEP_RAYS, FINE_NS, bf16, seed=3)
    rows = lo.shape[0]
    dp = cotangents(spec.n_planes, STEP_RAYS, FINE_NS, seed=4)
    plan = fused_mlp.pack_bwd_program(spec, kp, rows)
    io = lo.numel() * 2 + hvx.numel() * 4
    b_fwd = bound_ms(spec.flops_per_point() * rows, io + wbytes([kp]) + dp.numel() * 4)
    b_bwd = bound_ms(spec.bwd_flops_per_point() * rows,
                     io + wbytes([kp]) + dp.numel() * 4 + wbytes([kp]) * 2 + hvx.numel() * 4)
    out["fused_mlp_fwd"] = dict(
        shape=f"fine step: {STEP_RAYS} rays x {FINE_NS} = {rows} points, bf16",
        ms=cuda_time_ms(lambda: fused_mlp.fused_apply(*ops), iters=10),
        plain_ms=cuda_time_ms(lambda: fused_mlp.fused_apply_reference(*ops), iters=3),
        bound_ms=b_fwd[0], bound_by=b_fwd[1], slab_gb=slab_gb(spec, rows))
    out["fused_mlp_bwd"] = dict(
        shape=f"fine step: {STEP_RAYS} rays x {FINE_NS} = {rows} points, bf16",
        ms=cuda_time_ms(lambda: fused_mlp.fused_bwd(*ops, dp), iters=5),
        plain_ms=cuda_time_ms(lambda: fused_mlp.fused_bwd_reference(*ops, dp), iters=2),
        bound_ms=b_bwd[0], bound_by=b_bwd[1],
        **bwd_pass_ms(lambda: fused_mlp.fused_bwd(*ops, dp), sums=sum_launches(plan)))
    del ops, lo, hi, hvx, kp, dp
    torch.cuda.empty_cache()
    out["fused_mlp_bwd"]["yardsticks"] = weight_pass_yardsticks(
        "fused_mlp_bwd", plan, rows, _sum_shapes(plan, rows, FINE_NS))
    del plan

    # Coarse: the trio through the ensemble, 4096 x 64.
    ens, kps, lo, hvxs = ensemble_operands(STEP_RAYS, COARSE_NS, bf16, seed=5)
    rows = lo.shape[0]
    dp = cotangents(ens.n_planes, STEP_RAYS, COARSE_NS, seed=6)
    plan = fused_mlp.pack_bwd_program(ens, kps, rows)
    io = lo.numel() * 2 + sum(h.numel() for h in hvxs) * 4
    b_fwd = bound_ms(ens.flops_per_point() * rows, io + wbytes(kps) + dp.numel() * 4)
    b_bwd = bound_ms(ens.bwd_flops_per_point() * rows,
                     io + wbytes(kps) + dp.numel() * 4 + wbytes(kps) * 2 + io - lo.numel() * 2)
    out["fused_mlp_ens_fwd"] = dict(
        shape=f"coarse trio step: {STEP_RAYS} rays x {COARSE_NS} = {rows} points, bf16",
        ms=cuda_time_ms(lambda: fused_mlp.fused_apply_ensemble(ens, kps, lo, hvxs), iters=10),
        plain_ms=cuda_time_ms(lambda: fused_mlp.fused_apply_ensemble_reference(ens, kps, lo, hvxs),
                              iters=3),
        bound_ms=b_fwd[0], bound_by=b_fwd[1], slab_gb=slab_gb(ens, rows))
    out["fused_mlp_ens_bwd"] = dict(
        shape=f"coarse trio step: {STEP_RAYS} rays x {COARSE_NS} = {rows} points, bf16",
        ms=cuda_time_ms(lambda: fused_mlp.fused_ens_bwd(ens, kps, lo, hvxs, dp), iters=5),
        plain_ms=cuda_time_ms(lambda: fused_mlp.fused_ens_bwd_reference(ens, kps, lo, hvxs, dp),
                              iters=2),
        bound_ms=b_bwd[0], bound_by=b_bwd[1],
        **bwd_pass_ms(lambda: fused_mlp.fused_ens_bwd(ens, kps, lo, hvxs, dp),
                      sums=sum_launches(plan)))
    del ens, kps, lo, hvxs, dp
    torch.cuda.empty_cache()
    out["fused_mlp_ens_bwd"]["yardsticks"] = weight_pass_yardsticks(
        "fused_mlp_ens_bwd", plan, rows, _sum_shapes(plan, rows, COARSE_NS))
    del plan
    for name, r in out.items():
        l2 = f", {r['slab_gb']:.2f} GB of weight slabs issued" if "slab_gb" in r else ""
        passes = ""
        if "row_ms" in r:
            parts = r.get("sums_parts_ms")
            split = (" (partials, dW partials, dhvx " + ", ".join(f"{ms:.3f}" for ms in parts) + ")"
                     if parts else "")
            passes = (f" (row pass {r['row_ms']:.3f}, weight pass {r['weight_ms']:.3f}, column sums "
                      f"{r['sums_ms']:.3f}{split} ms, profiler)")
        print(f"time {name} ({r['shape']}): kernel {r['ms']:.3f} ms{passes}, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}){l2}", flush=True)
    for f, n in saved.items():
        f.launches = n
    return out


def step_time(db: Path, warmup: int = 3, steps: int = 40) -> dict:
    """Seconds per training step of the published bf16 recipe (host clock
    around each step ending in a synchronisation; median after warm-up)."""
    import torch

    from simplenerf_torch.data.factory import get_data_loader
    from simplenerf_torch.data.preprocessor import ScenePreprocessor
    from simplenerf_torch.ops import fused_mlp
    from simplenerf_torch.training.trainer import Trainer

    saved = {f: f.launches for f in (fused_mlp.fused_apply, fused_mlp.fused_bwd,
                                     fused_mlp.fused_apply_ensemble, fused_mlp.fused_ens_bwd)}
    cfg = train_config()
    cfg["resume_training"] = False
    raw = get_data_loader(cfg, db, "train").load_data()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(cfg, Path(tmp), ScenePreprocessor(cfg, "train", raw))
        times = []
        torch.cuda.reset_peak_memory_stats()
        for it in range(warmup + steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_one_iter(it)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        busy = profile_steps(trainer, warmup + steps, 3)
    for f, n in saved.items():
        f.launches = n
    s = statistics.median(times[warmup:])
    rays = trainer.train_pp.num_rays + trainer.train_pp.num_rays_sparse_depth
    print(f"train step: median {s * 1e3:.2f} ms over {steps} steps after {warmup} warm-up "
          f"(min {min(times[warmup:]) * 1e3:.2f}, max {max(times[warmup:]) * 1e3:.2f}); "
          f"{rays / s:.0f} rays/s; device busy {100 * busy['device_ms_per_step'] / (s * 1e3):.1f} % "
          f"of the median step; peak device memory {peak_gb:.2f} GiB", flush=True)
    return {"s_per_step": s, "rays_per_s": rays / s, "peak_gb": peak_gb, **busy}


def profile_steps(trainer, start: int, steps: int) -> dict:
    """Device time by kernel over `steps` training steps (torch.profiler's
    CUDA kernel events; the profiler's own host cost makes its wall clock
    no step time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for it in range(start, start + steps):
            trainer.train_one_iter(it)
        torch.cuda.synchronize()
    kernels: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = kernels.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3 / steps
            row[1] += 1
    rows = sorted(((ms, n // steps, name) for name, (ms, n) in kernels.items()), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"profile: device kernel time per training step {busy_ms:.2f} ms over {steps} steps, "
          f"{sum(r[1] for r in rows)} kernels per step; by kernel:", flush=True)
    for ms, n, name in rows[:20]:
        print(f"profile:   {ms:9.3f} ms  x{n:<5d} {name[:110]}", flush=True)
    return {"device_ms_per_step": busy_ms, "kernels_per_step": sum(r[1] for r in rows)}


def make_scene(work: Path, h: int, w: int):
    """The seeded synthetic scene (h x w, 6 frames, 3 for training; bench.py's
    size), Configs.json for the published bf16 recipe, the train-mode
    ModelConfigs.json and a checkpoint of seeded random weights, under `work`.
    Returns (db, runs, run_dir, cfg, model_configs)."""
    import torch

    from simplenerf_torch import config
    from simplenerf_torch.data.factory import get_data_loader
    from simplenerf_torch.data.preprocessor import ScenePreprocessor
    from simplenerf_torch.data.synthetic import generate_scene
    from simplenerf_torch.drivers import presets
    from simplenerf_torch.render import renderer
    from simplenerf_torch.training import checkpoints

    db, runs = work / "db", work / "runs"
    generate_scene(db, scene_name="blobs", num_frames=6, h=h, w=w, num_train=3, seed=0)
    cfg = presets.simplenerf_config(compute_dtype="bfloat16", scene_id="blobs")
    run_dir = runs / "training/train0000"
    config.save_configs(run_dir, cfg)
    raw = get_data_loader(cfg, db, "train").load_data()
    mc = ScenePreprocessor(cfg, "train", raw).get_model_configs()
    (run_dir / "blobs").mkdir(parents=True, exist_ok=True)
    (run_dir / "blobs/ModelConfigs.json").write_text(json.dumps(mc, indent=2))
    render_cfg = config.render_config_from_dict(cfg)
    params = renderer.init(torch.Generator().manual_seed(0), render_cfg)
    checkpoints.save_checkpoint(run_dir / "blobs/saved_models", 0, params)
    return db, runs, run_dir, cfg, mc


def large_request(db: Path, run_dir: Path, cfg: dict, mc: dict, scale: int):
    """A tester of the scene whose resolution is `scale` times larger on each
    side, intrinsic scaled to match, and the first test pose: (tester, pose, K)."""
    import numpy as np

    from simplenerf_torch.data.factory import get_data_loader
    from simplenerf_torch.drivers import runner

    tester = runner.load_scene_tester(run_dir, "blobs", {})
    h, w = mc["resolution"]
    K = np.asarray(mc["intrinsic"], np.float64)
    K[:2] *= scale
    tester.preprocessor.model_configs = {**mc, "resolution": [h * scale, w * scale], "intrinsic": K.tolist()}
    pose = get_data_loader(cfg, db, "test").load_data()["nerf_data"]["extrinsics"][0]
    return tester, pose, K


def center_crop(tester, pose, K, c: int = 64):
    """The rays of the c x c pixels at the frame's centre: (rays, ys, xs)."""
    import numpy as np
    import torch

    H, W = tester.preprocessor.model_configs["resolution"]
    batch = tester.preprocessor.create_test_data(pose, intrinsic=K)
    ys, xs = np.meshgrid(np.arange(H // 2, H // 2 + c), np.arange(W // 2, W // 2 + c), indexing="ij")
    idx = torch.as_tensor((ys * W + xs).ravel(), device=batch["rays_o"].device)
    return {k: v[idx] for k, v in batch.items()}, ys, xs


def crop_errors(tester, crop: dict) -> tuple[dict, dict]:
    """The crop rendered through the kernel and through the plain version
    (fused_apply_reference in place of the wrapper). Returns (max abs
    errors by quantity, the kernel path's outputs) and prints each level's
    acc and its largest depth errors."""
    import torch

    from simplenerf_torch.ops import fused_mlp
    from simplenerf_torch.render import renderer

    def render():
        return renderer.render_rays(tester.params, tester.render_cfg, crop, retraw=True)

    with torch.no_grad():
        kern = render()
        wrapper = fused_mlp.fused_apply
        fused_mlp.fused_apply = fused_mlp.fused_apply_reference
        try:
            plain = render()
        finally:
            fused_mlp.fused_apply = wrapper
    err, n_lit = {}, 0
    for level in ("coarse", "fine"):
        for q in ("rgb", "acc", "raw_sigma", "raw_rgb"):
            err[f"{q}_{level}"] = (kern[f"{q}_{level}"] - plain[f"{q}_{level}"]).abs().max().item()
        acc = plain[f"acc_{level}"]
        d = (kern[f"depth_ndc_{level}"] - plain[f"depth_ndc_{level}"]).abs()
        lit = acc >= ACC_FLOOR
        n_lit += int(lit.sum())
        if lit.any():
            err[f"depth_ndc_{level}"] = d[lit].max().item()
        qs = torch.quantile(acc.float(), torch.tensor([0.0, 0.5, 1.0], device=acc.device)).tolist()
        worst = torch.topk(d, 3).indices.tolist()
        print(f"crop {level}: acc min {qs[0]:.3e} median {qs[1]:.3e} max {qs[2]:.3e}, "
              f"{int(lit.sum())} rays with acc >= {ACC_FLOOR:g}; largest depth_ndc errors (acc: err) "
              + ", ".join(f"{acc[i].item():.3e}: {d[i].item():.3e}" for i in worst), flush=True)
    if not n_lit:
        fail(f"no ray of the crop reaches acc {ACC_FLOOR:g}: its depth is not compared")
    return {k: math.inf if math.isnan(v) else v for k, v in err.items()}, kern


def serve(work: Path, h: int = 189, w: int = 252, scale: int = 4) -> dict:
    """The serving path through the user's entry points; returns its measurements.

    The scene is h x w (bench.py's size); the single request is `scale`
    times larger on each side (756x1008, the LLFF _down4 frame)."""
    import numpy as np
    import torch

    from simplenerf_torch.data import io
    from simplenerf_torch.drivers import runner
    from simplenerf_torch.ops import fused_mlp

    t0 = time.perf_counter()
    db, runs, run_dir, cfg, mc = make_scene(work, h, w)
    print(f"serve: scene + checkpoint set up in {time.perf_counter() - t0:.1f} s", flush=True)

    # The main path: counters at 0 just before, read just after.
    fused_mlp.fused_apply.launches = 0
    t0 = time.perf_counter()
    rendered = runner.start_testing({"train_num": 0, "test_num": 0}, db, runs, run_qa=False)
    torch.cuda.synchronize()
    t_test = time.perf_counter() - t0
    test_launches = fused_mlp.fused_apply.launches
    frames = rendered["blobs"]
    per_frame = -(-(h * w) // CHUNK_RAYS)
    if len(frames) != 3 or test_launches != 2 * per_frame * len(frames):
        fail(f"start_testing rendered {frames} with {test_launches} kernel launches")
    for f in frames:
        img = io.read_image(runs / f"testing/test0000/blobs/predicted_frames/{f:04}.png")
        depth = np.load(runs / f"testing/test0000/blobs/predicted_depths_ndc/{f:04}.npy")
        if img.shape != (h, w, 3) or depth.shape != (h, w) or not np.isfinite(depth).all():
            fail(f"bad outputs for test frame {f}")
    print(f"serve: start_testing rendered frames {frames} ({h}x{w}) in {t_test:.2f} s, "
          f"{test_launches} kernel launches", flush=True)

    # One full-resolution request: the LLFF _down4 size.
    tester, pose, K = large_request(db, run_dir, cfg, mc, scale)
    H, W = h * scale, w * scale
    tester.predict_frame(pose, intrinsic=K)  # warm-up (allocator, library handles)
    torch.cuda.synchronize()
    before = fused_mlp.fused_apply.launches
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pred = tester.predict_frame(pose, intrinsic=K)
    torch.cuda.synchronize()
    t_frame = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    frame_launches = fused_mlp.fused_apply.launches - before
    launches = fused_mlp.fused_apply.launches
    chunks = -(-(H * W) // CHUNK_RAYS)
    if frame_launches != 2 * chunks:
        fail(f"the {H}x{W} request made {frame_launches} kernel launches, expected {2 * chunks}")
    if pred["image"].shape != (H, W, 3) or not all(
        np.isfinite(pred[k]).all() and pred[k].shape == (H, W) for k in ("depth", "depth_ndc", "depth_var")
    ):
        fail("bad outputs for the full-resolution request")
    print(f"serve: {H}x{W} request in {t_frame:.3f} s ({chunks} chunks, {frame_launches} kernel launches), "
          f"peak device memory {peak_gb:.2f} GiB", flush=True)

    # A 64x64 crop of that frame, rendered again through the kernel (it must
    # give the served pixels) and through the plain version.
    crop, ys, xs = center_crop(tester, pose, K)
    crop_err, kern = crop_errors(tester, crop)
    served_rgb = pred["image"][ys, xs].reshape(-1, 3).astype(np.float64)
    kern_rgb = np.clip(np.round(np.clip(kern["rgb_fine"].cpu().numpy(), 0, 1) * 255), 0, 255)
    if np.abs(served_rgb - kern_rgb).max() > 1:
        fail("the crop re-rendered through the kernel differs from the served frame")
    print(f"serve: {ys.size}-ray crop, kernel vs plain path, max err "
          + ", ".join(f"{k} {v:.3e}" for k, v in crop_err.items()) + f" (tol {CROP_TOL:g})", flush=True)
    if not max(crop_err.values()) <= CROP_TOL:
        fail("the served crop disagrees with the plain path")
    return {"launches": launches, "frame_s": t_frame, "test_s": t_test,
            "frames": len(frames), "crop_err": crop_err}


def chunk_kernels(test_rays: int) -> dict:
    """Kernel vs plain version at the chunk shapes serving gives it (bf16,
    published main MLP), then timed at the 756x1008 frame's two shapes.

    The frame's chunks are 64k rays (render_in_chunks pads the last one); a
    test frame's single chunk is `test_rays`; a 41,152-ray chunk (the
    frame's unpadded remainder) adds one more large shape."""
    import torch

    from simplenerf_torch.fields.mlp import MLPConfig
    from simplenerf_torch.ops import fused_mlp

    out = {"max_abs_err": 0.0}
    shapes = [("coarse", CHUNK_RAYS, 64), ("fine", CHUNK_RAYS, 192),
              ("test coarse", test_rays, 64), ("test fine", test_rays, 192), ("tail", 41152, 192)]
    saved = fused_mlp.fused_apply.launches
    for level, nr, ns in shapes:
        spec, kp, lo, hi, hvx = ops = kernel_operands(MLPConfig(), nr, ns, torch.bfloat16, seed=ns)
        err = check_planes(f"main {nr} rays x {ns}", "bfloat16",
                           fused_mlp.fused_apply(*ops), fused_mlp.fused_apply_reference(*ops))
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if nr != CHUNK_RAYS:
            continue
        rows = lo.shape[0]
        ms = cuda_time_ms(lambda: fused_mlp.fused_apply(*ops), iters=10)
        plain_ms = cuda_time_ms(lambda: fused_mlp.fused_apply_reference(*ops), iters=2)
        flops = spec.flops_per_point() * rows
        weights = sum(v.numel() for v in kp.values()) * 2  # read once, bf16
        nbytes = lo.numel() * lo.element_size() + hvx.numel() * 4 + weights + spec.n_planes * rows * 4
        bound_ms = 1e3 * max(flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES)
        out[level] = {
            "rows": rows, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flops / PEAK_FLOPS["bfloat16"] >= nbytes / PEAK_BYTES else "bytes",
            "tflops": flops / ms / 1e9,
        }
        print(f"time fused_mlp_fwd {level} chunk ({CHUNK_RAYS} rays x {ns}, {rows} points, bf16): "
              f"kernel {ms:.3f} ms ({out[level]['tflops']:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.3f} ms; {slab_gb(spec, rows):.2f} GB of weight slabs issued",
              flush=True)
        del ops, lo, hi, hvx, kp
        torch.cuda.empty_cache()
    fused_mlp.fused_apply.launches = saved  # these launches are not the main path's
    return out


KERNELS = {  # name -> (source, TPU kernel it replaces)
    "fused_mlp_fwd": ("simplenerf_torch/ops/csrc/fused_mlp_fwd.cu",
                      "simplenerf_tpu/ops/fused_mlp.py:448"),
    "fused_mlp_bwd": ("simplenerf_torch/ops/csrc/fused_mlp_bwd.cu",
                      "simplenerf_tpu/ops/fused_mlp.py:491"),
    "fused_mlp_ens_fwd": ("simplenerf_torch/ops/csrc/fused_mlp_fwd.cu",
                          "simplenerf_tpu/ops/fused_mlp.py:802"),
    "fused_mlp_ens_bwd": ("simplenerf_torch/ops/csrc/fused_mlp_bwd.cu",
                          "simplenerf_tpu/ops/fused_mlp.py:848"),
}
WRAPPERS = {"fused_mlp_fwd": "fused_apply", "fused_mlp_bwd": "fused_bwd",
            "fused_mlp_ens_fwd": "fused_apply_ensemble", "fused_mlp_ens_bwd": "fused_ens_bwd"}


def main() -> int:
    if not (REPO / "simplenerf_torch").is_dir():
        print("chip_smoke.py needs the repository beside it (simplenerf_torch/ is missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = card_line()
    print(card, flush=True)

    from simplenerf_torch.ops import build

    t0 = time.perf_counter()
    libs = build.build_all()
    ptxas = {}
    for name, lib in libs.items():
        build.load_library(name)
        for entry, r in ptxas_report(lib.with_suffix(".log").read_text()).items():
            if "registers" in r:
                ptxas[kernel_label(entry)] = r
                print(f"build: {name} ptxas {kernel_label(entry)}: {r['registers']} registers, "
                      f"{r.get('spill_stores', 0)} / {r.get('spill_loads', 0)} B spill stores / loads",
                      flush=True)
    print(f"build: {', '.join(libs)} in {time.perf_counter() - t0:.1f} s (parallel nvcc)", flush=True)

    worst = check_train_kernels()
    print(f"kernel checks done at {time.perf_counter() - t_start:.1f} s", flush=True)
    h, w = 189, 252
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        served = serve(work, h, w)
        trained = train(work, work / "db")
        step_err = {d: step_gradients(work / "db", d) for d in ("float32", "bfloat16")}
        torch.cuda.empty_cache()
        timing = chunk_kernels(test_rays=min(CHUNK_RAYS, -(-(h * w) // 256) * 256))
        train_timing = time_train_kernels()
        step = step_time(work / "db")

    fine, coarse = timing["fine"], timing["coarse"]
    print(f"serve: {served['frame_s']:.3f} s per served 756x1008 frame; "
          f"{served['test_s'] / served['frames']:.3f} s per 189x252 test frame incl. file output",
          flush=True)
    print(f"train: {step['s_per_step']:.4f} s per step, {step['rays_per_s']:.0f} rays/s "
          f"(4096 rays per step, published bf16 recipe)", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    key = ("fused_mlp_fwd", "bfloat16", "err")
    worst[key] = max(worst[key], timing["max_abs_err"])
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = train_timing[name]
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": trained["launches"][WRAPPERS[name]],
            "max_abs_err": worst[(name, "bfloat16", "err")],
            "max_abs_err_f32": worst[(name, "float32", "err")],
            "err_measure": ("planes: max abs error" if name.endswith("fwd")
                            else "gradients: max abs error / the plain version's largest value"),
        }
        if name.endswith("bwd"):  # the held measure: ||got - want|| / ||want||
            row["norm_err"] = worst[(name, "bfloat16", "norm")]
            row["norm_err_f32"] = worst[(name, "float32", "norm")]
            row.update({k: t[k] for k in ("row_ms", "weight_ms", "sums_ms", "sums_parts_ms")
                        if k in t})
            ys = t["yardsticks"]  # measured here; the bounds stay on the `time` lines
            row.update({k: ys[k] for k in ("weight_library_ms", "sums_library_ms")})
            row["row_ptxas"] = ptxas["fused_mlp_bwd_rows_kernel bf16"]
            row["weight_ptxas"] = ptxas.get("fused_mlp_bwd_wgrad_kernel")
        row.update({
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "shape": t["shape"],
        })
        if name.endswith("fwd"):
            row["fwd_ptxas"] = ptxas["fused_mlp_fwd_sm90_kernel"]
            row["bound_share"] = t["bound_ms"] / t["ms"]
        if name == "fused_mlp_fwd":
            row["launches_serve"] = served["launches"]
            row["serve_chunks"] = {
                level: {**{k: timing[level][k] for k in ("rows", "ms", "plain_ms", "bound_ms")},
                        "bound_share": timing[level]["bound_ms"] / timing[level]["ms"]}
                for level in ("coarse", "fine")}
        kernels.append(row)
        if not all(math.isfinite(row[k]) for k in ("ms", "plain_ms", "bound_ms")):
            fail(f"non-finite timing for {name}")
    print(json.dumps({"kernels": kernels, "train_step": {**step, "step_grad_rel_err": step_err}}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
