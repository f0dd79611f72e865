#!/usr/bin/env python3
"""Chip smoke for simplenerf_torch: train (in one process and ray-sharded over ranks), serve and run the LLFF and RealEstate10K experiments' flows and the visibility priors on one CUDA card.

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, in order (any failure raises and the script exits non-zero
without a result):
  1. device: the card's name and power limit, as nvidia-smi reports them;
  2. build: compile every CUDA source with nvcc, one process per source,
     all started together, and print each kernel's ptxas registers and
     spill bytes and the HGMMA instructions in each kernel's SASS
     (`cuobjdump -sass`): the forwards, the row passes and the weight
     passes (bf16 and float32) must issue some;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the published width (8x256 trunk, 1x128 views, PE 10/4), for the main,
     points-augmentation, Lambertian and visibility-head MLPs, 64 and 192
     samples per ray, float32 and bfloat16, on 1037 rays: the forward's
     planes, and the backward's every dW, db and dhvx; the coarse trio
     through the ensemble kernels, forward and backward, at 1037 x 64;
     then all of them at the training step's shapes (4096 x 64 trio,
     4096 x 192 main), with the priors phase's visibility-head fine MLP
     and trio (views heads of 4 beside 3) at the same shapes; there the
     float32 kernels (3xTF32) are also held to the plain versions in
     float64: their error at most YARDSTICK times the float32 plain
     version's (planes and gradients; both printed); and the float32
     weight pass alone (`fused_mlp.wgrad`) on seeded float32 slots of the
     step's fine and trio stash (every dW of each backward) against
     torch.matmul in float64, within YARDSTICK times the float32
     torch.matmul's error; then ViP-NeRF's secondary views in the bf16
     kernels (`secondary_kernels`: `fused_apply(sec=)`, the secondary
     kernels alone and `fused_bwd(sec=, pre=)`) against their plain
     versions at 4096 x 64 and 4096 x 192 with k = 2 and at 1037 x 64 with
     k = 3, the secondary kernels timed at the step's shapes beside their
     plain versions and their bounds;
  4. serve: a seeded synthetic scene (189x252, 6 frames, 3 for training),
     the published bf16 recipe with seeded random weights in a checkpoint,
     `runner.start_testing` over its test frames, then one 756x1008 request
     through `Tester.predict_frame`; the launch counters must show the
     kernel served every chunk, and a 4096-ray crop of the frame is held
     against the plain path;
  5. train: on the same scene, the published bf16 recipe with the
     consistency ramp at 10 so that all nine losses carry weight,
     `runner.start_training` for 40 steps in 4 chunks of 10
     (`steps_per_call`: each chunk replays one CUDA graph of the step,
     captured after the first step): a checkpoint and logs/scalars.jsonl
     appear, every loss is finite, MSE01 falls, and the launch counters
     show one ensemble forward, one ensemble backward, one forward and one
     backward per step; then 10 steps through the graph against 10 through
     the loop from the same initialization and draws, twice: parameters,
     Adam's mu, nu and count and the loss values, equal to the bit or no
     further from the loop than a second loop run is (both printed); then
     one step's parameter gradients through the kernels against the plain
     versions swapped in (same params, batch and draws), in float32 and
     bfloat16;
  6. parallel: ray-sharded training on the same scene with the same
     recipe, 6 steps each: (a) the in-process Trainer without a mesh;
     (b) one NCCL rank, a subprocess of tools/multiprocess_worker_torch.py
     with torchrun's environment, through
     `parallel.initialize_distributed`, `make_mesh` and
     `runner.start_training(mesh=)`, its 6 steps one chunk through the CUDA
     graph (`--steps-per-call 6`: step 6's loss values held, and the
     parameters' equality to (a)'s printed); (c) two gloo ranks of it sharing the
     card (NCCL refuses two ranks on one device), rank 0 rendering the
     2048 NeRF rows and rank 1 the 2048 sparse-depth rows. Step 1's flat
     gradient (max abs error over the largest) and every step's loss
     values (relative) of (b) and (c) must meet (a) within the bf16 step
     tolerance, with whether (b) is equal to the bit printed; every
     subprocess must exit 0 and each rank's counters read one launch of
     each kernel per step; a `{"parallel": ...}` line (s per step of
     each, the bytes all_reduce_sum reduces per step, the worst errors);
  7. pipeline: the LLFF experiment's flow, `drivers.llff.run` (what
     `python -m simplenerf_torch.drivers.llff` runs), on a fresh copy of
     the scene with the published bf16 recipe: 20 training steps with
     validation renders and loss maps every 10 and a torch.profiler window
     over steps 12-13, `start_testing` with QA (the scene's GT depths,
     VM02 masks from `qa.masks.generate_visibility_masks`), both videos
     along a 4-pose spiral from `dataset_tools.video_poses`; the forward
     kernel's launches during validation must be 2 per chunk per frame per
     round, every validation output must exist and be finite, a
     validation frame's fine rgb must agree with the Tester's render at
     its pose and with the plain versions (1e-3), every QA family must be
     scored (LPIPS may be skipped without its package), each video must
     have 4 PNG frames and the trace must hold device kernels; one test
     frame's VM02 masks through the native splat and through its numpy
     plain version, timed, both equal to the masks written; its
     readings go on a `{"pipeline": ...}` line before the kernels' line;
  8. realestate: the RealEstate10K experiment, `drivers.realestate.run`
     (what `python -m simplenerf_torch.drivers.realestate` runs), on a
     seeded RE10K-layout scene from `generate_realestate_scene` (20 frames
     of 54x96, 3 for training, 3 test frames) with `build_configs(3)`'s
     published bf16 recipe cut to 20 steps, QA against GT depths and VM02
     masks under test/visibility_masks/, and a 4-pose video from
     train_test_sets/set02/video_poses01/00000.csv: 20 launches of each
     kernel in training, the forward's launches in testing and the video
     counted, ModelConfigs bounds [1, 100] / 0.75, finite losses, every QA
     family scored, a test frame against the plain versions (1e-3), the
     video's frames written; a `{"realestate": ...}` line;
  9. priors: on a copy of the serve scene with dense depths and 3 x 2
     visibility-prior masks written (`synthetic.write_scene_priors`), the
     published bf16 recipe with a visibility head on the coarse and fine
     main MLPs, DenseDepthMSE01, VisibilityLoss01 and
     VisibilityPriorLoss01 and the dense-depth, visibility-prior and
     mip-NeRF data (`presets.with_visibility_priors`), 20 steps of
     `runner.start_training` with a validation round at 20: 20 launches of
     each kernel in training, the fine and trio programs' views heads 4
     channels wide, DenseDepthMSE01 and VisibilityLoss01 finite and > 0,
     VisibilityPriorLoss01 0 in every step (the train step renders no
     secondary views, as in the JAX package) and finite in validation,
     the secondary-view visibility path on a train frame, and one step's
     gradients (visibility head included) through the kernels against the
     plain versions in float32 and bf16; a `{"priors": ...}` line;
  10. chunks: the forward kernel at the chunk shapes serving gives it (64k
     rays x 64 / 192 samples for the 756x1008 frame, one test frame's
     chunk, and a 41,152-ray chunk), held against its plain version; at the
     64k shapes it is also timed with CUDA events after warm-up, beside the
     plain version and the card's bound; then the PE operand pass
     (`fused_mlp.pe_operands`) against its plain version bit for bit, in
     bf16 and float32, at the render's chunks (64k rays x 64 / 192, lo
     only), the training step's shapes (4096 x 64 / 192, lo and hi) and a
     ragged count, timed beside the plain version and its byte bound;
  11. timing: each kernel at the training step's shapes, in bf16 and in
     float32 (CUDA events after warm-up), beside its plain version and its
     bound (float32: 3 x FLOP at the TF32 peak, the FMA bound beside it),
     each backward's row
     pass, weight pass and column sums apart and each of its three column
     sums apart (torch.profiler's kernel events); for each backward the
     weight pass's bound from the distinct stash slots it reads (beside
     its FLOP bound), the stash bytes its producers issue, per-dW
     torch.matmul on a seeded stash of the step's shape and torch.sum at
     each column sum's shape; seconds per training step of the bf16 and of
     the float32 recipe through the loop
     (median of 40 after 3 of warm-up) and through the CUDA graph (median
     of 5 calls of `train_many(k=40)` after one that captures), rays/s,
     each one's device busy share from a torch.profiler breakdown of the
     step's device time by kernel (3 loop steps, 10 replayed steps: the
     replays must run each kernel of ops/csrc as often per step as the
     loop), peak device memory allocated and reserved, and the capture's
     time; one float32 756x1008 frame through `Tester.predict_frame`.
Every phase that counts launches also holds the PE operand pass's to one
for each fused forward of the run, and "the plain versions" swap out the
PE operand pass with the MLP kernels.
The last line is {"ok": true, "device": {...}}; the line before it holds the
per-kernel JSON (`launches` from the 40-step training run,
`launches_parallel` from phase 6, summed over its ranks of (b) and (c),
`launches_pipeline`, `launches_realestate` and `launches_priors` from
phases 7, 8 and 9; a backward's row also has row_ms, weight_ms, sums_ms,
sums_parts_ms (partials, dW partials, dhvx), weight_library_ms and
sums_library_ms (measured; the weight pass's and column sums' bounds are
printed on its `time` lines), the row pass's own bound, row_bound_ms
(the larger of its FLOP, the forward again and dX, at the bf16 peak and
the bytes it must move at HBM's rate: its inputs read once, the stash
slots the weight pass reads, the g32 planes and the partials written
once; `row_pass_bytes`), row_bound_by and row_bound_share =
row_bound_ms / row_ms, its bf16 row kernel's ptxas registers and spill
bytes, row_ptxas, and the weight kernel's, weight_ptxas; a
forward's row has its bf16 kernel's ptxas, fwd_ptxas, and the share of
its bound, bound_share = bound_ms / ms; the serving chunks carry the
same; the float32 readings carry the suffix _f32: ms, plain_ms, bound_ms
(3xTF32), fma_bound_ms, the passes, the float32 kernels' ptxas and HGMMA
counts, yardstick_f32, and the per-dW float32 torch.matmul beside the
float32 weight pass; a backward's row names the float32 weight pass's
kernel and source (weight_kernel_f32, weight_source_f32) with its ptxas,
HGMMA count, issued GB and its float64 yardstick at the step's shapes,
weight_yardstick_f32). A
forward's `time` line also counts the weight bytes its producer issues
per launch (blocks x the packed slab image), and a backward's the stash
bytes its weight pass's producers issue: counts, not readings of the
card's traffic. The PE operand pass's row, field_pe, has the same launch
counts (launches_serve too), the elements that differ from its plain
version (differ), ms, plain_ms, bound_ms and bound_share at the render's
fine bf16 chunk, its ptxas by type and every checked shape's readings
(shapes). The secondary kernels' rows, sec_fwd and sec_bwd, have the
vipnerf phase's launches (launches_vipnerf, which the MLP kernels' rows
carry too), the worst error of phase 3's checks (planes: max abs error;
gradients: norm error), ms, plain_ms, bound_ms, bound_by and bound_share
at the fine level of a ViP-NeRF step (4096 x 192, k = 2), the coarse
level's beside them and their ptxas.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (dense): tensor-core bf16 and TF32 and
# CUDA-core float32 rates, and HBM3 bandwidth. A float32 kernel on the
# tensor cores forms each product as three TF32 products (3xTF32), so its
# bound is 3 x FLOP at the TF32 rate; its FMA bound, FLOP at the CUDA-core
# rate, is printed beside it.
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 494.7e12, "float32": 67e12}
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


def hgmma_counts(lib: Path) -> dict:
    """{kernel label: HGMMA instructions} in a built library's SASS
    (`cuobjdump -sass`): the tensor-core products each kernel issues."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = kernel_label(line.split("Function :")[1].strip())
            out.setdefault(fn, 0)
        elif fn and "HGMMA" in line:
            out[fn] += 1
    return out


TENSOR_CORE_KERNELS = ("fused_mlp_fwd_sm90_kernel", "fused_mlp_fwd_tf32_kernel",
                       "fused_mlp_bwd_rows_sm90_kernel", "fused_mlp_bwd_rows_tf32_kernel",
                       "fused_mlp_bwd_wgrad_kernel", "fused_mlp_bwd_wgrad_tf32_kernel")
WGRAD_F32 = ("fused_mlp_bwd_wgrad_tf32_kernel",
             "simplenerf_torch/ops/csrc/fused_mlp_bwd.cu + fused_mlp_wgrad_tf32_sm90.cuh")


def kernel_label(entry: str) -> str:
    """A mangled kernel entry's name and operand type, e.g. 'fused_mlp_bwd_rows_kernel f32':
    the first of its length-prefixed names that ends in _kernel, and the template argument."""
    pos = entry.find("_ZN") + 3
    while (m := re.match(r"\d+", entry[pos:])) and pos > 2:
        start = pos + len(m[0])
        pos = start + int(m[0])
        if entry[start:pos].endswith("_kernel"):
            rest = entry[pos:]
            return entry[start:pos] + (" bf16" if rest.startswith("I13__nv_bfloat16") else
                                       " f32" if rest.startswith("If") else
                                       " sec" if rest.startswith("ILb1E") else "")
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
VIS_TRIO = ("visibility", "points_aug", "lambertian")


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


def ensemble_operands(nr: int, ns: int, dtype, seed: int, trio=None):
    """Seeded coarse trio (published widths) and inputs on the card."""
    import torch

    from simplenerf_torch.fields import mlp

    g = torch.Generator().manual_seed(seed)
    members = []
    for name in trio or TRIO:
        cfg = mlp.MLPConfig(**PUBLISHED[name])
        members.append((mlp.init(g, cfg, device="cuda"), cfg))
    pts = (torch.rand((nr * ns, 3), generator=g) * 2 - 1).cuda()
    dirs = torch.nn.functional.normalize(torch.randn((nr, 3), generator=g), dim=-1).cuda()
    return mlp.ensemble_operands(members, pts, dirs, ns, dtype)


# The float32 kernels (3xTF32) against the plain version evaluated in
# float64: the kernel's error may be at most YARDSTICK times the float32
# plain version's (true float32 products) against the same float64 result,
# planes as max abs error, gradients as the worst ||got - want|| / ||want||.
# One TF32 product instead of three fails it (tools/probe_fused_mlp*.py).
YARDSTICK = 4.0


def _double(x):
    import torch

    if isinstance(x, dict):
        return {k: _double(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_double(v) for v in x)
    return x.double() if isinstance(x, torch.Tensor) else x


def yardstick(kernel: str, label: str, got, plain, exact, grads: bool) -> dict:
    """The kernel's and the float32 plain version's errors against the
    float64 plain version; fails past YARDSTICK."""
    import torch

    def err(a) -> float:
        if grads:
            return max(norm_err(a[k], exact[k]) for k in exact)
        return max((x.double() - y).abs().max().nan_to_num(float("inf")).item()
                   for x, y in zip(a, exact))

    k_err, p_err = err(got), err(plain)
    ratio = k_err / max(p_err, 1e-300)
    print(f"yardstick {kernel} {label} float32 vs float64: kernel {k_err:.3e}, float32 plain version "
          f"{p_err:.3e}, ratio {ratio:.2f} (limit {YARDSTICK:g}; "
          f"{'gradients, worst norm err' if grads else 'planes, max abs err'})", flush=True)
    if not ratio <= YARDSTICK:
        fail(f"{kernel} is further from float64 than {YARDSTICK:g} x the float32 plain version: {label}")
    torch.cuda.empty_cache()
    return {"kernel": k_err, "plain": p_err, "ratio": ratio}


def single_check(name: str, nr: int, ns: int, dtype, exact: bool = False) -> dict:
    """Forward and backward kernels of one MLP vs their plain versions;
    with `exact` (float32) also against the float64 plain versions."""
    from simplenerf_torch.fields.mlp import MLPConfig
    from simplenerf_torch.ops import fused_mlp

    dname = dname_of(dtype)
    ops = kernel_operands(MLPConfig(**PUBLISHED[name]), nr, ns, dtype, seed=len(name) + ns)
    spec = ops[0]
    label = f"{name} {nr} rays x {ns}"
    planes, plain = fused_mlp.fused_apply(*ops), fused_mlp.fused_apply_reference(*ops)
    fwd = check_planes(label, dname, planes, plain)
    dp = cotangents(spec.n_planes, nr, ns, seed=ns)
    dkp, dhvx = fused_mlp.fused_bwd(*ops, dp)
    want, want_hvx = fused_mlp.fused_bwd_reference(*ops, dp)
    if spec.has_hvx:
        dkp, want = {**dkp, "dhvx": dhvx}, {**want, "dhvx": want_hvx}
    bwd = check_grads("fused_mlp_bwd", label, dname, dkp, want)
    out = {"fwd": fwd, "bwd": bwd}
    if exact:
        ops64 = (fused_mlp.with_dtype(spec, "float64"), *_double(ops[1:]))
        out["fwd_yardstick"] = yardstick("fused_mlp_fwd", label, planes, plain,
                                         fused_mlp.fused_apply_reference(*ops64), grads=False)
        w64, w64_hvx = fused_mlp.fused_bwd_reference(*ops64, dp.double())
        if spec.has_hvx:
            w64 = {**w64, "dhvx": w64_hvx}
        out["bwd_yardstick"] = yardstick("fused_mlp_bwd", label, dkp, want, w64, grads=True)
    return out


def _flat_grads(trio, dkps, dhvxs) -> dict:
    out = {}
    for name, a in zip(trio, dkps):
        out.update({f"{name}.{k}": v for k, v in a.items()})
    for i, a in enumerate(dhvxs):
        out[f"dhvx{i}"] = a
    return out


def ensemble_check(nr: int, ns: int, dtype, trio=TRIO, exact: bool = False) -> dict:
    from simplenerf_torch.ops import fused_mlp

    dname = dname_of(dtype)
    ens, kps, lo, hvxs = ensemble_operands(nr, ns, dtype, seed=nr + ns, trio=trio)
    label = f"{'trio' if trio == TRIO else 'visibility trio'} {nr} rays x {ns}"
    got = fused_mlp.fused_apply_ensemble(ens, kps, lo, hvxs)
    want = fused_mlp.fused_apply_ensemble_reference(ens, kps, lo, hvxs)
    fwd = check_planes(label, dname, got, want, kernel="fused_mlp_ens_fwd")
    dp = cotangents(ens.n_planes, nr, ns, seed=ns + 1)
    got_all = _flat_grads(trio, *fused_mlp.fused_ens_bwd(ens, kps, lo, hvxs, dp))
    want_all = _flat_grads(trio, *fused_mlp.fused_ens_bwd_reference(ens, kps, lo, hvxs, dp))
    bwd = check_grads("fused_mlp_ens_bwd", label, dname, got_all, want_all)
    out = {"fwd": fwd, "bwd": bwd}
    if exact:
        ops64 = (fused_mlp.with_dtype(ens, "float64"), *_double((kps, lo, hvxs)))
        out["fwd_yardstick"] = yardstick("fused_mlp_ens_fwd", label, got, want,
                                         fused_mlp.fused_apply_ensemble_reference(*ops64), grads=False)
        w64 = _flat_grads(trio, *fused_mlp.fused_ens_bwd_reference(*ops64, dp.double()))
        out["bwd_yardstick"] = yardstick("fused_mlp_ens_bwd", label, got_all, want_all, w64, grads=True)
    return out


def wgrad_check(which: str) -> dict:
    """The float32 weight pass alone (`fused_mlp.wgrad`, launched) at the
    training step's shapes: every dW of the fine (4096 x 192 rows) or trio
    (4096 x 64) backward on seeded float32 slots (A uniform in [0, 1), as
    ReLU activations; G normal), against torch.matmul in float64; the worst
    ||got - want|| / ||want|| at most YARDSTICK times float32
    torch.matmul's (no TF32). Its launches are not the main path's."""
    import torch

    from simplenerf_torch.fields.mlp import MLPConfig
    from simplenerf_torch.ops import fused_mlp

    if which == "fine":
        spec, kp = kernel_operands(MLPConfig(), 8, FINE_NS, torch.float32, seed=3)[:2]
        rows = STEP_RAYS * FINE_NS
    else:
        spec, kp = ensemble_operands(8, COARSE_NS, torch.float32, seed=5)[:2]
        rows = STEP_RAYS * COARSE_NS
    dws = fused_mlp.pack_bwd_program(spec, kp, 64).dws
    a_slots = {(a, aw) for a, aw, *_ in dws}
    index = {}
    for a, aw, g, gw, *_ in dws:
        for key in ((a, aw), (g, gw)):
            index.setdefault(key, len(index))
    gen = torch.Generator(device="cuda").manual_seed(13)
    slots = [None] * len(index)
    for (c, w), i in index.items():
        slots[i] = (torch.rand((rows, w), generator=gen, device="cuda") if (c, w) in a_slots
                    else torch.randn((rows, w), generator=gen, device="cuda"))
    calls = [(index[(a, aw)], index[(g, gw)], k, m) for a, aw, g, gw, k, m, _ in dws]
    launches = fused_mlp.wgrad.launches
    got = fused_mlp.wgrad(slots, calls)
    torch.cuda.synchronize()
    if fused_mlp.wgrad.launches != launches + 1:
        fail("fused_mlp.wgrad did not count its launch")
    fused_mlp.wgrad.launches = launches
    k_err = p_err = 0.0
    for (a, g, k, m), x in zip(calls, got):
        exact = slots[a][:, :k].double().T @ slots[g][:, :m].double()
        if x.shape != (k, m) or not torch.isfinite(x).all():
            fail(f"float32 weight pass: dW ({k}, {m}) not finite or of shape {tuple(x.shape)}")
        k_err = max(k_err, norm_err(x, exact))
        p_err = max(p_err, norm_err(slots[a][:, :k].T @ slots[g][:, :m], exact))
        del exact
    del slots, got
    torch.cuda.empty_cache()
    ratio = k_err / max(p_err, 1e-300)
    print(f"yardstick fused_mlp_bwd_wgrad_tf32_kernel {which} step ({rows} rows, {len(calls)} dW) float32 "
          f"vs float64: kernel {k_err:.3e}, float32 torch.matmul {p_err:.3e}, ratio {ratio:.2f} "
          f"(limit {YARDSTICK:g}; worst norm err)", flush=True)
    if not ratio <= YARDSTICK:
        fail(f"the float32 weight pass is further from float64 than {YARDSTICK:g} x float32 "
             f"torch.matmul: {which}")
    return {"kernel": k_err, "plain": p_err, "ratio": ratio}


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

    def keep_exact(kernel, e):  # the float64 yardstick at the step's shapes, its worst ratio
        key = (kernel, "float32", "yardstick")
        if key not in worst or e["ratio"] > worst[key]["ratio"]:
            worst[key] = e

    for dtype in (torch.float32, torch.bfloat16):
        for name in PUBLISHED:
            for ns in (COARSE_NS, FINE_NS):
                e = single_check(name, 1037, ns, dtype)
                keep("fused_mlp_fwd", dtype, e["fwd"])
                keep("fused_mlp_bwd", dtype, e["bwd"])
        exact = dtype == torch.float32
        for nr, ns in ((1037, COARSE_NS), (STEP_RAYS, COARSE_NS)):
            e = ensemble_check(nr, ns, dtype, exact=exact and nr == STEP_RAYS)
            keep("fused_mlp_ens_fwd", dtype, e["fwd"])
            keep("fused_mlp_ens_bwd", dtype, e["bwd"])
            if "fwd_yardstick" in e:
                keep_exact("fused_mlp_ens_fwd", e["fwd_yardstick"])
                keep_exact("fused_mlp_ens_bwd", e["bwd_yardstick"])
        for name in ("main", "visibility"):  # the published step; the priors phase's
            e = single_check(name, STEP_RAYS, FINE_NS, dtype, exact=exact and name == "main")
            keep("fused_mlp_fwd", dtype, e["fwd"])
            keep("fused_mlp_bwd", dtype, e["bwd"])
            if "fwd_yardstick" in e:
                keep_exact("fused_mlp_fwd", e["fwd_yardstick"])
                keep_exact("fused_mlp_bwd", e["bwd_yardstick"])
        # The priors phase's coarse trio: a 4-channel views head beside 3.
        e = ensemble_check(STEP_RAYS, COARSE_NS, dtype, trio=VIS_TRIO)
        keep("fused_mlp_ens_fwd", dtype, e["fwd"])
        keep("fused_mlp_ens_bwd", dtype, e["bwd"])
        torch.cuda.empty_cache()
    for kernel, which in (("fused_mlp_bwd", "fine"), ("fused_mlp_ens_bwd", "trio")):
        worst[(kernel, "float32", "wgrad_yardstick")] = wgrad_check(which)
    for f, n in saved.items():
        f.launches = n
    return worst


@contextlib.contextmanager
def plain_versions():
    """The kernels' plain versions in place of their launches: the four MLP
    kernels' (with the secondary views') and the PE operand pass's."""
    import torch

    from simplenerf_torch.ops import fused_mlp as fm

    saved = (fm._fwd, fm.fused_bwd, fm._ens_fwd, fm.fused_ens_bwd, fm.pe_operands)
    fm._fwd = lambda *a: (torch.stack(fm.fused_apply_reference(*a)), None)
    fm.fused_bwd = lambda *a, sec=None, pre=None: fm.fused_bwd_reference(*a, sec=sec)
    fm._ens_fwd = lambda *a: torch.stack(fm.fused_apply_ensemble_reference(*a))
    fm.fused_ens_bwd = fm.fused_ens_bwd_reference
    fm.pe_operands = fm.pe_operands_reference
    try:
        yield
    finally:
        fm._fwd, fm.fused_bwd, fm._ens_fwd, fm.fused_ens_bwd, fm.pe_operands = saved


def mlp_launches(label: str, launches: dict) -> dict:
    """The MLP kernels' launches of `launches` (by wrapper name), once the PE
    operand pass's are held to one for each fused forward of the same run
    (fused_apply's and fused_apply_ensemble's)."""
    rest = {k: n for k, n in launches.items() if k != "pe_operands"}
    forwards = rest.get("fused_apply", 0) + rest.get("fused_apply_ensemble", 0)
    if launches["pe_operands"] != forwards:
        fail(f"{label}: {launches['pe_operands']} PE operand launches for {forwards} fused forwards")
    return rest


def train_config(**overrides) -> dict:
    """The published bf16 recipe on the synthetic scene, consistency from step 10."""
    from simplenerf_torch.drivers import presets

    kw = dict(compute_dtype="bfloat16", scene_id="blobs", consistency_start_iter=10,
              num_iterations=40)
    kw.update(overrides)
    cfg = presets.simplenerf_config(**kw)
    cfg["log_interval"] = 10
    return cfg


def loss_keys(row: dict) -> list:
    """The loss values' keys of a training log row: neither its bookkeeping
    (iter, time, lr, rays_per_s) nor the step's device spans (device_ms/...)."""
    return [k for k in row
            if k not in ("iter", "time", "lr", "rays_per_s") and not k.startswith("device_ms/")]


def train(work: Path, db: Path) -> dict:
    """The training path through `runner.start_training`, in chunks of
    TRAIN_CHUNK steps (each a CUDA graph's replays, the first of the first
    chunk its warm-up); returns its launches."""
    import numpy as np
    import torch

    from simplenerf_torch.drivers import runner
    from simplenerf_torch.ops import fused_mlp

    cfg = train_config()
    cfg["steps_per_call"] = TRAIN_CHUNK
    steps = cfg["num_iterations"]
    counters = (fused_mlp.fused_apply_ensemble, fused_mlp.fused_ens_bwd, fused_mlp.fused_apply,
                fused_mlp.fused_bwd, fused_mlp.pe_operands)
    # The main path: counters at 0 just before, read just after.
    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    run_dir = runner.start_training(cfg, db, work / "runs")
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in counters}
    print(f"train: start_training, {steps} steps of the published bf16 recipe in chunks of "
          f"{TRAIN_CHUNK} in {t_train:.1f} s incl. set-up and capture; launches {launches}",
          flush=True)
    if any(n != steps for n in mlp_launches("train", launches).values()):
        fail(f"expected {steps} launches of each kernel, got {launches}")
    scene = run_dir / "blobs"
    if not (scene / f"saved_models/Model_Iter{steps:06}.msgpack").exists():
        fail("no checkpoint after training")
    rows = [json.loads(line) for line in (scene / "logs/scalars.jsonl").read_text().splitlines()]
    losses = loss_keys(rows[-1])
    for r in rows:
        print("train: " + ", ".join(f"{k} {r[k]:.4g}" for k in ["iter"] + losses), flush=True)
    if len(losses) != 10 or not all(np.isfinite(r[k]) for r in rows for k in losses):
        fail(f"losses missing or not finite: {losses}")
    if not rows[-1]["MSE01"] < rows[0]["MSE01"]:
        fail("MSE01 did not fall during training")
    return {"launches": launches, "s": t_train, "run_dir": run_dir}


TRAIN_CHUNK = 10
GRAPH_STEPS = 10


def graph_vs_loop(db: Path) -> dict:
    """GRAPH_STEPS steps of the published bf16 recipe from one
    initialization with the same draws, in three fresh Trainers: twice
    through the loop (`train_one_iter`), once through the CUDA graph
    (`train_many` in two calls of half the steps: a warm-up step, the
    capture and replays, then replays of the same graph). The parameters,
    Adam's mu, nu and count and every loss value at both halves' ends are
    held as the largest absolute difference from the first loop run: the
    graph's may be no larger than the second loop run's. Both, and whether
    each is equal to the bit, are printed."""
    import torch

    from simplenerf_torch.data.factory import get_data_loader
    from simplenerf_torch.data.preprocessor import ScenePreprocessor
    from simplenerf_torch.ops import fused_mlp
    from simplenerf_torch.training.trainer import Trainer

    saved = fused_mlp.launch_counts()
    cfg = train_config()
    cfg["resume_training"] = False
    raw = get_data_loader(cfg, db, "train").load_data()
    half = GRAPH_STEPS // 2

    def run(graph: bool) -> dict:
        with tempfile.TemporaryDirectory() as tmp:
            t = Trainer(cfg, Path(tmp), ScenePreprocessor(cfg, "train", raw))
            if graph:
                values = [t.train_many(0, half), t.train_many(half, GRAPH_STEPS - half)]
            else:
                values = [t.train_one_iter(it) for it in range(GRAPH_STEPS)]
                values = [values[half - 1], values[-1]]
            state = {"params": torch.cat([p.detach().reshape(-1) for p in t.leaves]),
                     "mu": t.opt_state["mu"], "nu": t.opt_state["nu"],
                     "count": torch.tensor([float(t.opt_state["count"])]),
                     "values": torch.stack([v[k] for v in values for k in sorted(v)])}
            state = {k: v.detach().float().cpu() for k, v in state.items()}
            t.logger.close()
        torch.cuda.empty_cache()
        return state

    a, b, g = run(False), run(False), run(True)
    fused_mlp.add_launches({k: n - fused_mlp.launch_counts()[k] for k, n in saved.items()})
    out = {}
    for k in a:
        if not all(torch.isfinite(x[k]).all() for x in (a, b, g)):
            fail(f"graph vs loop: {k} not finite")
        out[k] = {"graph_max_abs_diff": float((g[k] - a[k]).abs().max()),
                  "loop_max_abs_diff": float((b[k] - a[k]).abs().max()),
                  "graph_equal": bool(torch.equal(g[k], a[k])),
                  "loop_equal": bool(torch.equal(b[k], a[k]))}
        r = out[k]
        print(f"graph vs loop, {GRAPH_STEPS} steps: {k}: graph equal to the loop to the bit: "
              f"{r['graph_equal']} (max abs diff {r['graph_max_abs_diff']:.3e}); a second loop "
              f"run: {r['loop_equal']} ({r['loop_max_abs_diff']:.3e})", flush=True)
        if r["graph_max_abs_diff"] > r["loop_max_abs_diff"]:
            fail(f"graph vs loop: {k} differs from the loop by more than the loop from itself")
    return out


def step_gradients(db: Path, dtype_name: str, make_config=None, label: str = "") -> dict:
    """One training step's parameter gradients through the kernels and
    through the plain versions, from the same params, batch and draws.
    Every gradient is held as max abs error over the plain version's largest
    value; with a `make_config` (another path's recipe) also as
    ||got - want|| / ||want||, both against STEP_TOL. Returns the worst
    error, its tensor and the errors of the views heads (`views_out`)."""
    import torch

    from simplenerf_torch.data.factory import get_data_loader
    from simplenerf_torch.data.preprocessor import ScenePreprocessor
    from simplenerf_torch.training.trainer import Trainer

    cfg = (make_config or train_config)(compute_dtype=dtype_name)
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
    if make_config is not None:
        errs = [max(e, norm_err(a, b)) for e, a, b in zip(errs, kern, plain)]
    worst = max(errs)
    names = leaf_paths(trainer.params)
    print(f"step gradients{label} {dtype_name}: kernels vs plain versions, worst "
          f"{'rel / norm' if make_config else 'rel'} err {worst:.3e} "
          f"({names[errs.index(worst)]} of {len(errs)} tensors; tol {STEP_TOL[dtype_name]:g}); "
          f"median {statistics.median(errs):.3e}", flush=True)
    if not worst <= STEP_TOL[dtype_name]:
        fail(f"a training step's gradients disagree with the plain versions ({dtype_name}{label})")
    return {"worst": worst, "worst_tensor": names[errs.index(worst)],
            "views_out": {n: e for n, e in zip(names, errs) if "views_out" in n}}


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
    parts = {"fused_mlp_bwd_rows_kernel": "row_ms", "fused_mlp_bwd_rows_sm90_kernel": "row_ms",
             "fused_mlp_bwd_rows_tf32_kernel": "row_ms", "fused_mlp_tf32_split_kernel": "row_ms",
             "fused_mlp_bwd_wgrad_kernel": "weight_ms", "fused_mlp_bwd_wgrad_tf32_kernel": "weight_ms",
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


def slab_gb(spec, rows: int):
    """GB of weight slabs one forward launch issues: every 128-row block
    copies the whole packed slab image once (in float32 its big and small
    TF32 halves, `fused_mlp.slab_bytes`). A count of what the producer asks
    for, not a measurement of L2 traffic; None where the package counts none
    (an earlier checkout's float32 engine)."""
    from simplenerf_torch.ops import fused_mlp

    if hasattr(fused_mlp, "slab_bytes"):
        return fused_mlp.slab_bytes(spec, rows) / 1e9
    if spec.cdtype != fused_mlp.torch.bfloat16:
        return None
    return -(-rows // 128) * fused_mlp.sm90_plan(spec).w_index.size * 2 / 1e9


def bound_ms(flops: float, nbytes: float, dname: str = "bfloat16") -> tuple[float, str]:
    """The least time of `flops` and `nbytes` on the card in the compute
    type `dname` (float32: 3xTF32 on the tensor cores) and what bounds it."""
    t_ops = (flops / PEAK_FLOPS["bfloat16"] if dname == "bfloat16"
             else 3 * flops / PEAK_FLOPS["tf32"])
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def fma_bound_ms(flops: float) -> float:
    """The least time of `flops` as float32 FMAs on the CUDA cores."""
    return 1e3 * flops / PEAK_FLOPS["float32"]


def row_pass_bytes(plan, rows: int, inputs) -> int:
    """Bytes the backward's row pass must move: each input tensor read once
    and each output written once, the stash slots the weight pass reads
    (2 bytes a value in bf16, 4 in float32), the g32 planes of dhvx and the
    per-tile partials rows (4). Its mask words are its own scratch, written
    and read back by the same block."""
    slots = {s: w for a, aw, g, gw, *_ in plan.dws for s, w in ((a, aw), (g, gw))}
    esize = plan.wts.element_size()
    outputs = (sum(slots.values()) * rows * esize + plan.n_hvx * rows * plan.hvx_w * 4
               + -(-rows // 128) * plan.part_w * 4)
    return outputs + sum(t.numel() * t.element_size() for t in inputs if t is not None)


def weight_pass_yardsticks(label: str, plan, rows: int, sum_shapes, dname: str = "bfloat16") -> dict:
    """The backward's weight pass and column sums against what the card and
    PyTorch would take for the same work, on a seeded stash of the step's
    shape in the compute type: the weight pass's bounds (the distinct stash
    slots it reads, each once, over HBM's rate; its FLOP over the peak of
    the compute type, and in float32 also as FMAs), the stash bytes its
    producers issue (a count from the plan), one torch.matmul of the
    two slots per dW (N calls; float32 without TF32, PyTorch's default), and
    torch.sum at each column sum's shape (the same function, one call each)."""
    import torch

    cd = torch.bfloat16 if dname == "bfloat16" else torch.float32
    esize = 2 if dname == "bfloat16" else 4
    slots = {s: w for a, aw, g, gw, *_ in plan.dws for s, w in ((a, aw), (g, gw))}
    slot_bytes = sum(slots.values()) * rows * esize
    flops = sum(2 * k * m * rows for *_, k, m, _off in plan.dws)
    g = torch.Generator(device="cuda").manual_seed(11)
    stash = torch.randn(plan.stash_cols * rows, generator=g, device="cuda").to(cd)

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
           "weight_flop_bound_ms": bound_ms(flops, 0, dname)[0],
           "weight_library_ms": matmul_ms, "weight_library_calls": len(plan.dws),
           "sums_library_ms": sums_ms,
           "sums_bound_ms": [1e3 * 4 * S * C * (L + 1) / PEAK_BYTES for S, L, C in sum_shapes]}
    if dname == "float32":
        out["weight_fma_bound_ms"] = fma_bound_ms(flops)
    fma = f", as FMAs {out['weight_fma_bound_ms']:.3f} ms" if dname == "float32" else ""
    print(f"time {label} {dname} weight pass yardsticks: {out['weight_bytes_gb']:.2f} GB of distinct "
          f"stash slots, {1e3 * slot_bytes / PEAK_BYTES:.3f} ms at HBM's rate; FLOP bound "
          f"{out['weight_flop_bound_ms']:.3f} ms{fma}; {out['weight_issued_gb']:.2f} GB issued by its "
          f"producers (a count from the plan); torch.matmul per dW ({len(plan.dws)} calls) "
          f"{matmul_ms:.3f} ms; column sums at "
          + ", ".join(f"{S}x{L}x{C}" for S, L, C in sum_shapes) + ": torch.sum "
          + ", ".join(f"{ms:.3f}" for ms in sums_ms) + " ms, bounds "
          + ", ".join(f"{ms:.3f}" for ms in out["sums_bound_ms"]) + " ms", flush=True)
    return out


def _sum_shapes(plan, rows: int, ns: int) -> list:
    """(S, L, C) of a backward's three column sums: partials, dW partials, dhvx."""
    return [(1, -(-rows // 128), plan.part_w), (1, plan.n_chunks, plan.dw_total),
            (plan.n_hvx * (rows // ns), ns, plan.hvx_w)]


def time_train_kernels(dtype=None) -> dict:
    """Each kernel at the training step's shapes in `dtype` (bf16 by
    default), CUDA events after warm-up, beside its plain version and its
    bound (float32: 3xTF32, with the FMA bound beside it); each backward's
    passes (profiler) beside the weight pass's and column sums' yardsticks."""
    import torch

    from simplenerf_torch.fields.mlp import MLPConfig
    from simplenerf_torch.ops import fused_mlp

    saved = {f: f.launches for f in (fused_mlp.fused_apply, fused_mlp.fused_bwd,
                                     fused_mlp.fused_apply_ensemble, fused_mlp.fused_ens_bwd)}
    out = {}
    cd = dtype or torch.bfloat16
    dname, esize = dname_of(cd), 2 if cd == torch.bfloat16 else 4

    def wbytes(kps):
        return sum(v.numel() for kp in kps for v in kp.values()) * esize

    def sum_launches(plan):
        return tuple(2 if n > 1 else 1 for n in getattr(plan, "slices", (1, 1, 1)))

    def bounds(flops, nbytes, prefix=""):
        b = bound_ms(flops, nbytes, dname)
        row = {f"{prefix}bound_ms": b[0], f"{prefix}bound_by": b[1]}
        if dname == "float32":
            row[f"{prefix}fma_bound_ms"] = fma_bound_ms(flops)
        return row

    # Fine: one MLP, 4096 x 192.
    spec, kp, lo, hi, hvx = ops = kernel_operands(MLPConfig(), STEP_RAYS, FINE_NS, cd, seed=3)
    rows = lo.shape[0]
    dp = cotangents(spec.n_planes, STEP_RAYS, FINE_NS, seed=4)
    plan = fused_mlp.pack_bwd_program(spec, kp, rows)
    io = lo.numel() * esize + hvx.numel() * 4
    shape = f"fine step: {STEP_RAYS} rays x {FINE_NS} = {rows} points, {dname}"
    out["fused_mlp_fwd"] = dict(
        shape=shape, ms=cuda_time_ms(lambda: fused_mlp.fused_apply(*ops), iters=10),
        plain_ms=cuda_time_ms(lambda: fused_mlp.fused_apply_reference(*ops), iters=3),
        slab_gb=slab_gb(spec, rows),
        **bounds(spec.flops_per_point() * rows, io + wbytes([kp]) + dp.numel() * 4))
    out["fused_mlp_bwd"] = dict(
        shape=shape, ms=cuda_time_ms(lambda: fused_mlp.fused_bwd(*ops, dp), iters=5),
        plain_ms=cuda_time_ms(lambda: fused_mlp.fused_bwd_reference(*ops, dp), iters=2),
        **bounds(spec.bwd_flops_per_point() * rows,
                 io + wbytes([kp]) + dp.numel() * 4 + wbytes([kp]) * 2 + hvx.numel() * 4),
        **bounds(spec.row_flops_per_point() * rows,
                 row_pass_bytes(plan, rows, (lo, hi, hvx, dp, plan.wts, plan.fpar)), "row_"),
        **bwd_pass_ms(lambda: fused_mlp.fused_bwd(*ops, dp), sums=sum_launches(plan)))
    del ops, lo, hi, hvx, kp, dp
    torch.cuda.empty_cache()
    out["fused_mlp_bwd"]["yardsticks"] = weight_pass_yardsticks(
        "fused_mlp_bwd", plan, rows, _sum_shapes(plan, rows, FINE_NS), dname)
    del plan

    # Coarse: the trio through the ensemble, 4096 x 64.
    ens, kps, lo, hvxs = ensemble_operands(STEP_RAYS, COARSE_NS, cd, seed=5)
    rows = lo.shape[0]
    dp = cotangents(ens.n_planes, STEP_RAYS, COARSE_NS, seed=6)
    plan = fused_mlp.pack_bwd_program(ens, kps, rows)
    io = lo.numel() * esize + sum(h.numel() for h in hvxs) * 4
    shape = f"coarse trio step: {STEP_RAYS} rays x {COARSE_NS} = {rows} points, {dname}"
    out["fused_mlp_ens_fwd"] = dict(
        shape=shape,
        ms=cuda_time_ms(lambda: fused_mlp.fused_apply_ensemble(ens, kps, lo, hvxs), iters=10),
        plain_ms=cuda_time_ms(lambda: fused_mlp.fused_apply_ensemble_reference(ens, kps, lo, hvxs),
                              iters=3),
        slab_gb=slab_gb(ens, rows),
        **bounds(ens.flops_per_point() * rows, io + wbytes(kps) + dp.numel() * 4))
    out["fused_mlp_ens_bwd"] = dict(
        shape=shape,
        ms=cuda_time_ms(lambda: fused_mlp.fused_ens_bwd(ens, kps, lo, hvxs, dp), iters=5),
        plain_ms=cuda_time_ms(lambda: fused_mlp.fused_ens_bwd_reference(ens, kps, lo, hvxs, dp),
                              iters=2),
        **bounds(ens.bwd_flops_per_point() * rows,
                 io + wbytes(kps) + dp.numel() * 4 + wbytes(kps) * 2 + io - lo.numel() * esize),
        **bounds(ens.row_flops_per_point() * rows,
                 row_pass_bytes(plan, rows, (lo, *hvxs, dp, plan.wts, plan.fpar)), "row_"),
        **bwd_pass_ms(lambda: fused_mlp.fused_ens_bwd(ens, kps, lo, hvxs, dp),
                      sums=sum_launches(plan)))
    del ens, kps, lo, hvxs, dp
    torch.cuda.empty_cache()
    out["fused_mlp_ens_bwd"]["yardsticks"] = weight_pass_yardsticks(
        "fused_mlp_ens_bwd", plan, rows, _sum_shapes(plan, rows, COARSE_NS), dname)
    del plan
    for name, r in out.items():
        l2 = f", {r['slab_gb']:.2f} GB of weight slabs issued" if r.get("slab_gb") else ""
        fma = f", FMA bound {r['fma_bound_ms']:.3f} ms" if "fma_bound_ms" in r else ""
        passes = ""
        if "row_ms" in r:
            parts = r.get("sums_parts_ms")
            split = (" (partials, dW partials, dhvx " + ", ".join(f"{ms:.3f}" for ms in parts) + ")"
                     if parts else "")
            row_fma = f", FMA {r['row_fma_bound_ms']:.3f} ms" if "row_fma_bound_ms" in r else ""
            passes = (f" (row pass {r['row_ms']:.3f}, bound {r['row_bound_ms']:.3f} ms "
                      f"({r['row_bound_by']}){row_fma}; weight pass {r['weight_ms']:.3f}, column sums "
                      f"{r['sums_ms']:.3f}{split} ms, profiler)")
        print(f"time {name} ({r['shape']}): kernel {r['ms']:.3f} ms{passes}, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}){fma}{l2}",
              flush=True)
    for f, n in saved.items():
        f.launches = n
    return out


def step_time(db: Path, warmup: int = 3, steps: int = 40, graph_calls: int = 5,
              dname: str = "bfloat16") -> dict:
    """Seconds per training step of the published recipe in `dname`, through the
    loop and through the CUDA graph, each in a fresh Trainer: the loop's
    host clock around each `train_one_iter` ending in a synchronisation
    (median of `steps` after `warmup`); the graph's around each call of
    `train_many(it, steps)` (a warm-up call that captures, then the median
    of `graph_calls` calls, per step). Beside each: a torch.profiler window
    (3 loop steps, 10 replayed steps: device time and busy share, kernels
    per step) and the peak device memory allocated and reserved; the
    graph's capture time. The replayed window must run each kernel of
    ops/csrc as many times per step as the loop's window."""
    import torch

    from simplenerf_torch.data.factory import get_data_loader
    from simplenerf_torch.data.preprocessor import ScenePreprocessor
    from simplenerf_torch.ops import fused_mlp
    from simplenerf_torch.training.trainer import Trainer

    saved = fused_mlp.launch_counts()
    cfg = train_config(compute_dtype=dname)
    cfg["resume_training"] = False
    raw = get_data_loader(cfg, db, "train").load_data()
    out = {}
    for mode in ("loop", "graph"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as tmp:
            trainer = Trainer(cfg, Path(tmp), ScenePreprocessor(cfg, "train", raw))
            rays = trainer.train_pp.num_rays + trainer.train_pp.num_rays_sparse_depth
            times = []
            if mode == "loop":
                for it in range(warmup + steps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    trainer.train_one_iter(it)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                times, it = times[warmup:], warmup + steps
                first_s = capture_s = None
            else:
                it = 0
                for _ in range(1 + graph_calls):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    trainer.train_many(it, steps)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) / steps)
                    it += steps
                first_s, times = times[0] * steps, times[1:]
                capture_s = trainer._graph.capture_s
            peak_gb = torch.cuda.max_memory_allocated() / 2**30
            reserved_gb = torch.cuda.max_memory_reserved() / 2**30
            prof = profile_steps(trainer, it, 3 if mode == "loop" else 10, graph=mode == "graph")
            trainer.logger.close()
            del trainer
        s = statistics.median(times)
        row = {"s_per_step": s, "rays_per_s": rays / s, "steps_timed": len(times),
               "min_s": min(times), "max_s": max(times), "peak_gb": peak_gb,
               "reserved_gb": reserved_gb, "busy": prof["device_ms_per_step"] / (s * 1e3), **prof}
        if mode == "graph":
            row.update(first_call_s=first_s, capture_s=capture_s)
        out[mode] = row
        print(f"train step ({mode}, {dname}): median {s * 1e3:.2f} ms over {len(times)} "
              f"{'steps' if mode == 'loop' else 'calls of ' + str(steps) + ' steps'} after "
              f"{'3 steps' if mode == 'loop' else 'one call'} of warm-up (min {min(times) * 1e3:.2f}, "
              f"max {max(times) * 1e3:.2f}); {rays / s:.0f} rays/s; device busy "
              f"{100 * row['busy']:.1f} % of the median step; peak device memory {peak_gb:.2f} GiB "
              f"allocated, {reserved_gb:.2f} GiB reserved"
              + (f"; first call {first_s:.2f} s, capture {capture_s:.3f} s" if mode == "graph" else ""),
              flush=True)
    fused_mlp.add_launches({k: n - fused_mlp.launch_counts()[k] for k, n in saved.items()})
    loop_k, graph_k = out["loop"]["csrc_kernels"], out["graph"]["csrc_kernels"]
    print(f"train step ({dname}): ops/csrc kernels per step, loop {loop_k}, replayed {graph_k}",
          flush=True)
    if not loop_k or graph_k != loop_k:
        fail("the replayed steps do not run the loop's kernels once per step each")
    return out


CSRC_KERNEL = re.compile(r"fused_mlp_\w*kernel|colsum_kernel")


def profile_steps(trainer, start: int, steps: int, graph: bool = False) -> dict:
    """Device time by kernel over `steps` training steps from `start`, one
    `train_one_iter` each or (`graph`) one `train_many` replaying a captured
    graph (torch.profiler's CUDA kernel events; the profiler's own host cost
    makes its wall clock no step time). `csrc_kernels`: the launches per
    step of each kernel of ops/csrc, by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if graph:
            trainer.train_many(start, steps)
        else:
            for it in range(start, start + steps):
                trainer.train_one_iter(it)
        torch.cuda.synchronize()
    kernels: dict = {}
    for e in prof.events():  # the spans' device ranges are no kernels
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            row = kernels.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3 / steps
            row[1] += 1
    rows = sorted(((ms, n / steps, name) for name, (ms, n) in kernels.items()), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    csrc: dict = {}
    for name, (_, n) in kernels.items():
        m = CSRC_KERNEL.search(name)
        if m:
            csrc[m.group(0)] = csrc.get(m.group(0), 0) + n / steps
    per_step = sum(r[1] for r in rows)
    print(f"profile ({'graph replays' if graph else 'loop'}): device kernel time per training step "
          f"{busy_ms:.2f} ms over {steps} steps, {per_step:g} kernels per step; by kernel:", flush=True)
    for ms, n, name in rows[:20]:
        print(f"profile:   {ms:9.3f} ms  x{n:<7g} {name[:110]}", flush=True)
    return {"device_ms_per_step": busy_ms, "kernels_per_step": per_step,
            "csrc_kernels": dict(sorted(csrc.items()))}


def make_scene(work: Path, h: int, w: int, dname: str = "bfloat16"):
    """The seeded synthetic scene (h x w, 6 frames, 3 for training; bench.py's
    size), its analytic depths as <work>/gt_depths/blobs/NNNN.npy (the
    pseudo-GT depths of the QA depth families), Configs.json for the
    published recipe in `dname`, the train-mode ModelConfigs.json and a checkpoint
    of seeded random weights, under `work`.
    Returns (db, runs, run_dir, cfg, model_configs)."""
    import numpy as np
    import torch

    from simplenerf_torch import config
    from simplenerf_torch.data.factory import get_data_loader
    from simplenerf_torch.data.preprocessor import ScenePreprocessor
    from simplenerf_torch.data.synthetic import generate_scene
    from simplenerf_torch.drivers import presets
    from simplenerf_torch.render import renderer
    from simplenerf_torch.training import checkpoints

    db, runs = work / "db", work / "runs"
    gt = generate_scene(db, scene_name="blobs", num_frames=6, h=h, w=w, num_train=3, seed=0)
    (work / "gt_depths/blobs").mkdir(parents=True, exist_ok=True)
    for f, depth in enumerate(gt["depths"]):
        np.save(work / f"gt_depths/blobs/{f:04}.npy", depth)
    cfg = presets.simplenerf_config(compute_dtype=dname, scene_id="blobs")
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


def frame_time(work: Path, dname: str, h: int = 189, w: int = 252, scale: int = 4) -> dict:
    """One 756x1008 request through `Tester.predict_frame` of the published
    recipe in `dname` on a fresh copy of the seeded scene under `work`, after
    a warm-up frame: seconds, the forward's launches and peak memory."""
    import numpy as np
    import torch

    from simplenerf_torch.ops import fused_mlp

    db, _, run_dir, cfg, mc = make_scene(work, h, w, dname)
    tester, pose, K = large_request(db, run_dir, cfg, mc, scale)
    saved = fused_mlp.fused_apply.launches
    tester.predict_frame(pose, intrinsic=K)
    torch.cuda.synchronize()
    before = fused_mlp.fused_apply.launches
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pred = tester.predict_frame(pose, intrinsic=K)
    torch.cuda.synchronize()
    t_frame = time.perf_counter() - t0
    launches = fused_mlp.fused_apply.launches - before
    fused_mlp.fused_apply.launches = saved  # these launches are not the main path's
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if pred["image"].shape != (h * scale, w * scale, 3) or not np.isfinite(pred["depth"]).all():
        fail(f"bad outputs for the {dname} full-resolution request")
    print(f"serve ({dname}): {h * scale}x{w * scale} request in {t_frame:.3f} s "
          f"({launches} kernel launches), peak device memory {peak_gb:.2f} GiB", flush=True)
    return {"frame_s": t_frame, "launches": launches, "peak_gb": peak_gb}


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
    fused_mlp.fused_apply.launches = fused_mlp.pe_operands.launches = 0
    t0 = time.perf_counter()
    if runner.start_testing({"train_num": 0, "test_num": 0}, db, runs, run_qa=False) != {}:
        fail("start_testing without QA returned scores")
    torch.cuda.synchronize()
    t_test = time.perf_counter() - t0
    test_launches = fused_mlp.fused_apply.launches
    frames = sorted(int(p.stem) for p in (runs / "testing/test0000/blobs/predicted_frames").glob("*.png"))
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
    pe_launches = fused_mlp.pe_operands.launches
    mlp_launches("serve", {"fused_apply": launches, "pe_operands": pe_launches})
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
    return {"launches": launches, "pe_launches": pe_launches, "frame_s": t_frame, "test_s": t_test,
            "frames": len(frames), "crop_err": crop_err}


PAR_STEPS = 6
WORKER = REPO / "tools/multiprocess_worker_torch.py"


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(work: Path, cfg_path: Path, db: Path, world: int, *extra: str) -> list:
    """`world` ranks of tools/multiprocess_worker_torch.py through
    `runner.start_training(mesh=)`, PAR_STEPS steps, with torchrun's
    environment; every rank must exit 0. Returns each rank's dump."""
    import numpy as np

    port = str(free_port())
    procs = []
    try:
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), "--config", str(cfg_path), "--db", str(db),
                 "--out", str(work), "--steps", str(PAR_STEPS), "--dump", str(work / "run"),
                 *extra],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0 or f"RANK {rank} OK" not in log:
            print(log[-6000:], file=sys.stderr, flush=True)
            fail(f"rank {rank} of {world} exited {p.returncode}")
    return [dict(np.load(work / f"run.rank{r}.npz")) for r in range(world)]


def parallel(work: Path, card: str, device: str = "cuda") -> dict:
    """Ray-sharded training on the serve scene, the published bf16 recipe of
    phase `train`, PAR_STEPS steps: (a) the in-process Trainer without a
    mesh; (b) one NCCL rank in a subprocess through initialize_distributed,
    make_mesh and runner.start_training(mesh=); (c) two gloo ranks sharing
    the card, rank 0 rendering the 2048 NeRF rows and rank 1 the 2048
    sparse-depth rows. Step 1's flat gradient and every step's loss values
    of (b) and (c) are held against (a); each rank's counters must read one
    launch of each kernel per step. Returns the phase's readings."""
    import numpy as np
    import torch

    from simplenerf_torch.data.factory import get_data_loader
    from simplenerf_torch.data.preprocessor import ScenePreprocessor
    from simplenerf_torch.training.trainer import Trainer

    db, pdir = work / "db", work / "parallel"
    cfg = train_config(num_iterations=PAR_STEPS)
    cfg["resume_training"] = False
    dl = cfg["data_loader"]
    rays = dl["num_rays"] + dl["sparse_depth"]["num_rays"]
    pdir.mkdir(parents=True, exist_ok=True)
    cfg_path = pdir / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))

    # (a) The reference: one process, no mesh.
    t0 = time.perf_counter()
    raw = get_data_loader(cfg, db, "train").load_data()
    pp = ScenePreprocessor(cfg, "train", raw, device=device, seed=cfg.get("seed", 0))
    trainer = Trainer(cfg, pdir / "a", pp)
    grads = []
    gradient = trainer.opt.gradient
    trainer.opt.gradient = lambda leaves: grads.append(gradient(leaves)) or grads[-1]
    ref, ends = [], []
    for it in range(PAR_STEPS):
        ref.append({k: float(v) for k, v in trainer.train_one_iter(it).items()})  # synchronizes
        ends.append(time.perf_counter())
    ref_grad = grads[0].cpu().numpy()
    ref_params = torch.cat([p.detach().reshape(-1) for p in trainer.leaves]).cpu().numpy()
    n_params, n_values = ref_grad.size, len(ref[0])
    trainer.logger.close()
    del trainer, pp, grads
    if device == "cuda":
        torch.cuda.empty_cache()
    s_a = statistics.median(np.diff(ends))
    print(f"parallel (a): {PAR_STEPS} steps in-process in {time.perf_counter() - t0:.1f} s incl. "
          f"set-up, {s_a:.4f} s per step", flush=True)

    def held(label: str, dump: dict, chunk: int = 1) -> dict:
        """Step 1's gradient and the loss values of every logged step (each
        chunk's last) against (a)'s."""
        got_grad = dump["grad1"]
        grad_err = float(np.abs(got_grad - ref_grad).max() / np.abs(ref_grad).max())
        names = [str(n) for n in dump["names"]]
        iters = [int(i) for i in dump["iters"]]
        if (iters != list(range(chunk, PAR_STEPS + 1, chunk)) or set(names) != set(ref[0])
                or dump["values"].shape != (len(iters), n_values)):
            fail(f"parallel {label}: loss values {dump['values'].shape} at {iters} {names}")
        loss_err = 0.0
        for it, row in zip(iters, dump["values"]):
            for k, v in zip(names, row):
                want = ref[it - 1][k]
                if not math.isfinite(v):
                    fail(f"parallel {label}: {k} not finite at step {it}")
                loss_err = max(loss_err, abs(v - want) / max(abs(want), 1e-12))
        launches = json.loads(str(dump["launches"]))
        return {"grad_err": grad_err, "grad_equal": bool(np.array_equal(got_grad, ref_grad)),
                "loss_err": loss_err,
                "losses_equal": all(ref[it - 1][k] == v for it, row in zip(iters, dump["values"])
                                    for k, v in zip(names, row)),
                "params_equal": bool(np.array_equal(dump["params"], ref_params)),
                "params_max_abs_diff": float(np.abs(dump["params"] - ref_params).max()),
                "launches": launches, "s_per_step": float(np.median(np.diff(dump["t"])))}

    # (b) One NCCL rank through the mesh path of start_training, its steps
    # one chunk: on the card, a warm-up step and a CUDA graph's replays.
    t0 = time.perf_counter()
    b_dev = () if device == "cuda" else ("--device", device)
    (b,) = run_ranks(pdir / "b", cfg_path, db, 1, *b_dev, "--steps-per-call", str(PAR_STEPS))
    t_b = time.perf_counter() - t0
    # (c) Two gloo ranks on the one card (NCCL refuses two ranks per device).
    t0 = time.perf_counter()
    c_dev = ("--device", "cuda:0", "--backend", "gloo") if device == "cuda" else ("--device", device)
    c = run_ranks(pdir / "c", cfg_path, db, 2, *c_dev)
    t_c = time.perf_counter() - t0
    for d in c[1:]:
        for k in ("params", "mu", "nu", "grad1", "values"):
            if not np.array_equal(d[k], c[0][k]):
                fail(f"parallel (c): the ranks' {k} differ")
    readings = {"b": held("(b)", b, PAR_STEPS),
                "c": [held(f"(c) rank {r}", d) for r, d in enumerate(c)]}
    tol = STEP_TOL["bfloat16"]
    for label, r in [("(b)", readings["b"])] + [(f"(c) rank {i}", x) for i, x in enumerate(readings["c"])]:
        print(f"parallel {label}: step 1 gradient max abs err / largest {r['grad_err']:.3e} "
              f"(equal to the bit: {r['grad_equal']}), loss values worst rel err {r['loss_err']:.3e} "
              f"(equal: {r['losses_equal']}; tol {tol:g}), parameters after step {PAR_STEPS} equal "
              f"to (a)'s: {r['params_equal']} (max abs diff {r['params_max_abs_diff']:.3e}), "
              f"{r['s_per_step']:.4f} s per step, launches {r['launches']}", flush=True)
        if not (r["grad_err"] <= tol and r["loss_err"] <= tol):
            fail(f"parallel {label} disagrees with the one-process run")
        if any(n != PAR_STEPS for n in mlp_launches(f"parallel {label}", r["launches"]).values()):
            fail(f"parallel {label}: expected {PAR_STEPS} launches of each kernel, got {r['launches']}")
    launches = {k: readings["b"]["launches"][k] + sum(r["launches"][k] for r in readings["c"])
                for k in readings["b"]["launches"]}
    out = {
        "steps": PAR_STEPS, "rays_per_step": rays, "rows_per_rank_c": rays // 2,
        "s_per_step": {"a": s_a, "b": readings["b"]["s_per_step"],
                       "c": [r["s_per_step"] for r in readings["c"]]},
        "s_subprocess": {"b": t_b, "c": t_c},
        "all_reduce_bytes_per_step": 4 * (n_params + n_values),
        "grad_err": {"b": readings["b"]["grad_err"], "c": readings["c"][0]["grad_err"]},
        "loss_err": {"b": readings["b"]["loss_err"], "c": readings["c"][0]["loss_err"]},
        "equal_to_the_bit_b": {"grad": readings["b"]["grad_equal"],
                               "losses": readings["b"]["losses_equal"],
                               "params": readings["b"]["params_equal"]},
        "launches": launches, "card": card,
        "note": "(c) is two gloo ranks on one card (host-staged reduction): not a scaling number",
    }
    print(f"parallel: (b) in {t_b:.1f} s, (c) in {t_c:.1f} s incl. start-up; all_reduce_sum moves "
          f"{out['all_reduce_bytes_per_step']} B per step per rank; launches {launches}", flush=True)
    return out




PIPE_STEPS, PIPE_VAL_INTERVAL, VIDEO_POSES = 20, 10, 4


@contextlib.contextmanager
def timed_calls(owner, attr: str):
    """Wrap owner.<attr> so that each call appends {"s", "fwd_launches",
    "args", "kwargs"} to the yielded list: host seconds between
    synchronisations and the forward kernel's launches during the call."""
    import torch

    from simplenerf_torch.ops import fused_mlp

    orig, log = getattr(owner, attr), []

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        n0, t0 = fused_mlp.fused_apply.launches, time.perf_counter()
        out = orig(*args, **kwargs)
        torch.cuda.synchronize()
        log.append({"s": time.perf_counter() - t0, "fwd_launches": fused_mlp.fused_apply.launches - n0,
                    "args": args, "kwargs": kwargs})
        return out

    setattr(owner, attr, wrapper)
    try:
        yield log
    finally:
        setattr(owner, attr, orig)


def pipeline(work: Path, card: str, h: int = 189, w: int = 252) -> dict:
    """The LLFF experiment's flow, `drivers.llff.run` (what `llff.main` runs),
    on a fresh copy of the seeded synthetic scene that `make_scene` wrote
    under `work` with the published bf16 recipe: 20 training steps with
    validation every 10 (loss maps on), a torch.profiler window over steps
    12-13, then testing with QA (the scene's GT depths, VM02 masks from the
    port's generate_visibility_masks) and both videos along a 4-pose spiral
    from the port's create_spiral_video_poses. Checks every output; returns
    its readings."""
    import numpy as np
    import torch

    from simplenerf_torch.data import io
    from simplenerf_torch.data.preprocessor import gather_batch
    from simplenerf_torch.data.factory import get_data_loader
    from simplenerf_torch.dataset_tools import video_poses
    from simplenerf_torch.drivers import llff, runner
    from simplenerf_torch.ops import fused_mlp
    from simplenerf_torch.qa.masks import MaskComputer, generate_visibility_masks
    from simplenerf_torch.qa.runner import ALL_METRICS, QARunner
    from simplenerf_torch.training.trainer import Trainer, render_in_chunks

    t0 = time.perf_counter()
    db, runs, gt_depths = work / "pipeline/db", work / "pipeline/runs", work / "gt_depths"
    shutil.copytree(work / "db", db)
    train_cfg, test_cfg = llff.build_configs(2, ["blobs"], PIPE_STEPS, "bfloat16", 0)
    train_cfg.update(validation_interval=PIPE_VAL_INTERVAL, validation_save_loss_maps=True,
                     log_interval=10, profiling={"start_iter": 12, "num_iters": 2})
    scene_dir = db / "all/database_data/blobs"
    extrinsics = np.loadtxt(scene_dir / "CameraExtrinsics.csv", delimiter=",").reshape(-1, 4, 4)
    intrinsics = np.loadtxt(scene_dir / "CameraIntrinsics_down4.csv", delimiter=",").reshape(-1, 3, 3)
    scene_cfg = {**train_cfg, "data_loader": {**train_cfg["data_loader"], "scene_id": "blobs"}}
    split = {mode: [int(f) for f in get_data_loader(scene_cfg, db, mode).get_frame_nums()]
             for mode in ("train", "validation", "test")}

    def frame(f):
        return {"frame": io.read_image(scene_dir / f"rgb_down4/{f:04}.png"),
                "depth": np.load(gt_depths / f"blobs/{f:04}.npy"),
                "extrinsic": extrinsics[f], "intrinsic": intrinsics[f]}

    train_frames = {f: frame(f) for f in split["train"]}
    test_frames = {f: frame(f) for f in split["test"]}
    generate_visibility_masks(db / "all/visibility_masks/VM02", "blobs", train_frames, test_frames)
    # One test frame's VM02 masks through the native splat and through its
    # numpy plain version, each timed; both equal the files just written.
    f_test = split["test"][0]
    test = test_frames[f_test]
    splat = {"frame": f_test, "views": len(train_frames), "pixels": h * w}
    for label, computer in (("native", MaskComputer()), ("plain", MaskComputer(plain=True))):
        t1 = time.perf_counter()
        got = [computer.compute_mask(fr["frame"], fr["depth"], test["depth"], fr["extrinsic"],
                                     test["extrinsic"], fr["intrinsic"], test["intrinsic"])
               for fr in train_frames.values()]
        splat[f"{label}_s"] = time.perf_counter() - t1
        for f, m in zip(train_frames, got):
            saved = np.load(db / f"all/visibility_masks/VM02/blobs/visibility_masks/{f_test:04}_{f:04}.npy")
            if not np.array_equal(m, saved):
                fail(f"VM02 mask {f_test:04}_{f:04} through the {label} splat differs from the file")
    print(f"pipeline: VM02 masks of test frame {f_test} ({len(train_frames)} views, {h}x{w}): "
          f"native splat {splat['native_s']:.3f} s, numpy plain version {splat['plain_s']:.3f} s, "
          f"equal", flush=True)
    bds = np.loadtxt(scene_dir / "DepthBounds.csv", delimiter=",")
    spiral = video_poses.create_spiral_video_poses(extrinsics[split["train"]],
                                                   [bds.min(), bds.max()],
                                                   num_frames=VIDEO_POSES - 1)
    video_poses.save_video_poses(db, "blobs", spiral)
    print(f"pipeline: scene copied, VM02 masks and a {len(spiral)}-pose spiral in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    counters = (fused_mlp.fused_apply_ensemble, fused_mlp.fused_ens_bwd, fused_mlp.fused_apply,
                fused_mlp.fused_bwd, fused_mlp.pe_operands)
    with timed_calls(Trainer, "run_validation") as val_log, \
            timed_calls(QARunner, "run") as qa_log, \
            timed_calls(runner, "start_training") as train_log, \
            timed_calls(runner, "start_testing") as test_log, \
            timed_calls(runner, "start_testing_videos") as video_log:
        # The main path: counters at 0 just before, read just after.
        for f in counters:
            f.launches = 0
        t0 = time.perf_counter()
        scores = llff.run(train_cfg, test_cfg, db, runs, gt_depth_dir=gt_depths)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        launches = {f.__name__: f.launches for f in counters}
    print(f"pipeline: llff.run in {t_run:.1f} s (start_training {train_log[0]['s']:.1f} s, "
          f"start_testing {test_log[0]['s']:.1f} s, videos "
          + ", ".join(f"{c['s']:.1f}" for c in video_log) + f" s); launches {launches}; "
          f"QA scores {scores}", flush=True)
    if not all(launches.values()):
        fail(f"a kernel of the path was not launched: {launches}")
    mlp_launches("pipeline", launches)

    # Validation: two rounds over 3 train + 1 validation frames, one chunk each.
    run_num = llff.VIEWS_TO_SET[2][1]
    scene = runs / f"training/train{run_num:04}/blobs"
    rounds = list(range(PIPE_VAL_INTERVAL, PIPE_STEPS + 1, PIPE_VAL_INTERVAL))
    frames = split["train"] + split["validation"]
    chunks = -(-(h * w) // CHUNK_RAYS)
    val_launches = sum(c["fwd_launches"] for c in val_log)
    if len(val_log) != len(rounds) or val_launches != 2 * chunks * len(frames) * len(rounds):
        fail(f"{len(val_log)} validation rounds made {val_launches} forward launches, expected "
             f"{2 * chunks * len(frames) * len(rounds)} in {len(rounds)}")
    samples = scene / "samples"
    map_names = None
    for it in rounds:
        for f in frames:
            for level in ("coarse", "fine"):
                for rel in (f"predicted_frames/{f:04}_{level}_Iter{it:05}.png",
                            f"predicted_depths/{f:04}_{level}_Iter{it:05}.npy",
                            f"predicted_depths/{f:04}_{level}_ndc_Iter{it:05}.npy",
                            f"predicted_depths_variance/{f:04}_{level}_Iter{it:05}.npy",
                            f"predicted_depths_variance/{f:04}_{level}_ndc_Iter{it:05}.npy"):
                    if not (samples / rel).exists():
                        fail(f"validation output missing: {rel}")
                    if rel.endswith(".npy") and not np.isfinite(np.load(samples / rel)).all():
                        fail(f"validation output not finite: {rel}")
            mine = sorted(p.name.split(f"_{f:04}_Iter")[0]
                          for p in samples.glob(f"Losses/*_{f:04}_Iter{it:05}.npy"))
            if map_names is None:
                map_names = mine
            if mine != map_names or not {"MSE01_coarse", "MSE01_fine"} <= set(mine):
                fail(f"loss maps of frame {f} at {it}: {mine}")
            for name in mine:
                m = np.load(samples / f"Losses/{name}_{f:04}_Iter{it:05}.npy")
                if m.shape != (h, w) or not np.isfinite(m).all():
                    fail(f"loss map {name} of frame {f} at {it} is bad")
    scalars = [json.loads(r) for r in (scene / "logs/scalars.jsonl").read_text().splitlines()]
    # Seconds from the logger's start to each training log row (steps 1-10
    # take the first call's set-up; 11-20 hold the trace window).
    log_s = {r["iter"]: r["time"] for r in scalars if "rays_per_s" in r}
    val_psnr = {k: r[k] for r in scalars for k in r if k.endswith("/psnr")}
    if set(val_psnr) != {"validation/train_images/psnr", "validation/val_images/psnr"} or \
            not all(math.isfinite(v) for v in val_psnr.values()):
        fail(f"validation scalars missing or not finite: {val_psnr}")

    # A validation frame re-rendered as the last round rendered it (its PNG),
    # held against Tester.predict_frame's render at the same pose and against
    # the plain versions. No launch here counts for the path.
    saved = {f: f.launches for f in counters}
    trainer = val_log[-1]["args"][0]
    pp, f0 = trainer.train_pp, frames[0]
    idx, mask, _ = pp.next_indices(0, image_num=f0)
    batch = gather_batch(pp.cache, pp.common, pp.batch_constants(),
                         torch.as_tensor(idx, device=pp.device), torch.as_tensor(mask, device=pp.device),
                         None)
    chunk = train_cfg["validation_chunk_size"]
    with torch.no_grad():
        val_rgb = render_in_chunks(trainer._eval_step_vis, trainer.params, batch, chunk)["rgb_fine"]
        with plain_versions():
            plain_rgb = render_in_chunks(trainer._eval_step_vis, trainer.params, batch, chunk)["rgb_fine"]
    png = io.read_image(samples / f"predicted_frames/{f0:04}_fine_Iter{rounds[-1]:05}.png").astype(int)
    mine = np.round(np.clip(val_rgb.float().cpu().numpy(), 0, 1) * 255).reshape(h, w, 3)
    if np.abs(png - mine).max() > 1:
        fail("the re-rendered validation frame differs from the one validation wrote")
    tester = runner.load_scene_tester(runs / f"training/train{run_num:04}", "blobs", test_cfg)
    test_batch = tester.preprocessor.create_test_data(extrinsics[f0], intrinsic=intrinsics[f0])
    test_rgb = render_in_chunks(tester._eval_step, tester.params, test_batch, tester.chunk)["rgb_fine"]
    tester_err = (val_rgb.float() - test_rgb.float()).abs().max().item()
    plain_err = (val_rgb.float() - plain_rgb.float()).abs().max().item()
    for f, n in saved.items():
        f.launches = n
    print(f"pipeline: validation frame {f0} fine rgb vs Tester.predict_frame's render at its pose "
          f"max abs err {tester_err:.3e}, vs the plain versions {plain_err:.3e} (tol {CROP_TOL:g})",
          flush=True)
    if not tester_err <= CROP_TOL:
        fail("a validation frame disagrees with Tester.predict_frame at its pose")
    if not plain_err <= CROP_TOL:
        fail("a validation frame through the kernels disagrees with the plain versions")

    # QA: every family scored and finite, or skipped with its reason; the
    # LPIPS pair only when the lpips package is missing.
    test_dir = runs / f"testing/test{run_num:04}"
    qa = json.loads((test_dir / "QA_Scores.json").read_text())
    skipped = qa.get("skipped", {})
    for name in ALL_METRICS:
        if name in qa:
            ok = math.isfinite(qa[name])
        else:  # with masks and GT depths, only LPIPS may lack its package
            ok = name.endswith("LPIPS") and bool(skipped.get(name))
        if not ok:
            fail(f"QA family {name}: score {qa.get(name)}, skipped {skipped.get(name)!r}")
    for name in ("PredictedVideo", "StaticCameraVideo"):
        got = sorted(p.name for p in (test_dir / f"blobs/{name}").glob("*.png"))
        if got != [f"{i:04}.png" for i in range(VIDEO_POSES)]:
            fail(f"{name} has frames {got}, expected {VIDEO_POSES}")
    traces = list((scene / "profile").glob("*.json"))
    if not traces:
        fail("the profiling window wrote no trace")
    events = json.loads(traces[0].read_text())["traceEvents"]
    device_events = sum(e.get("cat") == "kernel" for e in events)
    if not device_events:
        fail("the trace holds no kernel of the device")

    out = {
        "s_per_validation_round": [c["s"] for c in val_log],
        "validation_fwd_launches": val_launches,
        "qa_s_per_scene": qa_log[0]["s"] / len(qa_log[0]["args"][0].scene_names),
        "s_per_video_frame": {("static" if c["kwargs"].get("static_camera") else "spiral"):
                              c["s"] / VIDEO_POSES for c in video_log},
        "llff_run_s": t_run, "start_training_s": train_log[0]["s"],
        "start_testing_s": test_log[0]["s"], "videos_s": [c["s"] for c in video_log],
        "train_log_s": log_s,
        "launches": launches, "trace_kernel_events": device_events,
        "tester_err": tester_err, "plain_err": plain_err, "vm02_splat": splat,
        "qa": {k: v for k, v in qa.items() if k != "skipped"}, "qa_skipped": skipped, "card": card,
    }
    print(f"pipeline: {', '.join(f'{s:.3f}' for s in out['s_per_validation_round'])} s per validation "
          f"round ({len(frames)} frames), {out['qa_s_per_scene']:.3f} s of QA per scene, "
          f"s per video frame {out['s_per_video_frame']}; {device_events} kernel events in the trace",
          flush=True)
    return out


RE_STEPS, RE_FRAMES, RE_H, RE_W = 20, 20, 54, 96


def realestate(work: Path, card: str) -> dict:
    """The RealEstate10K experiment, `drivers.realestate.run` (what
    `realestate.main` runs), on a seeded RE10K-layout scene from the port's
    `generate_realestate_scene` (20 frames of RE_H x RE_W, 3 for training,
    3 in the test CSV): the published bf16 recipe of `build_configs(3)` cut
    to 20 steps, testing with QA against the scene's GT depths and VM02
    masks under test/visibility_masks/, and one 4-pose video from the set
    directory's pose CSV. Checks every output; returns its readings."""
    import numpy as np
    import torch

    from simplenerf_torch.data import io
    from simplenerf_torch.data.synthetic import generate_realestate_scene
    from simplenerf_torch.dataset_tools import video_poses
    from simplenerf_torch.drivers import realestate as re_driver, runner
    from simplenerf_torch.ops import fused_mlp
    from simplenerf_torch.qa.masks import generate_visibility_masks
    from simplenerf_torch.qa.runner import ALL_METRICS, QARunner
    from simplenerf_torch.training.trainer import render_in_chunks

    t0 = time.perf_counter()
    db, runs, gt_depths = work / "re10k/db", work / "re10k/runs", work / "re10k/gt_depths"
    gt = generate_realestate_scene(db, scene_num=0, num_frames=RE_FRAMES, h=RE_H, w=RE_W,
                                   num_train=3, seed=0, max_test_frames=3)
    train_f, test_f = [int(f) for f in gt["train_frames"]], [int(f) for f in gt["test_frames"]]
    (gt_depths / "00000").mkdir(parents=True)
    for f in test_f:
        np.save(gt_depths / f"00000/{f:04}.npy", gt["depths"][f])

    def frame(f):
        return {"frame": np.round(gt["images"][f] * 255).astype(np.uint8), "depth": gt["depths"][f],
                "extrinsic": gt["extrinsics"][f], "intrinsic": gt["intrinsic"]}

    generate_visibility_masks(db / "test/visibility_masks/VM02", "00000",
                              {f: frame(f) for f in train_f}, {f: frame(f) for f in test_f})
    set_num, run_num = re_driver.VIEWS_TO_SET[3]
    poses = video_poses.create_spiral_video_poses(gt["extrinsics"][train_f], [1.0, 100.0],
                                                  num_frames=VIDEO_POSES - 1)
    pose_dir = db / f"train_test_sets/set{set_num:02}/video_poses01"
    pose_dir.mkdir(parents=True)
    np.savetxt(pose_dir / "00000.csv", poses.reshape(len(poses), 16), delimiter=",")
    t_setup = time.perf_counter() - t0
    print(f"realestate: {RE_FRAMES}-frame {RE_H}x{RE_W} scene, GT depths, VM02 masks and a "
          f"{len(poses)}-pose video CSV in {t_setup:.1f} s", flush=True)

    train_cfg, test_cfg = re_driver.build_configs(3, [0], RE_STEPS, "bfloat16", 0)
    train_cfg["log_interval"] = 10
    counters = (fused_mlp.fused_apply_ensemble, fused_mlp.fused_ens_bwd, fused_mlp.fused_apply,
                fused_mlp.fused_bwd, fused_mlp.pe_operands)
    with timed_calls(QARunner, "run") as qa_log, \
            timed_calls(runner, "start_training") as train_log, \
            timed_calls(runner, "start_testing") as test_log, \
            timed_calls(runner, "start_testing_videos") as video_log:
        # The main path: counters at 0 just before, read just after.
        for f in counters:
            f.launches = 0
        t0 = time.perf_counter()
        scores = re_driver.run(train_cfg, test_cfg, db, runs, gt_depth_dir=gt_depths)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        launches = {f.__name__: f.launches for f in counters}
    eval_launches = {"test": test_log[0]["fwd_launches"], "video": video_log[0]["fwd_launches"]}
    train_launches = {**mlp_launches("realestate", launches),
                      "fused_apply": launches["fused_apply"] - sum(eval_launches.values())}
    print(f"realestate: realestate.run in {t_run:.1f} s (start_training {train_log[0]['s']:.1f} s, "
          f"start_testing {test_log[0]['s']:.1f} s, video {video_log[0]['s']:.1f} s); training "
          f"launches {train_launches}, forward launches in testing and the video {eval_launches}; "
          f"QA scores {scores}", flush=True)
    if any(n != RE_STEPS for n in train_launches.values()):
        fail(f"expected {RE_STEPS} training launches of each kernel, got {train_launches}")
    chunks = -(-(RE_H * RE_W) // CHUNK_RAYS)
    want_eval = {"test": 2 * chunks * len(test_f), "video": 2 * chunks * VIDEO_POSES}
    if eval_launches != want_eval:
        fail(f"forward launches in testing and the video {eval_launches}, expected {want_eval}")

    scene = runs / f"training/train{run_num:04}/00000"
    mc = json.loads((scene / "ModelConfigs.json").read_text())
    if not np.allclose(mc["bounds"], np.array([1.0, 100.0]) / 0.75):
        fail(f"RealEstate10K bounds {mc['bounds']}, expected [1, 100] / 0.75")
    rows = [json.loads(r) for r in (scene / "logs/scalars.jsonl").read_text().splitlines()]
    losses = {k: r[k] for r in rows for k in loss_keys(r)}
    if len(losses) != 10 or not all(math.isfinite(v) for v in losses.values()):
        fail(f"RealEstate10K training losses missing or not finite: {losses}")
    test_dir = runs / f"testing/test{run_num:04}"
    qa = json.loads((test_dir / "QA_Scores.json").read_text())
    skipped = qa.get("skipped", {})
    for name in ALL_METRICS:
        ok = math.isfinite(qa[name]) if name in qa else name.endswith("LPIPS") and bool(skipped.get(name))
        if not ok:
            fail(f"RealEstate10K QA family {name}: score {qa.get(name)}, skipped {skipped.get(name)!r}")
    got = sorted(p.name for p in (test_dir / "00000/PredictedVideo").glob("*.png"))
    if got != [f"{i:04}.png" for i in range(VIDEO_POSES)]:
        fail(f"the RealEstate10K video has frames {got}, expected {VIDEO_POSES}")

    # One test frame rendered again through the kernels (it must give the
    # written PNG) and through the plain versions. No launch here counts.
    saved = {f: f.launches for f in counters}
    tester = runner.load_scene_tester(runs / f"training/train{run_num:04}", 0, test_cfg)
    f0 = test_f[0]
    batch = tester.preprocessor.create_test_data(gt["extrinsics"][f0], intrinsic=gt["intrinsic"])
    kern = render_in_chunks(tester._eval_step, tester.params, batch, tester.chunk)["rgb_fine"]
    with plain_versions():
        plain = render_in_chunks(tester._eval_step, tester.params, batch, tester.chunk)["rgb_fine"]
    for f, n in saved.items():
        f.launches = n
    plain_err = (kern.float() - plain.float()).abs().max().item()
    png = io.read_image(test_dir / f"00000/predicted_frames/{f0:04}.png").astype(int)
    mine = np.round(np.clip(kern.float().cpu().numpy(), 0, 1) * 255).reshape(RE_H, RE_W, 3)
    print(f"realestate: test frame {f0} fine rgb, kernels vs plain versions max abs err "
          f"{plain_err:.3e} (tol {CROP_TOL:g})", flush=True)
    if np.abs(png - mine).max() > 1:
        fail("the re-rendered RealEstate10K test frame differs from the one testing wrote")
    if not plain_err <= CROP_TOL:
        fail("a RealEstate10K test frame through the kernels disagrees with the plain versions")
    out = {
        "scene": f"{RE_FRAMES} frames {RE_H}x{RE_W}", "setup_s": t_setup, "run_s": t_run,
        "train_s": train_log[0]["s"], "s_per_test_frame": test_log[0]["s"] / len(test_f),
        "qa_s": qa_log[0]["s"], "s_per_video_frame": video_log[0]["s"] / VIDEO_POSES,
        "launches": launches, "train_launches": train_launches, "eval_launches": eval_launches,
        "plain_err": plain_err, "qa": {k: v for k, v in qa.items() if k != "skipped"},
        "qa_skipped": skipped, "bounds": mc["bounds"], "card": card,
    }
    print(f"realestate: {out['train_s']:.2f} s of training, {out['s_per_test_frame']:.3f} s per test "
          f"frame, {out['qa_s']:.3f} s of QA, {out['s_per_video_frame']:.3f} s per video frame",
          flush=True)
    return out


PRIORS_STEPS, PRIORS_VAL_CHUNK = 20, 16 * 1024


def priors_config(**overrides) -> dict:
    """The published recipe (train_config) with a visibility head on the
    coarse and fine main MLPs, the dense-depth and visibility losses and
    their prior data, 20 steps, one validation round at 20 with loss maps."""
    from simplenerf_torch.drivers import presets

    cfg = presets.with_visibility_priors(train_config(**{"num_iterations": PRIORS_STEPS, **overrides}))
    cfg.update(validation_interval=PRIORS_STEPS, validation_save_loss_maps=True,
               validation_chunk_size=PRIORS_VAL_CHUNK)
    return cfg


@contextlib.contextmanager
def recorded(owner, attr: str, keep):
    """Wrap owner.<attr> so that each call appends keep(args, result) to the
    yielded list."""
    orig, log = getattr(owner, attr), []

    def wrapper(*args, **kwargs):
        out = orig(*args, **kwargs)
        log.append(keep(args, out))
        return out

    setattr(owner, attr, wrapper)
    try:
        yield log
    finally:
        setattr(owner, attr, orig)


def priors(work: Path, card: str) -> dict:
    """Visibility heads and the prior losses in training: on a copy of the
    serve phase's scene with dense depths (the analytic depths) and
    visibility-prior masks (the port's qa.masks splat, 3 x 2 between the
    train frames) written, `runner.start_training` of priors_config for 20
    steps with one validation round at 20. Checks the launches, the views
    head widths the kernels were given, one step's gradients against the
    plain versions, the loss values, and the secondary-view visibility path
    on a train frame; returns the readings."""
    import numpy as np
    import torch

    from simplenerf_torch.data import io
    from simplenerf_torch.data.factory import get_data_loader
    from simplenerf_torch.data.preprocessor import gather_batch
    from simplenerf_torch.data.synthetic import write_scene_priors
    from simplenerf_torch.drivers import runner
    from simplenerf_torch.losses.visibility import make_visibility_prior_loss
    from simplenerf_torch.ops import fused_mlp
    from simplenerf_torch.training.trainer import Trainer, build_eval_renderer, render_in_chunks

    t0 = time.perf_counter()
    db, runs = work / "priors/db", work / "priors/runs"
    shutil.copytree(work / "db", db)
    scene_dir = db / "all/database_data/blobs"
    extrinsics = np.loadtxt(scene_dir / "CameraExtrinsics.csv", delimiter=",").reshape(-1, 4, 4)
    K = np.loadtxt(scene_dir / "CameraIntrinsics_down4.csv", delimiter=",").reshape(-1, 3, 3)[0]
    cfg = priors_config()
    scene_cfg = {**cfg, "data_loader": {**cfg["data_loader"], "scene_id": "blobs"}}
    train_f = [int(f) for f in get_data_loader(scene_cfg, db, "train").get_frame_nums()]
    images = {f: io.read_image(scene_dir / f"rgb_down4/{f:04}.png") for f in train_f}
    depths = {f: np.load(work / f"gt_depths/blobs/{f:04}.npy") for f in train_f}
    write_scene_priors(db, "blobs", train_f, images, depths, extrinsics, K)
    t_setup = time.perf_counter() - t0
    print(f"priors: scene copied, dense depths and {len(train_f) * (len(train_f) - 1)} visibility-"
          f"prior masks written in {t_setup:.1f} s", flush=True)

    counters = (fused_mlp.fused_apply_ensemble, fused_mlp.fused_ens_bwd, fused_mlp.fused_apply,
                fused_mlp.fused_bwd, fused_mlp.pe_operands)
    with timed_calls(Trainer, "run_validation") as val_log, \
            recorded(fused_mlp, "_launch_fwd",
                     lambda a, _: tuple(m.out_v for m in getattr(a[0], "members", (a[0],)))) as widths, \
            recorded(Trainer, "body", lambda a, v: float(v["VisibilityPriorLoss01"])) as prior_losses:
        # The main path: counters at 0 just before, read just after.
        for f in counters:
            f.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run_dir = runner.start_training(cfg, db, runs)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        launches = {f.__name__: f.launches for f in counters}
    val_launches = sum(c["fwd_launches"] for c in val_log)
    train_launches = {**mlp_launches("priors", launches),
                      "fused_apply": launches["fused_apply"] - val_launches}
    print(f"priors: start_training, {PRIORS_STEPS} steps with visibility heads and the prior losses "
          f"in {t_train:.1f} s incl. set-up (validation {val_log[0]['s']:.2f} s); training launches "
          f"{train_launches}, {val_launches} forward launches in validation; views head widths the "
          f"kernels were given {sorted(set(widths))}; peak device memory {peak_gb:.2f} GiB", flush=True)
    if len(val_log) != 1 or any(n != PRIORS_STEPS for n in train_launches.values()):
        fail(f"expected {PRIORS_STEPS} training launches of each kernel and one validation round, "
             f"got {train_launches} and {len(val_log)}")
    if set(widths) != {(4,), (4, 3, 0)}:
        fail(f"views head widths {sorted(set(widths))}: the fine and trio programs need a 4-channel head")
    if len(prior_losses) != PRIORS_STEPS or any(v != 0.0 for v in prior_losses):
        fail(f"VisibilityPriorLoss01 in training {prior_losses}: the JAX package's train step gives 0")
    scene = run_dir / "blobs"
    rows = [json.loads(r) for r in (scene / "logs/scalars.jsonl").read_text().splitlines()]
    train_rows = [r for r in rows if "rays_per_s" in r]
    for r in train_rows:
        for k in ("DenseDepthMSE01", "VisibilityLoss01"):
            if not (math.isfinite(r[k]) and r[k] > 0):
                fail(f"{k} at step {r['iter']} is {r[k]}")
    val = {k: v for r in rows for k, v in r.items() if k.startswith("validation/")}
    for tag in ("train_images", "val_images"):
        v = val.get(f"validation/{tag}/VisibilityPriorLoss01")
        if v is None or not math.isfinite(v):
            fail(f"VisibilityPriorLoss01 in the validation scalars: {v}")
    losses_dir = scene / "samples/Losses"
    for name in ("DenseDepthMSE01_coarse", "DenseDepthMSE01_fine"):
        if not list(losses_dir.glob(f"{name}_*_Iter{PRIORS_STEPS:05}.npy")):
            fail(f"no {name} loss map in validation")

    # The secondary-view visibility path (the unfused MLP per secondary
    # view), which neither validation nor the Tester takes: a train frame's
    # rays with the other train frames' origins, its visibility2 and
    # VisibilityPriorLoss01 against the prior masks. No launch here counts.
    saved = {f: f.launches for f in counters}
    trainer = val_log[0]["args"][0]
    pp, f0 = trainer.train_pp, train_f[0]
    idx, mask, _ = pp.next_indices(0, image_num=f0)
    batch = gather_batch(pp.cache, pp.common, pp.batch_constants(),
                         torch.as_tensor(idx, device=pp.device), torch.as_tensor(mask, device=pp.device),
                         None)
    tester = runner.load_scene_tester(run_dir, "blobs", {})
    others = [extrinsics[f] for f in train_f if f != f0]
    batch["rays_o2"] = tester.preprocessor.create_test_data(extrinsics[f0], secondary_poses=others,
                                                            intrinsic=K)["rays_o2"]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = render_in_chunks(build_eval_renderer(trainer.render_cfg, sec_views_vis=True),
                               trainer.params, batch, PRIORS_VAL_CHUNK)
    torch.cuda.synchronize()
    t_vis2 = time.perf_counter() - t0
    vis2_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    for f, n in saved.items():
        f.launches = n
    prior_loss = float(make_visibility_prior_loss()(batch, out))
    vis2 = out["visibility2_fine"]
    print(f"priors: secondary-view visibility of train frame {f0} ({vis2.shape[0]} rays x "
          f"{vis2.shape[1]} views) in {t_vis2:.2f} s, peak device memory {vis2_peak_gb:.2f} GiB; "
          f"VisibilityPriorLoss01 {prior_loss:.4g}", flush=True)
    if vis2.shape != (pp.resolution[0] * pp.resolution[1], len(others)) or \
            not bool(((vis2 >= 0) & (vis2 <= 1)).all()) or not (math.isfinite(prior_loss) and prior_loss > 0):
        fail(f"the secondary-view visibility path: visibility2 {tuple(vis2.shape)}, loss {prior_loss}")

    t0 = time.perf_counter()
    step_err = {d: step_gradients(db, d, make_config=priors_config, label=" (priors)")
                for d in ("float32", "bfloat16")}
    t_grads = time.perf_counter() - t0
    out = {
        "setup_s": t_setup, "train_s": t_train, "validation_s": val_log[0]["s"],
        "peak_gb": peak_gb, "launches": launches, "train_launches": train_launches,
        "val_fwd_launches": val_launches, "views_head_widths": sorted(set(widths)),
        "losses": {k: train_rows[-1][k] for k in ("DenseDepthMSE01", "VisibilityLoss01",
                                                  "VisibilityPriorLoss01")},
        "validation_VisibilityPriorLoss01": {t: val[f"validation/{t}/VisibilityPriorLoss01"]
                                             for t in ("train_images", "val_images")},
        "vis2_s": t_vis2, "vis2_peak_gb": vis2_peak_gb, "vis2_prior_loss": prior_loss,
        "step_grad_err": step_err, "step_grads_s": t_grads, "card": card,
    }
    return out


VIP_STEPS = 20


def vipnerf_config(**overrides) -> dict:
    """ViP-NeRF (`presets.with_vip_prior`) on the published widths: the
    recipe of train_config without its augmentations, VIP_STEPS steps in
    graph chunks of TRAIN_CHUNK, no validation."""
    from simplenerf_torch.drivers import presets

    kw = {"num_iterations": VIP_STEPS, "with_augmentations": False, **overrides}
    cfg = presets.with_vip_prior(train_config(**kw))
    cfg.update(steps_per_call=TRAIN_CHUNK, validation_interval=0)
    return cfg


def vipnerf(work: Path, card: str) -> dict:
    """ViP-NeRF trained through the graph (`train_many`) with its prior's
    secondary views in the bf16 kernels: on a copy of the serve phase's
    scene with visibility-prior masks written (VW02), `runner.start_training`
    of vipnerf_config. Checks the launches (each level's fused forward and
    backward and their secondary kernels once a step, no ensemble), that no
    step calls `fields.mlp.apply_reference` (the unfused secondary path),
    VisibilityPriorLoss01 above 0 at both levels, and one step's gradients
    against the plain versions; returns the readings."""
    import numpy as np
    import torch

    from simplenerf_torch.data import io
    from simplenerf_torch.data.factory import get_data_loader
    from simplenerf_torch.data.preprocessor import ScenePreprocessor
    from simplenerf_torch.data.synthetic import write_scene_priors
    from simplenerf_torch.drivers import runner
    from simplenerf_torch.fields import mlp as mlp_lib
    from simplenerf_torch.losses.visibility import make_visibility_prior_loss
    from simplenerf_torch.ops import fused_mlp
    from simplenerf_torch.render import renderer
    from simplenerf_torch.training.trainer import Trainer

    db, runs = work / "vipnerf/db", work / "vipnerf/runs"
    shutil.copytree(work / "db", db)
    scene_dir = db / "all/database_data/blobs"
    extrinsics = np.loadtxt(scene_dir / "CameraExtrinsics.csv", delimiter=",").reshape(-1, 4, 4)
    K = np.loadtxt(scene_dir / "CameraIntrinsics_down4.csv", delimiter=",").reshape(-1, 3, 3)[0]
    cfg = vipnerf_config()
    train_f = [int(f) for f in get_data_loader(cfg, db, "train").get_frame_nums()]
    images = {f: io.read_image(scene_dir / f"rgb_down4/{f:04}.png") for f in train_f}
    depths = {f: np.load(work / f"gt_depths/blobs/{f:04}.npy") for f in train_f}
    write_scene_priors(db, "blobs", train_f, images, depths, extrinsics, K, masks_dirname="VW02")

    counters = (fused_mlp.fused_apply_ensemble, fused_mlp.fused_ens_bwd, fused_mlp.fused_apply,
                fused_mlp.fused_bwd, fused_mlp.secondary_fwd, fused_mlp.secondary_bwd,
                fused_mlp.pe_operands)
    with recorded(mlp_lib, "apply_reference", lambda a, _: 1) as unfused:
        for f in counters:
            f.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run_dir = runner.start_training(cfg, db, runs)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        launches = {f.__name__: f.launches for f in counters}
    # Two levels a step: each level's PE of its points and of its secondary pairs.
    want = {"fused_apply_ensemble": 0, "fused_ens_bwd": 0,
            **dict.fromkeys(("fused_apply", "fused_bwd", "secondary_fwd", "secondary_bwd"), 2 * VIP_STEPS),
            "pe_operands": 4 * VIP_STEPS}
    print(f"vipnerf: start_training, {VIP_STEPS} steps in graph chunks of {TRAIN_CHUNK} in "
          f"{t_train:.1f} s incl. set-up and capture; launches {launches}; {len(unfused)} "
          f"apply_reference calls; peak device memory {peak_gb:.2f} GiB", flush=True)
    if launches != want or unfused:
        fail(f"vipnerf: launches {launches} (want {want}), {len(unfused)} unfused secondary calls")
    rows = [json.loads(r) for r in (run_dir / "blobs/logs/scalars.jsonl").read_text().splitlines()]
    train_rows = [r for r in rows if "rays_per_s" in r]
    if not train_rows or not all(math.isfinite(r["VisibilityPriorLoss01"]) and r["VisibilityPriorLoss01"] > 0
                                 for r in train_rows):
        fail(f"VisibilityPriorLoss01 in training: {[r.get('VisibilityPriorLoss01') for r in rows]}")

    # Each level's prior loss, from one step's outputs in train mode.
    raw = get_data_loader(cfg, db, "train").load_data()
    trainer = Trainer(dict(cfg, resume_training=False), work / "vipnerf/levels",
                      ScenePreprocessor(cfg, "train", raw))
    idx = trainer.train_pp.next_indices(0)
    batch = trainer.batch(*idx)
    with torch.no_grad():
        out = renderer.render_rays(trainer.params, trainer.render_cfg, batch, train=True,
                                   sec_views_vis=True, generator=trainer.step_generator(0))
    _, maps = make_visibility_prior_loss()(batch, out, return_maps=True)
    levels = {k: float(v.sum() / batch["indices_mask_nerf"].sum()) for k, v in maps.items()}
    print(f"vipnerf: VisibilityPriorLoss01 by level {levels}", flush=True)
    if sorted(levels) != ["VisibilityPriorLoss01_coarse", "VisibilityPriorLoss01_fine"] or \
            not all(v > 0 for v in levels.values()):
        fail(f"VisibilityPriorLoss01 by level: {levels}")
    grads = step_gradients(db, "bfloat16", make_config=vipnerf_config, label=" (vipnerf)")
    return {"train_s": t_train, "peak_gb": peak_gb, "launches": launches,
            "apply_reference_calls": len(unfused),
            "prior_losses": [r["VisibilityPriorLoss01"] for r in train_rows],
            "prior_by_level": levels, "step_grad_err": grads, "card": card}


SEC_VIEWS = 2  # a ViP-NeRF step's k: 3 train views
SEC_SHAPES = (("coarse", STEP_RAYS, COARSE_NS, SEC_VIEWS), ("fine", STEP_RAYS, FINE_NS, SEC_VIEWS),
              ("ragged", 1037, COARSE_NS, 3))


def secondary_kernels() -> dict:
    """ViP-NeRF's secondary views in the bf16 kernels against their plain
    versions, on the published MLP with a visibility head and seeded
    secondary directions: at the step's shapes (4096 x 64 and 4096 x 192,
    k = 2) and a ragged row count (1037 x 64, k = 3). `fused_apply(sec=)`'s
    head and k secondary planes (the forward engine's kPre instance and
    sec_fwd_kernel), the secondary kernels alone on that forward's `pre`
    (`secondary_fwd`'s k planes; `secondary_bwd`'s views-layer cotangent,
    dwdir and the head row's dW and db) and `fused_bwd(sec=, pre=)` (the
    row pass's kSec instance): every dW, db, dhvx and dwdir, at the
    kernels' tolerances (KERNEL_TOL, GRAD_TOL). At the step's shapes each
    secondary kernel is timed with CUDA events after warm-up, beside its
    plain version and its bound: the pairs' work of
    benchmark/counts_vipnerf.py (its op less `counts.py`'s) at the bf16
    peak or HBM's rate. Launches made here are not the main path's."""
    import torch

    from benchmark import counts, counts_vipnerf, scene
    from simplenerf_torch.drivers import presets
    from simplenerf_torch.fields import mlp
    from simplenerf_torch.ops import fused_mlp as fm

    counters = (fm.fused_apply, fm.fused_bwd, fm.secondary_fwd, fm.secondary_bwd)
    saved = {f: f.launches for f in counters}
    cfg = mlp.MLPConfig(**PUBLISHED["visibility"])
    mlps = scene.model_mlps(presets.vipnerf_config())
    out: dict = {"fwd_err": 0.0, "bwd_norm_err": 0.0}
    for level, nr, ns, k in SEC_SHAPES:
        label = f"{level} {nr} rays x {ns}, k = {k}"
        g = torch.Generator().manual_seed(nr + ns + k)
        params = mlp.init(g, cfg, device="cuda")
        pts = (torch.rand((nr * ns, 3), generator=g) * 2 - 1).cuda()
        dirs = torch.nn.functional.normalize(torch.randn((nr, 3), generator=g), dim=-1).cuda()
        dirs2 = torch.nn.functional.normalize(torch.randn((nr * ns, k, 3), generator=g), dim=-1).cuda()
        ops = mlp.fused_operands(params, cfg, pts, dirs, ns, torch.bfloat16)
        spec, kp = ops[:2]
        sec = mlp.secondary_operands(params, cfg, dirs2, torch.bfloat16)
        planes, pre = fm._fwd(*ops, sec)
        want = fm.fused_apply_reference(*ops, sec)
        err = check_planes(f"with secondary views {label}", "bfloat16", planes, want)
        err = max(err, check_planes(f"secondary planes alone {label}", "bfloat16",
                                    fm.secondary_fwd(spec, kp, pre, *sec),
                                    fm.secondary_reference(spec, kp, pre, *sec), kernel="sec_fwd"))
        dp = cotangents(spec.n_planes + k, nr, ns, seed=ns + k)
        d_sec = dp[spec.n_planes :]
        names = ("sec", "dwdir", "dw_vis", "db_vis")
        got = dict(zip(names, fm.secondary_bwd(spec, kp, pre, *sec, d_sec)))
        ref = dict(zip(names, fm.secondary_bwd_reference(spec, kp, pre, *sec, d_sec)))
        bwd = check_grads("sec_bwd", label, "bfloat16", got, ref)
        dkp, dhvx, dwdir = fm.fused_bwd(*ops, dp, sec=sec, pre=pre)
        w_kp, w_hvx, w_dir = fm.fused_bwd_reference(*ops, dp, sec)
        both = check_grads("fused_mlp_bwd", f"with secondary views {label}", "bfloat16",
                           {**dkp, "dhvx": dhvx, "dwdir": dwdir},
                           {**w_kp, "dhvx": w_hvx, "dwdir": w_dir})
        out["fwd_err"] = max(out["fwd_err"], err)
        out["bwd_norm_err"] = max(out["bwd_norm_err"], bwd["norm"], both["norm"])
        if nr == STEP_RAYS:
            m = mlps[level]
            pairs = {}
            for op, whole, base in (("fwd", counts_vipnerf.fwd_op, counts.fwd_op),
                                    ("bwd", counts_vipnerf.bwd_op, counts.bwd_op)):
                a, b = whole(m, nr, ns, k, "bfloat16"), base([m], nr, ns, "bfloat16")
                pairs[op] = bound_ms(a["flops"] - b["flops"], a["bytes"] - b["bytes"])
            r = {
                "shape": [nr, ns, k],
                "fwd_ms": cuda_time_ms(lambda: fm.secondary_fwd(spec, kp, pre, *sec), iters=20),
                "fwd_plain_ms": cuda_time_ms(lambda: fm.secondary_reference(spec, kp, pre, *sec), iters=3),
                "bwd_ms": cuda_time_ms(lambda: fm.secondary_bwd(spec, kp, pre, *sec, d_sec), iters=20),
                "bwd_plain_ms": cuda_time_ms(
                    lambda: fm.secondary_bwd_reference(spec, kp, pre, *sec, d_sec), iters=3),
                "fwd_bound_ms": pairs["fwd"][0], "fwd_bound_by": pairs["fwd"][1],
                "bwd_bound_ms": pairs["bwd"][0], "bwd_bound_by": pairs["bwd"][1],
            }
            out[level] = r
            print(f"time secondary {label} bf16: sec_fwd {r['fwd_ms']:.3f} ms (plain "
                  f"{r['fwd_plain_ms']:.3f}, bound {r['fwd_bound_ms']:.3f} ms, {r['fwd_bound_by']}); "
                  f"sec_bwd with its column sum {r['bwd_ms']:.3f} ms (plain {r['bwd_plain_ms']:.3f}, "
                  f"bound {r['bwd_bound_ms']:.3f} ms, {r['bwd_bound_by']})", flush=True)
        del ops, sec, pre, planes, want, dp, got, ref, dkp, w_kp
        torch.cuda.empty_cache()
    for f, n in saved.items():
        f.launches = n
    return out


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


PE_DEGREE = 10
PE_SHAPES = (  # name, rays, samples, sigma-PE degree (ds < PE_DEGREE: hi too)
    ("render coarse", CHUNK_RAYS, COARSE_NS, PE_DEGREE), ("render fine", CHUNK_RAYS, FINE_NS, PE_DEGREE),
    ("step trio", STEP_RAYS, COARSE_NS, 3), ("step fine", STEP_RAYS, FINE_NS, 3),
    ("ragged", 1037, COARSE_NS, 3))


def pe_kernel() -> dict:
    """The PE operand pass (`fused_mlp.pe_operands`, csrc/field_pe.cu) on
    seeded points against its plain version, bit for bit, in bf16 and
    float32 at degree 10: the render's chunks (lo only), the training
    step's shapes with the sigma-PE split at 3 (lo and hi) and a ragged
    count (not a multiple of the kernel's 128-point tile). Each but the
    ragged one timed with CUDA events after warm-up, beside the plain
    version and the bytes the pass must move (xyz read, lo and hi written
    once) at HBM's rate."""
    import torch

    from simplenerf_torch.ops import fused_mlp

    saved = fused_mlp.pe_operands.launches
    out: dict = {"differ": 0}
    for dtype in (torch.bfloat16, torch.float32):
        dname = dname_of(dtype)
        for name, nr, ns, ds in PE_SHAPES:
            g = torch.Generator(device="cuda").manual_seed(nr * ns + ds)
            pts = 1.5 * torch.randn((nr * ns, 3), generator=g, device="cuda")
            got = fused_mlp.pe_operands(pts, PE_DEGREE, ds, dtype)
            want = fused_mlp.pe_operands_reference(pts, PE_DEGREE, ds, dtype)
            if (got[1] is None) != (want[1] is None) or any(
                    b is not None and (a.shape != b.shape or a.dtype != dtype or not a.is_contiguous())
                    for a, b in zip(got, want)):
                fail(f"PE operands {name} {dname}: shapes or layout differ from the plain version")
            differ = sum(int((a != b).sum()) for a, b in zip(got, want) if b is not None)
            out["differ"] += differ
            row = {"points": nr * ns, "differ": differ}
            if name != "ragged":
                nbytes = pts.numel() * 4 + sum(a.numel() * a.element_size() for a in got if a is not None)
                row.update(
                    ms=cuda_time_ms(lambda: fused_mlp.pe_operands(pts, PE_DEGREE, ds, dtype), iters=20),
                    plain_ms=cuda_time_ms(
                        lambda: fused_mlp.pe_operands_reference(pts, PE_DEGREE, ds, dtype), iters=3),
                    bound_ms=1e3 * nbytes / PEAK_BYTES, gb=nbytes / 1e9)
                row["bound_share"] = row["bound_ms"] / row["ms"]
            out[f"{name} {dname}"] = row
            print(f"{'time' if 'ms' in row else 'check'} field_pe_kernel {name} ({nr} rays x {ns}, "
                  f"d {PE_DEGREE}, ds {ds}, {dname}): {differ} elements differ from the plain version"
                  + (f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
                     f"{row['bound_ms']:.4f} ms ({row['gb']:.3f} GB)" if "ms" in row else ""), flush=True)
            del pts, got, want
        torch.cuda.empty_cache()
    fused_mlp.pe_operands.launches = saved  # these launches are not the main path's
    if out["differ"]:
        fail(f"the PE operand pass differs from its plain version in {out['differ']} elements")
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
    hgmma = {k: n for lib in libs.values() for k, n in hgmma_counts(lib).items()}
    print(f"build: HGMMA instructions in the SASS by kernel: {hgmma}", flush=True)
    for name in TENSOR_CORE_KERNELS:
        if not hgmma.get(name):
            fail(f"{name} issues no HGMMA: its products are not on the tensor cores")

    worst = check_train_kernels()
    sec_kernels = secondary_kernels()
    print(f"kernel checks done at {time.perf_counter() - t_start:.1f} s", flush=True)
    h, w = 189, 252
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        served = serve(work, h, w)
        trained = train(work, work / "db")
        torch.cuda.empty_cache()
        graph_check = graph_vs_loop(work / "db")
        torch.cuda.empty_cache()
        par = parallel(work, card)
        piped = pipeline(work, card, h, w)
        re10k = realestate(work, card)
        prior = priors(work, card)
        vip = vipnerf(work, card)
        step_err = {d: step_gradients(work / "db", d)["worst"] for d in ("float32", "bfloat16")}
        torch.cuda.empty_cache()
        timing = chunk_kernels(test_rays=min(CHUNK_RAYS, -(-(h * w) // 256) * 256))
        pe = pe_kernel()
        train_timing = time_train_kernels()
        train_timing_f32 = time_train_kernels(torch.float32)
        step = step_time(work / "db")
        step_f32 = step_time(work / "db", dname="float32")
        frame_f32 = frame_time(work / "frame_f32", "float32", h, w)

    fine, coarse = timing["fine"], timing["coarse"]
    print(f"serve: {served['frame_s']:.3f} s per served 756x1008 frame; "
          f"{served['test_s'] / served['frames']:.3f} s per 189x252 test frame incl. file output",
          flush=True)
    print(f"serve (float32): {frame_f32['frame_s']:.3f} s per served 756x1008 frame", flush=True)
    for dname, st in (("bf16", step), ("float32", step_f32)):
        for mode in ("loop", "graph"):
            r = st[mode]
            print(f"train ({mode}): {r['s_per_step']:.4f} s per step, {r['rays_per_s']:.0f} rays/s, "
                  f"device busy {100 * r['busy']:.1f} %, {r['reserved_gb']:.2f} GiB reserved "
                  f"(4096 rays per step, published {dname} recipe)", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    key = ("fused_mlp_fwd", "bfloat16", "err")
    worst[key] = max(worst[key], timing["max_abs_err"])
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = train_timing[name]
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": trained["launches"][WRAPPERS[name]],
            "launches_pipeline": piped["launches"][WRAPPERS[name]],
            "launches_realestate": re10k["launches"][WRAPPERS[name]],
            "launches_priors": prior["launches"][WRAPPERS[name]],
            "launches_vipnerf": vip["launches"][WRAPPERS[name]],
            "launches_parallel": par["launches"][WRAPPERS[name]],
            "max_abs_err": worst[(name, "bfloat16", "err")],
            "max_abs_err_f32": worst[(name, "float32", "err")],
            "yardstick_f32": worst[(name, "float32", "yardstick")],
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
            row.update(row_bound_ms=t["row_bound_ms"], row_bound_by=t["row_bound_by"],
                       row_bound_share=t["row_bound_ms"] / t["row_ms"])
            row["row_ptxas"] = ptxas["fused_mlp_bwd_rows_sm90_kernel"]
            row["row_ptxas_f32"] = ptxas["fused_mlp_bwd_rows_tf32_kernel"]
            row["row_hgmma_f32"] = hgmma["fused_mlp_bwd_rows_tf32_kernel"]
            row["weight_ptxas"] = ptxas.get("fused_mlp_bwd_wgrad_kernel")
            row.update(weight_kernel_f32=WGRAD_F32[0], weight_source_f32=WGRAD_F32[1],
                       weight_ptxas_f32=ptxas.get(WGRAD_F32[0]), weight_hgmma_f32=hgmma[WGRAD_F32[0]],
                       weight_yardstick_f32=worst[(name, "float32", "wgrad_yardstick")])
        row.update({
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "shape": t["shape"],
        })
        if name.endswith("fwd"):
            row["fwd_ptxas"] = ptxas["fused_mlp_fwd_sm90_kernel"]
            row["fwd_ptxas_f32"] = ptxas["fused_mlp_fwd_tf32_kernel"]
            row["hgmma_f32"] = hgmma["fused_mlp_fwd_tf32_kernel"]
            row["bound_share"] = t["bound_ms"] / t["ms"]
        f = train_timing_f32[name]  # float32: the 3xTF32 bound, the FMA bound beside it
        row.update({f"{k}_f32": f[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "fma_bound_ms", "row_ms", "weight_ms",
            "sums_ms", "sums_parts_ms", "row_bound_ms", "row_bound_by", "row_fma_bound_ms") if k in f})
        if name.endswith("bwd"):
            row.update({f"{k}_f32": f["yardsticks"][k] for k in (
                "weight_library_ms", "weight_flop_bound_ms", "weight_fma_bound_ms", "weight_bound_ms",
                "weight_issued_gb", "sums_library_ms")})
        if name == "fused_mlp_fwd":
            row["launches_serve"] = served["launches"]
            row["serve_chunks"] = {
                level: {**{k: timing[level][k] for k in ("rows", "ms", "plain_ms", "bound_ms")},
                        "bound_share": timing[level]["bound_ms"] / timing[level]["ms"]}
                for level in ("coarse", "fine")}
        kernels.append(row)
        if not all(math.isfinite(row[k]) for k in ("ms", "plain_ms", "bound_ms", "ms_f32",
                                                    "plain_ms_f32", "bound_ms_f32")):
            fail(f"non-finite timing for {name}")
    fine_pe = pe["render fine bfloat16"]
    kernels.append({
        "name": "field_pe", "route": "cuda", "source": "simplenerf_torch/ops/csrc/field_pe.cu",
        "replaces": None,  # the JAX package's jnp PE (fields/mlp.py _trunk_inputs), left to XLA
        "launches": trained["launches"]["pe_operands"], "launches_serve": served["pe_launches"],
        "launches_pipeline": piped["launches"]["pe_operands"],
        "launches_realestate": re10k["launches"]["pe_operands"],
        "launches_priors": prior["launches"]["pe_operands"],
        "launches_parallel": par["launches"]["pe_operands"],
        "differ": pe["differ"], "err_measure": "lo and hi: elements that differ from the plain version",
        **{k: fine_pe[k] for k in ("ms", "plain_ms", "bound_ms", "bound_share")},
        "bound_by": "bytes", "library_ms": None, "shape": [CHUNK_RAYS, FINE_NS],
        "ptxas": {d: ptxas.get(f"field_pe_kernel {d}") for d in ("bf16", "f32")},
        "shapes": {k: v for k, v in pe.items() if k != "differ"},
    })
    for k in ("ms", "plain_ms", "bound_ms"):
        if not all(math.isfinite(r[k]) for r in kernels[-1]["shapes"].values() if k in r):
            fail(f"non-finite timing for field_pe: {k}")
    for op, err in (("fwd", {"max_abs_err": sec_kernels["fwd_err"]}),
                    ("bwd", {"norm_err": sec_kernels["bwd_norm_err"]})):
        fine_sec = sec_kernels["fine"]
        kernels.append({
            "name": f"sec_{op}", "route": "cuda", "source": "simplenerf_torch/ops/csrc/fused_mlp_sec.cu",
            "replaces": None,  # the JAX package evaluates secondary views unfused (apply_reference)
            "launches_vipnerf": vip["launches"][f"secondary_{op}"], **err,
            **{k: fine_sec[f"{op}_{k}"] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "bound_share": fine_sec[f"{op}_bound_ms"] / fine_sec[f"{op}_ms"],
            "library_ms": None, "shape": fine_sec["shape"],
            "coarse": {k: sec_kernels["coarse"][f"{op}_{k}"] for k in ("ms", "plain_ms", "bound_ms")},
            "ptxas": ptxas.get(f"sec_{op}_kernel"),
        })
        if not all(math.isfinite(kernels[-1][k]) for k in ("ms", "plain_ms", "bound_ms")):
            fail(f"non-finite timing for sec_{op}")
    print(json.dumps({"parallel": par}), flush=True)
    print(json.dumps({"pipeline": piped}), flush=True)
    print(json.dumps({"realestate": re10k}), flush=True)
    print(json.dumps({"priors": prior}), flush=True)
    print(json.dumps({"vipnerf": vip}), flush=True)
    print(json.dumps({"kernels": kernels, "train_step": {
        **step, "float32": step_f32, "frame_f32": frame_f32, "graph_vs_loop": graph_check,
        "step_grad_rel_err": step_err, "card": card}}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
