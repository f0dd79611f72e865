"""The fused MLP backward kernel with parts of it broken or taken out: whether
chip_smoke.py's gradient check would catch each broken part, what each part
of the row pass and of the weight pass costs, and why the sound kernel
differs at all.

    python3 tools/probe_fused_mlp_bwd.py                 # broken variants, splits
    python3 tools/probe_fused_mlp_bwd.py --timing        # the splits only
    python3 tools/probe_fused_mlp_bwd.py --parent DIR    # the splits of DIR's kernel

Needs one CUDA card. Each variant is simplenerf_torch/ops/csrc/fused_mlp_bwd.cu
(with the headers it includes) with text edits, built with the port's nvcc
flags into a temporary directory (all variants at once, as
tools/probe_fused_mlp.py does for the forward).

Broken variants: each runs chip_smoke.py's backward check on the published
main MLP at 1037 rays x 64 (bf16) and x 192 samples (float32 and bf16; 1037
x 64 and x 192 leave a ragged last tile of 64 rows) and at the fine training
step's shape (4096 x 192, bf16): every dW, db and dhvx as ||got - want|| /
||want|| against chip_smoke.py's GRAD_TOL for its group. Each variant runs
in a process of its own, built with -DSNERF_WGRAD_WATCHDOG (the weight
pass's waits then trap after ~2 s), so that one whose barriers never
complete ends with a CUDA error there and counts as failing, without
hanging the probe or spoiling the next variant. The weight pass's variants
break its MN-major descriptor (leading and stride byte offsets swapped),
the k16 advance (by columns instead of rows), its ring protocol (the
consumers' empty-barrier arrivals dropped) and its A strip (64 columns
off); the column sums' variant drops one slice. The unedited kernel must
pass every check and every broken variant must fail one; the script exits
1 otherwise.

Row-pass split: timing-only variants that launch the row pass alone (the
weight pass and the column sums edited out), each with one part of the row
pass removed, timed per launch by CUDA events around the library call at
the training step's shapes: the fine MLP (4096 x 192, bf16) and the coarse
trio through the ensemble program (4096 x 64, bf16). A time difference
bounds what the removed part costs, as the parts overlap. Each row kernel's
ptxas registers and spill bytes are printed beside its times.

Weight-pass split: the weight pass's device time (torch.profiler) in the
same backward calls, whole, with its loads only (no products) and with its
products only (no loads; the sums of whatever the ring holds are still
stored, so no product is dead code). Then the weight pass alone on a
seeded stash of the step's shape (`fused_mlp._launch_wgrad`) with the plan
as it runs, beside the stash bytes its producers issue (a count from the
plan); the plan at other chunk counts; and one torch.matmul of the two
slots per dW as the library's yardstick.

A variant whose edits do not match the sources is skipped. `--parent DIR`
builds and times the kernel of another checkout instead (its package,
sources and wrappers; for example a `git archive` of an earlier commit).

Then, for the unedited kernel at 1037 x 192: the ReLU masks of the
activations the kernel stashed against those of the plain version (the
count of rows x channels that disagree, and the largest activation among
them relative to its layer's largest), and the kernel's gradients against
the plain backward fed with the kernel's own stashed activations. Where the
disagreements explain the difference, that second error is at the level of
summation order.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))


def _args():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timing", action="store_true", help="only the row- and weight-pass splits")
    ap.add_argument("--parent", type=Path,
                    help="a checkout of an earlier commit whose kernel (and its wrappers) to time "
                         "instead of this one's; implies --timing")
    ap.add_argument("--check", nargs=3, metavar=("NAME", "LIB", "CASES"),
                    help="(internal) check one built variant against saved cases, in this process")
    return ap.parse_args()


ARGS = _args()
import torch  # noqa: E402

import chip_smoke  # noqa: E402  (this checkout's: its helpers import the package lazily)

if ARGS.parent:  # the package, its kernel sources and wrappers from the other checkout
    sys.path.insert(0, str(ARGS.parent.resolve()))
from probe_fused_mlp import _build  # noqa: E402
from simplenerf_torch.fields.mlp import MLPConfig  # noqa: E402
from simplenerf_torch.ops import build, fused_mlp  # noqa: E402

_BWD = "fused_mlp_bwd.cu"
_WG = "fused_mlp_wgrad_sm90.cuh"
_WG_PRODUCTS = "for (int kk = 0; kk < 4; ++kk) Mma<N>::run(acc, da + kk * kK16Step, db + kk * kK16Step, 1);"
# Part -> [(file, text in it, text in its place)].
EDITS = {
    "relu mask": [(_BWD, "if (!((w >> b) & 1u)) v0 = 0.f;\n            if (!((w >> (b + 1)) & 1u)) v1 = 0.f;",
                   "")],
    "mask column": [(_BWD, "if (!((w >> b) & 1u)) v0 = 0.f;\n            if (!((w >> (b + 1)) & 1u)) v1 = 0.f;",
                     "if (!((w >> (b + 1)) & 1u)) v0 = 0.f;\n            if (!((w >> b) & 1u)) v1 = 0.f;")],
    "mask layer": [(_BWD, "mk = tile_masks[p.op(i).mask_slot * Block<T>::kThreads];",
                    "mk = tile_masks[max(p.op(i).mask_slot - 1, 0) * Block<T>::kThreads];")],
    "g one row late": [  # row r of the chunk reads G's row r + 1 (float32: the chunk's last reads zeros)
        (_BWD, "load_stage(sg[0], LD, gm, task.g_w, task.j0, r_begin, r_end, tid);",
         "load_stage(sg[0], LD, gm + task.g_w, task.g_w, task.j0, r_begin, r_end - 1, tid);"),
        (_BWD, "load_stage(sg[buf ^ 1], LD, gm, task.g_w, task.j0, r0, r_end, tid);",
         "load_stage(sg[buf ^ 1], LD, gm + task.g_w, task.g_w, task.j0, r0, r_end - 1, tid);"),
        (_WG, "tma_load(st + (kGBox + b) * kBoxBytes, gm, b * kBox, row, bar);",
         "tma_load(st + (kGBox + b) * kBoxBytes, gm, b * kBox, row + 1, bar);"),
    ],
    "first dW": [(_BWD, "    stage_product(acc, sa[buf], sg[buf], LD, warp_m, warp_n, lane);",
                  "    if (task.dw_off != 0) stage_product(acc, sa[buf], sg[buf], LD, warp_m, warp_n, lane);"),
                 (_WG, _WG_PRODUCTS, "if (j.dw_off != 0) " + _WG_PRODUCTS)],
    "desc swap": [(_WG, "(kLbo << 16) | (kSbo << 32)", "(kSbo << 16) | (kLbo << 32)")],
    "k16 columns": [(_WG, "constexpr uint64_t kK16Step = 2048 >> 4;",
                     "constexpr uint64_t kK16Step = 32 >> 4;")],
    "empty arrival": [(_WG, "    if (prev >= 0) release(empty + prev, t);\n    prev = s;", "    prev = s;")],
    "a strip": [(_WG, "tma_load(st + b * kBoxBytes, am, j.i0 + b * kBox, row, bar);",
                 "tma_load(st + b * kBoxBytes, am, j.i0 + b * kBox + kBox, row, bar);")],
    "colsum slice": [(_BWD, "return colsum_launch(scratch, out, S, slices, C, 1, slices, stream);",
                      "return colsum_launch(scratch, out, S, slices - 1, C, 1, slices - 1, stream);")],
    "head add": [(_BWD, "h0 += dq * w0[q];", "h0 += 0.f;")],
    "head row-warp": [(_BWD, "for (int wm = 0; wm < WM; ++wm) sum += red[(wm * kMaxHead + q) * 256 + c];",
                       "for (int wm = 0; wm < WM; ++wm) sum += wm == 1 ? 0.f : red[(wm * kMaxHead + q) * 256 + c];")],
    "db": [(_BWD, "        part[op.part + c] = sum;", "        part[op.part + c] = 0.5f * sum;")],
    "ragged tail": [(_BWD, "const int r_end = min(n_rows, r_begin + chunk_rows);",
                     "const int r_end = min(n_rows / 128 * 128, r_begin + chunk_rows);"),
                    (_WG, "const int r_end = min(n_rows, r_begin + chunk_rows);",
                     "const int r_end = min(n_rows / 128 * 128, r_begin + chunk_rows);")],
}
VARIANTS = {
    "full kernel": [],
    "without the ReLU mask": ["relu mask"],
    "with each mask bit from the neighbouring column": ["mask column"],
    "with the mask words of the previous ReLU layer": ["mask layer"],
    "g read one row late in the weight pass": ["g one row late"],
    "without the first weight's dW (wv0f)": ["first dW"],
    "weight pass: descriptor leading and stride offsets swapped": ["desc swap"],
    "weight pass: k16 advanced by columns": ["k16 columns"],
    "weight pass: the consumers' empty-barrier arrivals dropped": ["empty arrival"],
    "weight pass: the A strip 64 columns off": ["a strip"],
    "column sums: one slice dropped": ["colsum slice"],
    "without a head's contribution to even columns": ["head add"],
    "with half of each layer's db": ["db"],
    "without the ragged last 128-row tile in dW": ["ragged tail"],
    "head partials without one row-warp": ["head row-warp"],
}
SHAPES = [(1037, 64, torch.bfloat16), (1037, 192, torch.float32), (1037, 192, torch.bfloat16),
          (chip_smoke.STEP_RAYS, 192, torch.bfloat16)]

# Timing-only parts: the row pass alone, and parts of it removed or changed.
# The "(v3)" parts match the earlier row pass (mask copied back into the
# shared tile, head partials re-read from the stash, stash copies with
# write-back stores); the others match this one.
_STASH = "      __stcs(reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * width + q * kElems),"
_STASH_V3 = "      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * width + q * kElems) ="
TIMING_EDITS = {
    "rows only": [(_BWD, "static_cast<float*>(b.g32), static_cast<uint2*>(b.masks), static_cast<float*>(b.parts));\n"
                         "  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);",
                   "static_cast<float*>(b.g32), static_cast<uint2*>(b.masks), static_cast<float*>(b.parts));\n"
                   "  return static_cast<int>(cudaGetLastError());")],
    "mask reload (v3)": [(_BWD, "if (op.flags & FLAG_RELU) {  // the activation whose mask g takes",
                          "if (false) {")],
    "head partials (v3)": [(_BWD, "      head_partials(op, p, stash, dplanes, part, row0, tid);", "")],
    "head add (v3)": [(_BWD, "for (int q = 0; q < hn; ++q) {\n            const float d = dp[",
                       "for (int q = 0; q < 0; ++q) {\n            const float d = dp[")],
    "stash stores (v3)": [(_BWD, "    if (row0 + r < n_rows)\n" + _STASH_V3, "    if (false)\n" + _STASH_V3)],
    "streaming stores (v3)": [(_BWD, _STASH_V3 + "\n          *reinterpret_cast<const uint4*>(tile + r * ld + q * kElems);",
                               "      __stcs(reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * width + q * kElems),\n"
                               "          *reinterpret_cast<const uint4*>(tile + r * ld + q * kElems));")],
    "mask words": [(_BWD, "mk = tile_masks[p.op(i).mask_slot * Block<T>::kThreads];",
                    "mk = make_uint2(~0u, ~0u);"),
                   (_BWD, "if (flags & FLAG_RELU) *mask = make_uint2(bits[0], bits[1]);", "")],
    "head partials": [(_BWD, "const bool head = op.head_nout > 0;", "const bool head = false;")],
    "head add": [(_BWD, "if (op.head_nout > 0) add_head<T>(", "if (false) add_head<T>(")],
    "stash stores": [(_BWD, "    if (row0 + r < n_rows)\n" + _STASH, "    if (false)\n" + _STASH)],
    "write-back stores": [(_BWD, _STASH + "\n             *reinterpret_cast<const uint4*>(tile + r * ld + q * kElems));",
                           _STASH_V3 + "\n             *reinterpret_cast<const uint4*>(tile + r * ld + q * kElems);")],
    # every tile's rows to one 64 KB window of each slot, which stays in L2
    "L2 window": [(_BWD, _STASH, _STASH.replace("(row0 + r)", "r"))],
    "wgrad loads only": [(_WG, _WG_PRODUCTS, "")],
    "wgrad products only": [(_WG, "    mbar_expect_tx(full + s, bytes);\n    load_stage(",
                             "    mbar_arrive(full + s);\n    if (false) load_stage(")],
}
_V3 = ["mask reload (v3)", "head partials (v3)", "head add (v3)", "stash stores (v3)"]
TIMING = {
    "row pass": ["rows only"],
    "row pass without mask reloads (v3)": ["rows only", "mask reload (v3)"],
    "row pass without head partials (v3)": ["rows only", "head partials (v3)"],
    "row pass without the epilogue's head add (v3)": ["rows only", "head add (v3)"],
    "row pass without stash stores (v3)": ["rows only", "stash stores (v3)"],
    "row pass without all four (v3)": ["rows only", *_V3],
    "row pass with streaming stash stores (v3)": ["rows only", "streaming stores (v3)"],
    "row pass without mask words": ["rows only", "mask words"],
    "row pass without head partials": ["rows only", "head partials"],
    "row pass without the epilogue's head add": ["rows only", "head add"],
    "row pass without stash stores": ["rows only", "stash stores"],
    "row pass without all four": ["rows only", "mask words", "head partials", "head add",
                                  "stash stores"],
    "row pass with write-back stash stores": ["rows only", "write-back stores"],
    "row pass, stash stores to an L2 window": ["rows only", "L2 window"],
}
# Weight-pass split: the whole backward runs; the weight pass's own device time is read.
WGRAD_TIMING = {
    "weight pass": [],
    "weight pass, loads only": ["wgrad loads only"],
    "weight pass, products only": ["wgrad products only"],
}


def check(dkp, dhvx, want, dname) -> tuple:
    """(worst norm error, its key, within GRAD_TOL) over every gradient."""
    errs = {k: chip_smoke.norm_err(v, want[k]) for k, v in {**dkp, "dhvx": dhvx}.items()}
    worst = max(errs, key=errs.get)
    ok = all(e <= chip_smoke.GRAD_TOL[dname][chip_smoke.grad_group(k)] for k, e in errs.items())
    return errs[worst], worst, ok


def _applies(parts: list, edits: dict) -> bool:
    """Whether every edit of `parts` matches the kernel sources."""
    sources = {f.name: f.read_text() for f in build.CSRC.iterdir() if f.suffix in (".cu", ".cuh")}
    return all(any(old in text for f, text in sources.items() if fname in (None, f))
               for part in parts for fname, old, _ in edits[part])


def _load(proc) -> ctypes.CDLL:
    """A built variant (an nvcc process of _build, or its library's path)."""
    lib = ctypes.CDLL(str(getattr(proc, "lib", proc)))
    for fn, argtypes in build._SIGNATURES["fused_mlp_bwd"].items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, ctypes.c_int
    return lib


class _Timed:
    """A kernel library whose entry points record CUDA events around each call."""

    def __init__(self, lib):
        self.lib, self.events = lib, []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)

        def call(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            rc = fn(*args)
            end.record()
            self.events.append((start, end))
            return rc

        return call


def launch_ms(lib, run, iters: int = 5) -> float:
    """Median ms of the library's launches per call of `run`, after one warm-up."""
    timed = _Timed(lib)
    build._loaded["fused_mlp_bwd"] = timed  # the wrapper now launches through it
    run()
    torch.cuda.synchronize()
    timed.events.clear()
    for _ in range(iters):
        run()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in timed.events)


def row_kernels(log: str) -> str:
    """The row kernels' ptxas registers and spill bytes, by operand type."""
    rep = chip_smoke.ptxas_report(log)
    return "; ".join(f"{'bf16' if 'nv_bfloat16' in k else 'f32'} {v['registers']} registers, "
                     f"{v['spill_stores']} / {v['spill_loads']} B spill stores / loads"
                     for k, v in sorted(rep.items()) if "rows_kernel" in k)


def timing_cases():
    """The training step's two backward launches: (label, call) with seeded operands."""
    bf16 = torch.bfloat16
    ops = chip_smoke.kernel_operands(MLPConfig(), chip_smoke.STEP_RAYS, chip_smoke.FINE_NS, bf16, seed=3)
    dp = chip_smoke.cotangents(ops[0].n_planes, chip_smoke.STEP_RAYS, chip_smoke.FINE_NS, seed=4)
    ens = chip_smoke.ensemble_operands(chip_smoke.STEP_RAYS, chip_smoke.COARSE_NS, bf16, seed=5)
    edp = chip_smoke.cotangents(ens[0].n_planes, chip_smoke.STEP_RAYS, chip_smoke.COARSE_NS, seed=6)
    return [(f"fine {chip_smoke.STEP_RAYS}x{chip_smoke.FINE_NS}", lambda: fused_mlp.fused_bwd(*ops, dp)),
            (f"trio {chip_smoke.STEP_RAYS}x{chip_smoke.COARSE_NS}",
             lambda: fused_mlp.fused_ens_bwd(*ens, edp))]


class _Recorder:
    """fused_mlp's view of torch that keeps every tensor `torch.empty` makes."""

    def __init__(self):
        self.made = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def empty(self, *args, **kwargs):
        self.made.append(torch.empty(*args, **kwargs))
        return self.made[-1]


def stashed_activations(ops, dp):
    """Run the kernel; return its gradients and the activations it stashed,
    as (trunk list, feature, views list) shaped like the plain version's."""
    spec, kp, lo, hi, hvx = ops
    n = lo.shape[0]
    plan = fused_mlp.pack_bwd_program(spec, kp, n)
    rec = _Recorder()
    fused_mlp.torch = rec
    try:
        dkp, dhvx = fused_mlp.fused_bwd(*ops, dp)
    finally:
        fused_mlp.torch = torch
    stash = next(t for t in rec.made if t.numel() == plan.stash_cols * n and t.dtype == spec.cdtype)
    layers = [(int(w[16]), int(w[1])) for w in plan.ops if w[0] == fused_mlp._F_LAYER]  # (slot, n)
    acts = [stash[s * n : (s + w) * n].view(n, w) for s, w in layers]
    d = spec.depth
    return (dkp, dhvx), (acts[:d], acts[d], acts[d + 1 :])


def explain(ops, dp, dname: str) -> None:
    """Mask disagreements between the kernel's stash and the plain
    activations, and the kernel against the plain backward fed with the
    kernel's activations."""
    spec, kp, lo, hi, hvx = ops
    (dkp, dhvx), (hs, f, hvs) = stashed_activations(ops, dp)
    plain_hs = fused_mlp._trunk_forward(spec, kp, lo)
    _, plain_hvs = fused_mlp._views_forward(spec, kp, plain_hs[-1], hi, hvx)
    total, parts = 0, []
    for name, got, want in [(f"h{i}", a, b) for i, (a, b) in enumerate(zip(hs, plain_hs))] + [
            (f"hv{i}", a, b) for i, (a, b) in enumerate(zip(hvs, plain_hvs))]:
        flip = (got.float() > 0) != (want.float() > 0)
        k = int(flip.sum())
        total += k
        if k:
            size = torch.maximum(got.float(), want.float())[flip].max().item()
            parts.append(f"{name} {k} (largest {size / want.float().max().item():.1e} of the layer's)")
    print(f"probe explain {dname}: {total} ReLU mask disagreements between the kernel's stash and "
          f"the plain activations over {sum(h.numel() for h in hs + hvs)} activations: "
          + (", ".join(parts) or "none"), flush=True)
    saved = fused_mlp._trunk_forward, fused_mlp._views_forward
    fused_mlp._trunk_forward = lambda *a, **k: hs
    fused_mlp._views_forward = lambda *a, **k: (f, hvs)
    try:
        same, same_hvx = fused_mlp.fused_bwd_reference(*ops, dp)
    finally:
        fused_mlp._trunk_forward, fused_mlp._views_forward = saved
    plain, plain_hvx = fused_mlp.fused_bwd_reference(*ops, dp)
    for label, want, want_hvx in (("the plain backward", plain, plain_hvx),
                                  ("the plain backward on the kernel's activations", same, same_hvx)):
        got_all, want_all = {**dkp, "dhvx": dhvx}, {**want, "dhvx": want_hvx}
        norm = max(chip_smoke.norm_err(got_all[k], want_all[k]) for k in want_all)
        worst = max(chip_smoke.rel_err(got_all[k], want_all[k]) for k in want_all)
        print(f"probe explain {dname}: kernel vs {label}: worst norm err {norm:.3e}, "
              f"worst max abs err / largest value {worst:.3e}", flush=True)


def _cases():
    """chip_smoke.py's backward check at the probe's shapes: (label, dtype name, ops, dp, want)."""
    cases = []
    for nr, ns, dtype in SHAPES:
        ops = chip_smoke.kernel_operands(MLPConfig(), nr, ns, dtype, seed=nr + ns)
        dp = chip_smoke.cotangents(ops[0].n_planes, nr, ns, seed=nr + 1)
        want, want_hvx = fused_mlp.fused_bwd_reference(*ops, dp)
        cases.append((f"{nr}x{ns}", chip_smoke.dname_of(dtype), ops, dp, {**want, "dhvx": want_hvx}))
    return cases


def check_variant(name: str, lib_path: str, cases_path: str) -> int:
    """One variant against the saved cases, in this process: prints its line,
    then a JSON line {"passes": ...}. A CUDA error ends the process."""
    build._loaded["fused_mlp_bwd"] = _load(lib_path)
    cases = torch.load(cases_path, weights_only=False)
    results = []
    for label, dname, ops, dp, want in cases:
        err, key, ok = check(*fused_mlp.fused_bwd(*ops, dp), want, dname)
        results.append((f"{label} {dname}", err, key, ok))
    _, _, ops, dp, _ = cases[-1]
    ms = launch_ms(build._loaded["fused_mlp_bwd"], lambda: fused_mlp.fused_bwd(*ops, dp), iters=3)
    print(f"probe fused_mlp_bwd {name}: {ms:.3f} ms at 4096x192 bf16; "
          + "; ".join(f"{label} worst norm err {e:.3e} ({k}, {'passes' if ok else 'fails'})"
                      for label, e, k, ok in results), flush=True)
    print(json.dumps({"passes": all(r[3] for r in results)}), flush=True)
    return 0


def broken_variants(procs: dict, tmp: Path) -> bool:
    """Every broken variant against the plain backward, each in a process of
    its own; True when the sound kernel passes and every broken one fails
    (a variant whose process ends in an error or outlasts its limit fails)."""
    cases_path = tmp / "cases.pt"
    torch.save(_cases(), cases_path)
    caught = True
    for name, proc in procs.items():
        sound = not VARIANTS[name]
        try:
            run = subprocess.run([sys.executable, __file__, "--check", name, str(proc.lib),
                                  str(cases_path)], capture_output=True, text=True, timeout=600)
            out = run.stdout.strip().splitlines()
            passes = run.returncode == 0 and bool(out) and json.loads(out[-1])["passes"]
            if run.returncode == 0 and out:
                print(out[-2] if len(out) > 1 else out[-1], flush=True)
            else:
                err = (run.stderr.strip().splitlines() or ["no output"])[-1]
                print(f"probe fused_mlp_bwd {name}: the process ended with exit code "
                      f"{run.returncode} (fails): {err[:300]}", flush=True)
        except subprocess.TimeoutExpired:
            passes = False
            print(f"probe fused_mlp_bwd {name}: no result within 600 s (fails)", flush=True)
        caught &= passes == sound
    for label, dname, ops, dp, _ in torch.load(cases_path, weights_only=False)[1:3]:
        explain(ops, dp, f"{label} {dname}")
    return caught


def row_pass_split(procs: dict, logs: dict) -> None:
    """Each timing variant's row pass per launch at the step's two shapes."""
    cases = timing_cases()
    for name, proc in procs.items():
        lib = _load(proc)
        times = [(label, launch_ms(lib, run)) for label, run in cases]
        print(f"probe row pass {name}: " + ", ".join(f"{label} {ms:.3f} ms" for label, ms in times)
              + f" per launch; ptxas {row_kernels(logs[name])}", flush=True)
    build._loaded.pop("fused_mlp_bwd", None)


def wgrad_split(procs: dict) -> None:
    """Each weight-pass timing variant's device time per launch (profiler) at
    the step's two shapes."""
    cases = timing_cases()
    for name, proc in procs.items():
        build._loaded["fused_mlp_bwd"] = _load(proc)
        times = [(label, chip_smoke.bwd_pass_ms(run)["weight_ms"]) for label, run in cases]
        print(f"probe weight pass {name}: " + ", ".join(f"{label} {ms:.3f} ms" for label, ms in times)
              + " per launch (profiler)", flush=True)
    build._loaded.pop("fused_mlp_bwd", None)


def wgrad_plans() -> None:
    """The weight pass alone on a seeded stash of each step shape: the plan as
    it runs, beside the stash bytes its producers issue; the plan at other
    chunk counts; and one torch.matmul of the two slots per dW."""
    if not hasattr(fused_mlp, "_launch_wgrad"):
        print("probe weight pass plans: skipped (this checkout has no _launch_wgrad)", flush=True)
        return
    bf16 = torch.bfloat16
    shapes = [("fine", chip_smoke.kernel_operands(MLPConfig(), 8, chip_smoke.FINE_NS, bf16, seed=3)[:2],
               chip_smoke.STEP_RAYS * chip_smoke.FINE_NS),
              ("trio", chip_smoke.ensemble_operands(8, chip_smoke.COARSE_NS, bf16, seed=5)[:2],
               chip_smoke.STEP_RAYS * chip_smoke.COARSE_NS)]
    for label, (spec, kp), n in shapes:
        plan = fused_mlp.pack_bwd_program(spec, kp, 64)
        dws, dw_total = plan.dws, plan.dw_total
        g = torch.Generator(device="cuda").manual_seed(7)
        stash = torch.randn(plan.stash_cols * n, generator=g, device="cuda").to(bf16)

        def timed(wp):
            return chip_smoke.cuda_time_ms(lambda: fused_mlp._launch_wgrad(stash, n, wp, dw_total),
                                           iters=10)

        wp = fused_mlp._wgrad_plan(dws, n)
        print(f"probe weight pass plan {label} ({n} rows, {len(dws)} dW): {timed(wp):.3f} ms, "
              f"{wp.issued / 1e9:.2f} GB issued, {len(wp.jobs)} CTAs, {wp.n_chunks} chunks", flush=True)
        chosen = fused_mlp._wgrad_chunks
        per = len(wp.jobs) // wp.n_chunks
        other = []
        for c in sorted({max(1, wp.n_chunks // 2), wp.n_chunks * 2, -(-132 // per), -(-6 * 132 // per)}):
            rows = -(-(-(-n // c)) // 64) * 64
            fused_mlp._wgrad_chunks = lambda n_rows, per_chunk, c=c, rows=rows: (-(-n_rows // rows), rows)
            try:
                other_wp = fused_mlp._wgrad_plan(dws, n)
            finally:
                fused_mlp._wgrad_chunks = chosen
            other.append(f"{other_wp.n_chunks} chunks ({len(other_wp.jobs)} CTAs) {timed(other_wp):.3f} ms")
        print(f"probe weight pass chunks {label}: " + "; ".join(other), flush=True)

        def slot(c, w):
            return stash[c * n : (c + w) * n].view(n, w)

        lib = chip_smoke.cuda_time_ms(lambda: [torch.matmul(slot(a, aw).T, slot(gs, gw))
                                               for a, aw, gs, gw, *_ in dws], iters=3)
        print(f"probe weight pass library {label}: torch.matmul per dW ({len(dws)} calls) "
              f"{lib:.3f} ms", flush=True)
        del stash
        torch.cuda.empty_cache()


def main() -> int:
    if ARGS.check:
        return check_variant(*ARGS.check)
    if not torch.cuda.is_available():
        raise SystemExit("the probe needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{chip_smoke.card_line()}; kernel sources {build.CSRC}", flush=True)
    broken = {} if ARGS.timing or ARGS.parent else VARIANTS
    timing = {name: parts for name, parts in TIMING.items() if _applies(parts, TIMING_EDITS)}
    wtiming = {name: parts for name, parts in WGRAD_TIMING.items() if _applies(parts, TIMING_EDITS)}
    skipped = [name for name in [*TIMING, *WGRAD_TIMING] if name not in {**timing, **wtiming}]
    if skipped:
        print(f"probe splits: skipped (edits do not match these sources): {', '.join(skipped)}",
              flush=True)
    caught = True
    with tempfile.TemporaryDirectory() as tmp:
        procs = {name: _build(Path(tmp), name, parts, lib="fused_mlp_bwd", edits=EDITS,
                              flags=("-DSNERF_WGRAD_WATCHDOG",))
                 for name, parts in broken.items()}
        tprocs = {name: _build(Path(tmp), "timing " + name, parts, lib="fused_mlp_bwd",
                               edits=TIMING_EDITS) for name, parts in timing.items()}
        wprocs = {name: _build(Path(tmp), "wgrad " + name, parts, lib="fused_mlp_bwd",
                               edits=TIMING_EDITS) for name, parts in wtiming.items()}
        logs = {}
        for name, proc in {**procs, **tprocs, **wprocs}.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
        saved = build._loaded.get("fused_mlp_bwd")
        if procs:
            caught = broken_variants(procs, Path(tmp))
        row_pass_split(tprocs, logs)
        wgrad_split(wprocs)
        if saved is not None:
            build._loaded["fused_mlp_bwd"] = saved
    wgrad_plans()
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
