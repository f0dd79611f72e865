"""The fused MLP backward kernel with parts of it broken or taken out: whether
chip_smoke.py's gradient check would catch each broken part, what each part
of the row pass and of the weight pass costs, and why the sound kernel
differs at all.

    python3 tools/probe_fused_mlp_bwd.py                 # broken variants, splits
    python3 tools/probe_fused_mlp_bwd.py --timing        # the splits only
    python3 tools/probe_fused_mlp_bwd.py --explain       # float32 flips of the card cases only
    python3 DIR/tools/probe_fused_mlp_bwd.py --timing    # another checkout's, by its own probe

Needs one CUDA card. Each variant is simplenerf_torch/ops/csrc/fused_mlp_bwd.cu
(with the headers it includes) with text edits, built with the port's nvcc
flags into a temporary directory (all variants at once, as
tools/probe_fused_mlp.py does for the forward).

Broken variants: each runs chip_smoke.py's backward check on the published
main MLP at 1037 rays x 64 (bf16) and x 192 samples (float32 and bf16; 1037
x 64 and x 192 leave a ragged last tile of 64 rows) and at the fine training
step's shape (4096 x 192, bf16): every dW, db and dhvx as ||got - want|| /
||want|| against chip_smoke.py's GRAD_TOL for its group. Each variant runs
in a process of its own, built with -DSNERF_WGRAD_WATCHDOG (the bf16 row
pass's and the weight pass's mbarrier waits then trap after ~2 s), so that
one whose barriers never complete ends with a CUDA error there and counts
as failing, without hanging the probe or spoiling the next variant. The
bf16 row pass's variants (fused_mlp_bwd_sm90.cuh) take each mask bit from
the neighbouring element of the wgmma fragment, read the mask words of the
ReLU layer before, step every slab descriptor one k16 step off, drop
consumer 1's releases of the ring (the watchdog's trap), skip the stash
stores of each tile's last 64 rows, leave one warp out of each db partial
and consumer 1's sums out of the heads' partials. The float32 row pass's
(fused_mlp_bwd_tf32_sm90.cuh, on the 3xTF32 core of fused_mlp_tf32_sm90.cuh)
take each mask bit from the neighbouring fragment element, read the mask
words of the ReLU layer before, skip the stash of each tile's last 64
rows, leave one warp out of each db partial and consumer 1's sums out of
the heads' partials, take the A fragment's columns out of the packer's K
order, and form each product as one TF32 product (big x big) in place of
three; its checks also hold the gradients to chip_smoke.py's float64
yardstick (the worst ||got - want|| / ||want|| against the plain version
in float64 at most chip_smoke.YARDSTICK times the float32 plain
version's), which the one-product variant must fail. The weight pass's break its
MN-major descriptor (leading and stride byte offsets swapped), the k16
advance (by columns instead of rows), its ring protocol (the consumers'
empty-barrier arrivals dropped) and its A strip (64 columns off); the
column sums' variant drops one slice. The unedited kernel must pass every
check and every broken variant must fail one; the script exits 1
otherwise.

Row-pass split: timing-only variants that launch the row pass alone (the
weight pass and the column sums edited out), whole and with parts of the
row pass removed or changed; float32: whole, its products alone (no
epilogue, stash, head partials; one data-dependent store keeps them) and
with one TF32 product in place of three, at the float32 step's shapes;
bf16 (the stash stores, the heads' partials,
the backward ops' epilogues, or their db shuffles, db hand-over or masks,
the forward ops' mask words; the products alone, with no epilogue, stash
or partials, kept by one data-dependent store; the stash's TMA stores
without their evict-first hint), timed per launch by CUDA events
around the library call at the training step's shapes: the fine MLP (4096
x 192, bf16) and the coarse trio through the ensemble program (4096 x 64,
bf16). A time difference bounds what the removed part costs, as the parts
overlap. Each row kernel's ptxas registers and spill bytes are printed
beside its times.

Weight-pass split: the weight pass's device time (torch.profiler) in the
same backward calls, whole, with its loads only (no products) and with its
products only (no loads; the sums of whatever the ring holds are still
stored, so no product is dead code). Then the weight pass alone on a
seeded stash of the step's shape (`fused_mlp._launch_wgrad`) with the plan
as it runs, beside the stash bytes its producers issue (a count from the
plan); the plan at other chunk counts; and one torch.matmul of the two
slots per dW as the library's yardstick.

A variant whose edits do not match the sources is skipped. To time an
earlier commit's kernel, unpack a `git archive` of it and run the probe of
that checkout.

Then, for the unedited kernel at 1037 x 192: the ReLU masks of the
activations the kernel stashed against those of the plain version (the
count of rows x channels that disagree, and the largest activation among
them relative to its layer's largest), and the kernel's gradients against
the plain backward fed with the kernel's own stashed activations. Where the
disagreements explain the difference, that second error is at the level of
summation order. The same for the float32 cases of
tests/test_torch_port_cuda.py's test_backward_kernel_matches_plain at the
published widths (37 rays x 64 and x 192, its operands), with the kernel's
and the float32 plain version's worst norm errors against the plain
version in float64 (`--explain` runs only these).
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
    ap.add_argument("--explain", action="store_true",
                    help="only the float32 card cases' ReLU flips and float64 errors")
    ap.add_argument("--check", nargs=3, metavar=("NAME", "LIB", "CASES"),
                    help="(internal) check one built variant against saved cases, in this process")
    return ap.parse_args()


ARGS = _args()
import torch  # noqa: E402

import chip_smoke  # noqa: E402  (this checkout's: its helpers import the package lazily)

from probe_fused_mlp import _build  # noqa: E402
from simplenerf_torch.fields.mlp import MLPConfig  # noqa: E402
from simplenerf_torch.ops import build, fused_mlp  # noqa: E402

_BWD = "fused_mlp_bwd.cu"
_ROWS = "fused_mlp_bwd_sm90.cuh"
_TROWS = "fused_mlp_bwd_tf32_sm90.cuh"
_TCORE = "fused_mlp_tf32_sm90.cuh"
_ONE_PASS = [(_TCORE, "          mma(part, small[s], db + 2 * s);\n          mma(part, big[s], ds + 2 * s);\n", "")]
_WG = "fused_mlp_wgrad_sm90.cuh"
_WG_PRODUCTS = "for (int kk = 0; kk < 4; ++kk) Mma<N>::run(acc, da + kk * kK16Step, db + kk * kK16Step, 1);"
_RELEASE = "if (prev >= 0 && x.t == 0) mbar_arrive(x.s.empty + prev);"
_TMA = "  if (t == 0) {\n    for (int b = 0; b * 64 < width; ++b) tma_store("
# Part -> [(file, text in it, text in its place)].
EDITS = {
    "row mask bit": [(_ROWS, "(words[j >> 3] >> (4 * (j & 7) + e)) & 1u",
                      "(words[j >> 3] >> (4 * (j & 7) + (e ^ 1))) & 1u")],
    "row mask layer": [(_ROWS, "tmask[op.mask_slot * kMaskThreads]",
                        "tmask[max(op.mask_slot - 1, 0) * kMaskThreads]")],
    "row k16": [(_ROWS, "Mma<N>::run(acc, da + 2 * kk, db + 2 * kk,",
                 "Mma<N>::run(acc, da + 2 * kk, db + 2 * ((kk + 1) & 3),")],
    "row release": [(_ROWS, _RELEASE, _RELEASE.replace("x.t == 0", "x.t == 0 && x.c == 0"))],
    "row stash tail": [(_ROWS, _TMA, _TMA.replace("if (t == 0)", "if (t == 0 && row0 % 128 == 0)"))],
    "row db warp": [(_ROWS, "for (int w = 0; w < 4; ++w) {\n      const float2 v",
                     "for (int w = 1; w < 4; ++w) {\n      const float2 v")],
    "row head hand-over": [(_ROWS, "dst[0] = w0[q] + o.x;", "dst[0] = w0[q];")],
    "tf32 mask bit": [(_TROWS, "(words[j >> 3] >> (4 * (j & 7) + e)) & 1u",
                       "(words[j >> 3] >> (4 * (j & 7) + (e ^ 1))) & 1u")],
    "tf32 mask layer": [(_TROWS, "tmask[op.mask_slot * bwd90::kMaskThreads]",
                         "tmask[max(op.mask_slot - 1, 0) * bwd90::kMaskThreads]")],
    "tf32 stash tail": [(_TROWS, "  if (gr < n_rows) __stcs(", "  if (gr < n_rows && gr % 128 < 64) __stcs(")],
    "tf32 db warp": [(_TROWS, "for (int w = 0; w < 4; ++w) {\n      const float2 v",
                      "for (int w = 1; w < 4; ++w) {\n      const float2 v")],
    "tf32 head hand-over": [(_TROWS, "dst[0] = w0[q] + o.x;", "dst[0] = w0[q];")],
    "tf32 fragment order": [(_TCORE, "const float v[4] = {x0.x, x1.x, x0.y, x1.y};",
                             "const float v[4] = {x0.x, x0.y, x1.x, x1.y};")],
    "tf32 one pass": _ONE_PASS,
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
    "ragged tail": [(_BWD, "const int r_end = min(n_rows, r_begin + chunk_rows);",
                     "const int r_end = min(n_rows / 128 * 128, r_begin + chunk_rows);"),
                    (_WG, "const int r_end = min(n_rows, r_begin + chunk_rows);",
                     "const int r_end = min(n_rows / 128 * 128, r_begin + chunk_rows);")],
}
VARIANTS = {
    "full kernel": [],
    "bf16 row pass: each mask bit from the neighbouring wgmma fragment element": ["row mask bit"],
    "bf16 row pass: the mask words of the previous ReLU layer": ["row mask layer"],
    "bf16 row pass: every slab descriptor one k16 step off": ["row k16"],
    "bf16 row pass: consumer 1's ring releases dropped (trap)": ["row release"],
    "bf16 row pass: the stash stores of each tile's last 64 rows skipped": ["row stash tail"],
    "bf16 row pass: db partials without one warp": ["row db warp"],
    "bf16 row pass: head partials without consumer 1's rows": ["row head hand-over"],
    "float32 row pass: each mask bit from the neighbouring fragment element": ["tf32 mask bit"],
    "float32 row pass: the mask words of the previous ReLU layer": ["tf32 mask layer"],
    "float32 row pass: the stash stores of each tile's last 64 rows skipped": ["tf32 stash tail"],
    "float32 row pass: db partials without one warp": ["tf32 db warp"],
    "float32 row pass: head partials without consumer 1's rows": ["tf32 head hand-over"],
    "float32 row pass: the A fragment's columns out of the packer's K order": ["tf32 fragment order"],
    "float32 row pass: one TF32 product (big x big) in place of three": ["tf32 one pass"],
    "g read one row late in the weight pass": ["g one row late"],
    "without the first weight's dW (wv0f)": ["first dW"],
    "weight pass: descriptor leading and stride offsets swapped": ["desc swap"],
    "weight pass: k16 advanced by columns": ["k16 columns"],
    "weight pass: the consumers' empty-barrier arrivals dropped": ["empty arrival"],
    "weight pass: the A strip 64 columns off": ["a strip"],
    "column sums: one slice dropped": ["colsum slice"],
    "without the ragged last 128-row tile in dW": ["ragged tail"],
}
SHAPES = [(1037, 64, torch.bfloat16), (1037, 192, torch.float32), (1037, 192, torch.bfloat16),
          (chip_smoke.STEP_RAYS, 192, torch.bfloat16)]

# Timing-only parts: the row pass alone, and parts of it removed or changed.
_ROWS_ONLY = "static_cast<float*>(b.parts));\n    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);\n    rc = wgrad_launch("
_F32_ROWS_ONLY = "static_cast<float*>(b.parts));\n    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);\n    if (n_tasks > 0) {"
_F_EPILOGUE = "  f_epilogue<N>(acc, op, x, cst, hvx, tmask + op.mask_slot * kMaskThreads);"
_B_EPILOGUE = "  named_sync(1 + x.c);  // every reader of the tile (stash stores, head partials) is done"
_HEAD_PARTIALS = "  if (op.head_nout) head_partials(op, x, part);"
_F32_F_EPILOGUE = "  f_epilogue<N>(acc, op, b, cst, hvx, stash, tmask + op.mask_slot * bwd90::kMaskThreads);"
_F32_B_EPILOGUE = "  sm90::named_sync(1 + x.c);  // every reader of the tile (products, head partials) is done"
# ptxas drops a wgmma whose results are dead: one data-dependent store keeps them
_KEEP = ("{ float z = 0.f; for (int i = 0; i < N / 2; ++i) z += acc[i]; "
         "if (z == 1e30f) x.tl.act[x.t] = 1; }")
TIMING_EDITS = {
    "bf16 rows only": [(_BWD, _ROWS_ONLY, "static_cast<float*>(b.parts));\n    return static_cast<int>(cudaGetLastError());\n    rc = wgrad_launch(")],
    "f32 rows only": [(_BWD, _F32_ROWS_ONLY, "static_cast<float*>(b.parts));\n    return static_cast<int>(cudaGetLastError());\n    if (n_tasks > 0) {")],
    "f32 no stash": [(_TROWS, "  if (gr < n_rows) __stcs(", "  if (false) __stcs("),
                     (_TROWS, "    if (row0 + r < n_rows)\n      __stcs(", "    if (false)\n      __stcs(")],
    "f32 no head partials": [(_TROWS, "  if (op.head_nout) head_partials(op, b, part);",
                              "  if (false) head_partials(op, b, part);")],
    "f32 no backward epilogue": [(_TROWS, _F32_B_EPILOGUE, _F32_B_EPILOGUE + "\n  " + _KEEP + "\n  if (true) return;")],
    "f32 no forward epilogue": [(_TROWS, _F32_F_EPILOGUE, "  " + _KEEP)],
    "f32 one pass": _ONE_PASS,
    "no stash stores": [(_ROWS, _TMA, _TMA.replace("if (t == 0)", "if (false)"))],
    "no head partials": [(_ROWS, _HEAD_PARTIALS, _HEAD_PARTIALS.replace("op.head_nout", "false"))],
    "no backward epilogue": [(_ROWS, _B_EPILOGUE, _B_EPILOGUE + "\n  " + _KEEP + "\n  if (true) return;")],
    "no mask words": [(_ROWS, "  if (relu) *mask = make_uint4(", "  if (false) *mask = make_uint4(")],
    "no forward epilogue": [(_ROWS, _F_EPILOGUE, "  " + _KEEP)],
    "no db shuffles": [(_ROWS, "    for (int o = 4; o < 32; o <<= 1) {\n      s0 += __shfl_xor_sync",
                        "    for (int o = 4; o < 4; o <<= 1) {\n      s0 += __shfl_xor_sync")],
    "no db hand-over": [(_ROWS, "  float* buf = hand_over_begin(x);\n  if (active) {",
                         "  float* buf = x.s.xfer;\n  if (false) {"),
                        (_ROWS, "      part[op.part + col + 1] = s.y + o.y;\n    }\n  }\n  hand_over_end(x);",
                         "      part[op.part + col + 1] = s.y + o.y;\n    }\n  }\n  ++x.k;")],
    "no mask apply": [(_ROWS, "const bool on = ((words[j >> 3] >> (4 * (j & 7) + e)) & 1u) && (e < 2 ? ok0 : ok1);",
                       "const bool on = true;")],
    "no evict-first hint": [(_ROWS, "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint [%0, {%1, %2}], [%3], %4;",
                             "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];")],
    "wgrad loads only": [(_WG, _WG_PRODUCTS, "")],
    "wgrad products only": [(_WG, "    mbar_expect_tx(full + s, bytes);\n    load_stage(",
                             "    mbar_arrive(full + s);\n    if (false) load_stage(")],
}
_NO_EPILOGUES = ["bf16 rows only", "no stash stores", "no head partials", "no backward epilogue",
                 "no forward epilogue"]
TIMING = {
    "row pass": ["bf16 rows only"],
    "row pass without stash stores": ["bf16 rows only", "no stash stores"],
    "row pass without head partials": ["bf16 rows only", "no head partials"],
    "row pass without the backward ops' epilogues": ["bf16 rows only", "no backward epilogue"],
    "row pass without the forward ops' mask words": ["bf16 rows only", "no mask words"],
    "row pass, products only": _NO_EPILOGUES,
    "row pass without the db shuffles": ["bf16 rows only", "no db shuffles"],
    "row pass without the db hand-over": ["bf16 rows only", "no db hand-over"],
    "row pass without the backward ops' masks": ["bf16 rows only", "no mask apply"],
    "row pass, TMA stash stores without the evict-first hint": ["bf16 rows only", "no evict-first hint"],
    "float32 row pass": ["f32 rows only"],
    "float32 row pass, products only": ["f32 rows only", "f32 no stash", "f32 no head partials",
                                        "f32 no backward epilogue", "f32 no forward epilogue"],
    "float32 row pass, one TF32 product in place of three": ["f32 rows only", "f32 one pass"],
}
# Weight-pass split: the whole backward runs; the weight pass's own device time is read.
WGRAD_TIMING = {
    "weight pass": [],
    "weight pass, loads only": ["wgrad loads only"],
    "weight pass, products only": ["wgrad products only"],
}


def check(dkp, dhvx, want, dname, exact=None) -> tuple:
    """(worst norm error, its key, within GRAD_TOL and, with `exact` (the
    float64 plain version's gradients and the float32 plain version's worst
    norm error against them), within the float64 yardstick, the ratio)."""
    got = {**dkp, "dhvx": dhvx}
    errs = {k: chip_smoke.norm_err(v, want[k]) for k, v in got.items()}
    worst = max(errs, key=errs.get)
    ok = all(e <= chip_smoke.GRAD_TOL[dname][chip_smoke.grad_group(k)] for k, e in errs.items())
    ratio = None
    if exact is not None:
        want64, plain_err = exact
        ratio = max(chip_smoke.norm_err(got[k], want64[k]) for k in want64) / max(plain_err, 1e-300)
        ok &= ratio <= chip_smoke.YARDSTICK
    return errs[worst], worst, ok, ratio


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
                     for k, v in sorted(rep.items())
                     if "rows_sm90_kernel" in k or "rows_tf32_kernel" in k)


def timing_cases(bf16=torch.bfloat16):
    """The training step's two backward launches in the compute type `bf16`
    (bfloat16 or float32): (label, call) with seeded operands."""
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
    as (trunk list, feature, views list) shaped like the plain version's.
    The bf16 row pass stores no slot for a layer that only feeds a head (the
    last views layer): that one is recomputed from the kernel's stashed
    trunk by the plain version."""
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
    hs, f, hvs = acts[:d], acts[d], acts[d + 1 :]
    if plan.rows90 is not None:
        stored = {s for s, _ in plan.rows90.maps}
        assert all(s in stored for s, _ in layers[: d + 1])
        _, again = fused_mlp._views_forward(spec, kp, hs[-1], hi, hvx)
        hvs = [a if s in stored else b for (s, _), a, b in zip(layers[d + 1 :], hvs, again)]
    return (dkp, dhvx), (hs, f, hvs)


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


def explain_card_cases() -> None:
    """`explain` on the float32 cases of the card test
    test_backward_kernel_matches_plain at the published widths, with both
    versions' worst norm errors against the plain version in float64."""
    from simplenerf_torch.fields import mlp

    small = dict(points_net_depth=4, views_net_depth=1, points_net_width=64, views_net_width=64,
                 points_pe_degree=10, views_pe_degree=4, use_view_dirs=True,
                 view_dependent_rgb=True, skip_layers=(2,))
    published = dict(points_net_depth=8, points_net_width=256, views_net_width=128, skip_layers=(4,))
    nr = 37
    for ns in (64, 192):
        cfg = mlp.MLPConfig(**{**small, **published})
        g = torch.Generator().manual_seed(0)
        params = mlp.init(g, cfg, device="cuda")
        pts = torch.randn((nr * ns, 3), generator=g).to("cuda")
        dirs = torch.nn.functional.normalize(torch.randn((nr, 3), generator=g), dim=-1).to("cuda")
        ops = mlp.fused_operands(params, cfg, pts, dirs, ns, torch.float32)
        gd = torch.Generator(device="cuda").manual_seed(1)
        dp = torch.randn((ops[0].n_planes, nr, ns), generator=gd, device="cuda")
        label = f"card case {nr}x{ns} float32"
        explain(ops, dp, label)
        dkp, dhvx = fused_mlp.fused_bwd(*ops, dp)
        want, want_hvx = fused_mlp.fused_bwd_reference(*ops, dp)
        ops64 = (fused_mlp.with_dtype(ops[0], "float64"), *chip_smoke._double(ops[1:]))
        w64, w64_hvx = fused_mlp.fused_bwd_reference(*ops64, dp.double())
        w64 = {**w64, "dhvx": w64_hvx}
        errs = [max((chip_smoke.norm_err(g_[k], w64[k]), k) for k in w64)
                for g_ in ({**dkp, "dhvx": dhvx}, {**want, "dhvx": want_hvx})]
        print(f"probe explain {label}: against the plain version in float64, worst norm err: "
              f"kernel {errs[0][0]:.3e} ({errs[0][1]}), float32 plain version {errs[1][0]:.3e} "
              f"({errs[1][1]})", flush=True)


def _cases():
    """chip_smoke.py's backward check at the probe's shapes: (label, dtype
    name, ops, dp, want, exact); exact, for float32: the float64 plain
    version's gradients and the float32 plain version's worst norm error
    against them."""
    cases = []
    for nr, ns, dtype in SHAPES:
        ops = chip_smoke.kernel_operands(MLPConfig(), nr, ns, dtype, seed=nr + ns)
        dp = chip_smoke.cotangents(ops[0].n_planes, nr, ns, seed=nr + 1)
        want, want_hvx = fused_mlp.fused_bwd_reference(*ops, dp)
        want = {**want, "dhvx": want_hvx}
        exact = None
        if dtype == torch.float32:
            ops64 = (fused_mlp.with_dtype(ops[0], "float64"), *chip_smoke._double(ops[1:]))
            w64, w64_hvx = fused_mlp.fused_bwd_reference(*ops64, dp.double())
            w64 = {**w64, "dhvx": w64_hvx}
            exact = (w64, max(chip_smoke.norm_err(want[k], w64[k]) for k in w64))
        cases.append((f"{nr}x{ns}", chip_smoke.dname_of(dtype), ops, dp, want, exact))
    return cases


def check_variant(name: str, lib_path: str, cases_path: str) -> int:
    """One variant against the saved cases, in this process: prints its line,
    then a JSON line {"passes": ...}. A CUDA error ends the process."""
    build._loaded["fused_mlp_bwd"] = _load(lib_path)
    cases = torch.load(cases_path, weights_only=False)
    results = []
    for label, dname, ops, dp, want, exact in cases:
        err, key, ok, ratio = check(*fused_mlp.fused_bwd(*ops, dp), want, dname, exact)
        results.append((f"{label} {dname}", err, key, ok, ratio))
    _, _, ops, dp, _, _ = cases[-1]
    ms = launch_ms(build._loaded["fused_mlp_bwd"], lambda: fused_mlp.fused_bwd(*ops, dp), iters=3)
    print(f"probe fused_mlp_bwd {name}: {ms:.3f} ms at 4096x192 bf16; "
          + "; ".join(f"{label} worst norm err {e:.3e} ({k}"
                      + (f"; float64 yardstick ratio {r:.2f}" if r is not None else "")
                      + f", {'passes' if ok else 'fails'})" for label, e, k, ok, r in results),
          flush=True)
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
    for label, dname, ops, dp, *_ in torch.load(cases_path, weights_only=False)[1:3]:
        explain(ops, dp, f"{label} {dname}")
    explain_card_cases()
    return caught


def row_pass_split(procs: dict, logs: dict) -> None:
    """Each timing variant's row pass per launch at the step's two shapes
    (float32 variants at the float32 step's)."""
    cases = {False: timing_cases(), True: None}
    for name, proc in procs.items():
        lib = _load(proc)
        f32 = name.startswith("float32")
        if cases[f32] is None:
            cases[f32] = timing_cases(torch.float32)
        times = [(label, launch_ms(lib, run)) for label, run in cases[f32]]
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
    if ARGS.explain:
        explain_card_cases()
        return 0
    broken = {} if ARGS.timing else VARIANTS
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
