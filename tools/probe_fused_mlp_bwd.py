"""The fused MLP backward kernel with parts of it broken: whether chip_smoke.py's
gradient check would catch each, and why the sound kernel differs at all.

    python3 tools/probe_fused_mlp_bwd.py

Needs one CUDA card. Each variant is simplenerf_torch/ops/csrc/fused_mlp_bwd.cu
(with the header it includes) with one text edit, built with the port's nvcc
flags into a temporary directory (all variants at once, as
tools/probe_fused_mlp.py does for the forward). Each runs chip_smoke.py's
backward check on the published main MLP at 1037 rays x 64 (bf16) and x 192
samples (float32 and bf16; 1037 x 64 and x 192 leave a ragged last tile of
64 rows) and at the fine training step's shape (4096 x 192, bf16): every
dW, db and dhvx as ||got - want|| / ||want|| against chip_smoke.py's
GRAD_TOL for its group. It also prints each variant's time at the fine step
shape (CUDA events, after one warm-up). The unedited kernel must pass every
check and every broken variant must fail one; the script exits 1 otherwise.

Then, for the unedited kernel at 1037 x 192: the ReLU masks of the
activations the kernel stashed against those of the plain version (the
count of rows x channels that disagree, and the largest activation among
them relative to its layer's largest), and the kernel's gradients against
the plain backward fed with the kernel's own stashed activations. Where the
disagreements explain the difference, that second error is at the level of
summation order.
"""

from __future__ import annotations

import ctypes
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from probe_fused_mlp import _build  # noqa: E402
from simplenerf_torch.fields.mlp import MLPConfig  # noqa: E402
from simplenerf_torch.ops import build, fused_mlp  # noqa: E402

_BWD = "fused_mlp_bwd.cu"
# Part -> [(file, text in it, text in its place)].
EDITS = {
    "relu mask": [(_BWD, "if (!(hv.x > 0.f)) v0 = 0.f;\n            if (!(hv.y > 0.f)) v1 = 0.f;", "")],
    "g one row late": [  # row r of the chunk reads G's row r + 1 (the chunk's last reads zeros)
        (_BWD, "load_stage(sg[0], LD, gm, task.g_w, task.j0, r_begin, r_end, tid);",
         "load_stage(sg[0], LD, gm + task.g_w, task.g_w, task.j0, r_begin, r_end - 1, tid);"),
        (_BWD, "load_stage(sg[buf ^ 1], LD, gm, task.g_w, task.j0, r0, r_end, tid);",
         "load_stage(sg[buf ^ 1], LD, gm + task.g_w, task.g_w, task.j0, r0, r_end - 1, tid);"),
    ],
    "first dW": [(_BWD, "    stage_product(acc, sa[buf], sg[buf], LD, warp_m, warp_n, lane);",
                  "    if (task.dw_off != 0) stage_product(acc, sa[buf], sg[buf], LD, warp_m, warp_n, lane);")],
    "head add": [(_BWD, "h0 += d * hw[q * n + col];", "h0 += 0.f;")],
    "db": [(_BWD, "        part[op.part + c] = sum;", "        part[op.part + c] = 0.5f * sum;")],
    "ragged tail": [(_BWD, "const int r_end = min(n_rows, r_begin + chunk_rows);",
                     "const int r_end = min(n_rows / 128 * 128, r_begin + chunk_rows);")],
}
VARIANTS = {
    "full kernel": [],
    "without the ReLU mask": ["relu mask"],
    "g read one row late in the weight pass": ["g one row late"],
    "without the first weight's dW (wv0f)": ["first dW"],
    "without a head's contribution to even columns": ["head add"],
    "with half of each layer's db": ["db"],
    "without the ragged last 128-row tile in dW": ["ragged tail"],
}
SHAPES = [(1037, 64, torch.bfloat16), (1037, 192, torch.float32), (1037, 192, torch.bfloat16),
          (chip_smoke.STEP_RAYS, 192, torch.bfloat16)]


def check(dkp, dhvx, want, dname) -> tuple:
    """(worst norm error, its key, within GRAD_TOL) over every gradient."""
    errs = {k: chip_smoke.norm_err(v, want[k]) for k, v in {**dkp, "dhvx": dhvx}.items()}
    worst = max(errs, key=errs.get)
    ok = all(e <= chip_smoke.GRAD_TOL[dname][chip_smoke.grad_group(k)] for k, e in errs.items())
    return errs[worst], worst, ok


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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("the probe needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    cases = []
    for nr, ns, dtype in SHAPES:
        ops = chip_smoke.kernel_operands(MLPConfig(), nr, ns, dtype, seed=nr + ns)
        dp = chip_smoke.cotangents(ops[0].n_planes, nr, ns, seed=nr + 1)
        want, want_hvx = fused_mlp.fused_bwd_reference(*ops, dp)
        cases.append((nr, ns, dtype, ops, dp, {**want, "dhvx": want_hvx}))
    caught = True
    with tempfile.TemporaryDirectory() as tmp:
        procs = {name: _build(Path(tmp), name, parts, lib="fused_mlp_bwd", edits=EDITS)
                 for name, parts in VARIANTS.items()}
        for name, proc in procs.items():
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        saved = build._loaded.get("fused_mlp_bwd")
        for name, proc in procs.items():
            lib = ctypes.CDLL(str(proc.lib))
            for fn, argtypes in build._SIGNATURES["fused_mlp_bwd"].items():
                getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, ctypes.c_int
            build._loaded["fused_mlp_bwd"] = lib  # the wrapper now launches the variant
            results = []
            for nr, ns, dtype, ops, dp, want in cases:
                dname = chip_smoke.dname_of(dtype)
                err, key, ok = check(*fused_mlp.fused_bwd(*ops, dp), want, dname)
                results.append((f"{nr}x{ns} {dname}", err, key, ok))
            nr, ns, dtype, ops, dp, _ = cases[-1]
            ms = chip_smoke.cuda_time_ms(lambda: fused_mlp.fused_bwd(*ops, dp), iters=3)
            sound = not VARIANTS[name]
            passes = all(r[3] for r in results)
            caught &= passes == sound
            print(f"probe fused_mlp_bwd {name}: {ms:.3f} ms at 4096x192 bf16; "
                  + "; ".join(f"{label} worst norm err {e:.3e} ({k}, {'passes' if ok else 'fails'})"
                              for label, e, k, ok in results), flush=True)
        if saved is not None:
            build._loaded["fused_mlp_bwd"] = saved
        else:
            build._loaded.pop("fused_mlp_bwd")
    for nr, ns, dtype, ops, dp, _ in cases[1:3]:
        explain(ops, dp, f"{nr}x{ns} {chip_smoke.dname_of(dtype)}")
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
