"""The forward kernels with parts of them broken or taken out: whether
chip_smoke.py's checks catch each fault, and what each part costs in time.

    python3 tools/probe_fused_mlp.py                  # broken variants, then the timing split
    python3 tools/probe_fused_mlp.py --timing         # the timing split only
    python3 tools/probe_fused_mlp.py --parent DIR     # time DIR's forward kernel instead

Needs one CUDA card. Each variant is simplenerf_torch/ops/csrc/fused_mlp_fwd.cu
with the headers it includes, one text edit applied, built with the port's
nvcc flags into a temporary directory (all variants at once); the wrappers
then launch it in place of the built library.

Broken variants (the swizzle XOR on row + 1, the k16 descriptor advance one
step on, a quad sum without one lane, hvx read one row late, no layer
biases, the ragged tail's stores unmasked, the register A fragments of
neighbouring k16 steps swapped, one staging area of bias and hvx rows for
both consumers, which the ping-pong's offset layers overwrite) run the
published main MLP in
bf16 with chip_smoke.py's seeded operands at the fine serving chunk (64k
rays x 192) and at 1037 rays x 64 (a ragged last block), and the max abs
error of their planes against `fused_apply_reference` is held to
chip_smoke.py's bf16 tolerance; then a 63x63 crop (a ragged last block) of
chip_smoke.py's 756x1008 request is served through the variant and through
the plain version and held to chip_smoke.py's crop tolerance. The unedited
kernel must pass both checks and every broken variant must fail both; the
script exits 1 otherwise.

Float32 variants (the 3xTF32 engine, fused_mlp_tf32_sm90.cuh: one TF32
product, big x big, in place of three; the A fragment's columns out of
the packer's K order) run the published main MLP in float32 at 1037 x 64
and at the fine training step (4096 x 192): the planes are held to
chip_smoke.py's float32 tolerance against `fused_apply_reference` and to
its float64 yardstick (the kernel's max abs error against the plain
version in float64 at most chip_smoke.YARDSTICK times the float32 plain
version's; both printed). The unedited kernel must pass both and each
broken variant must fail one.

Timing split (bf16): the kernel as committed; without the heads, the epilogue's
bias loads, its head-weight loads or its hvx loads, or without the lo
tile's loads; the consumers without turns on the tensor cores (both issue
at once, as in lockstep: what the ping-pong itself gains), and with the
turn handed on after half a layer's slabs or after its first;
the products and the ring without the epilogue (bf16: but its rounding
into the next layer's A registers); and the products alone (that, and the
first ring fill loaded once and never waited on again; ptxas drops a wgmma
whose results are dead, so one data-dependent store keeps them): each at the
four shapes the main path gives the forward (the 64k-ray serving chunks at
64 and 192 samples, the training step's fine 4096 x 192 and coarse trio
4096 x 64), CUDA events over launches through the wrappers after one
warm-up, with ptxas registers and spill bytes (and whether ptxas
serialized the build's wgmma) and the host's time to issue
one call (packing included, no synchronisation). Parts overlap, so a
difference bounds what a part costs. `--parent DIR` runs the same timing
on another checkout's package and kernel (unpack `git archive <commit>`
into a gitignored directory such as build/parent), where only the
unedited kernel is timed. Float32 split: the kernel as committed, its
products and ring without the epilogue, and one TF32 product in place of
three, at the training step's float32 shapes (fine 4096 x 192, trio 4096 x
64). An edit that no longer matches the source raises for a broken variant
and skips a timing variant.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:  # a caller may have put another checkout first
    sys.path.insert(0, str(REPO))

_SM90 = "fused_mlp_sm90.cuh"
_TF32 = "fused_mlp_tf32_sm90.cuh"
_ONE_PASS = [(_TF32, "          mma(part, small[s], db + 2 * s);\n          mma(part, big[s], ds + 2 * s);\n", "")]
# Part -> [(file, text in it, text in its place)].
EDITS = {
    "swizzle": [(_SM90, "{ return chunk ^ (r & 7); }", "{ return chunk ^ ((r + 1) & 7); }")],
    "k16 advance": [(_SM90, "Mma<N>::run(acc, da + 2 * kk, db + 2 * kk,",
                     "Mma<N>::run(acc, da + 2 * (kk + 1), db + 2 * (kk + 1),")],
    "quad sum": [(_SM90, "    a0 += a1;\n", "    a0 += q == 2 ? 0.f : a1;\n")],
    "hvx row": [(_SM90, "min(row0 + r0, n_rows - 1)", "min(row0 + r0 + 1, n_rows - 1)"),
                (_SM90, "min(row0 + r1, n_rows - 1)", "min(row0 + r1 + 1, n_rows - 1)")],
    "biases": [(_SM90, "const float2 b = *reinterpret_cast<const float2*>(cst + col);",
                "const float2 b = make_float2(0.f, 0.f);")],
    "ragged tail": [(_SM90, "if (row0 + r0 < n_rows) plane[", "plane["),
                    (_SM90, "if (row0 + r1 < n_rows) plane[", "plane[")],
    "fragment swap": [(_SM90, "const int f = 16 * k + 4 * kk;", "const int f = 16 * k + 4 * (kk ^ 1);")],
    # The consumers' staging areas as one: in ping-pong consumer 0 stages
    # layer L + 1's bias (and hvx rows) while consumer 1's epilogue of L reads.
    "one staging area": [(_SM90, "  float* cst = s.cst + c * p.cst_floats;\n", "  float* cst = s.cst;\n")],
    "one pass": _ONE_PASS,
    "fragment order": [(_TF32, "const float v[4] = {x0.x, x1.x, x0.y, x1.y};",
                        "const float v[4] = {x0.x, x0.y, x1.x, x1.y};")],
}
# Variant -> parts edited. The first is the kernel as committed.
VARIANTS = {
    "full kernel": [],
    "swizzle XOR on row + 1": ["swizzle"],
    "k16 descriptor advance one step on": ["k16 advance"],
    "quad sum without one lane": ["quad sum"],
    "hvx read one row late": ["hvx row"],
    "without layer biases": ["biases"],
    "ragged tail unmasked": ["ragged tail"],
    "A fragments of neighbouring k16 steps swapped": ["fragment swap"],
    "one staging area for both consumers": ["one staging area"],
}
# The float32 engine's variants; the unedited kernel is "full kernel" above.
F32_VARIANTS = {
    "float32: one TF32 product (big x big) in place of three": ["one pass"],
    "float32: the A fragment's columns out of the packer's K order": ["fragment order"],
}
TIMING_EDITS = {
    # Without the heads nothing reads the activations: one data-dependent
    # store keeps the products alive (ptxas drops a wgmma whose results are dead).
    "heads": [(_SM90, "  const bool has_head = nout > 0;\n",
               "  if (acc[0] == 1.2345e-30f) out[t] = acc[N / 2 - 1];\n  const bool has_head = false;\n")],
    "no turns": [(_SM90, "  turn_wait(c);\n", ""),
                 (_SM90, "if (++n_issued == hand && (!last || c == 0)) turn_pass(c);", ""),
                 (_SM90, "  if (c == 1) turn_pass(1);  // consumer 0 takes the first turn\n", "")],
    "bias loads": EDITS["biases"],
    "head-weight loads": [(_SM90, "const float2 w = *reinterpret_cast<const float2*>(hw + o * N + col);",
                           "const float2 w = make_float2(0.5f, 0.25f);")],
    "hvx loads": [(_SM90, "  if (op.flags & FLAG_HVX) {\n    // Staged", "  if (false) {\n    // Staged")],
    "lo tile loads": [(_SM90, "  load_rows(tl.lo, lo, p.in_lo,", "  if (0) load_rows(tl.lo, lo, p.in_lo,")],
    # ptxas drops a wgmma whose results nobody reads: one data-dependent store keeps them.
    "half turns": [(_SM90, "const int hand = kSplit ? min(slabs, p.hand) : slabs;",
                    "const int hand = (slabs + 1) / 2;")],
    "one-slab turns": [(_SM90, "const int hand = kSplit ? min(slabs, p.hand) : slabs;",
                        "const int hand = 1;")],
    # What stays of the epilogue is the rounding into the next layer's A
    # registers: without it ptxas serializes the wgmma (register resources).
    "epilogue": [(_SM90, "  epilogue<N, kPre>(acc, a, op, p, s, cst, hvx, out, fpar, pre, row0, t);\n",
                  "#pragma unroll\n  for (int j = 0; j < N / 4; ++j)\n"
                  "    a[j] = bf16x2_bits(__floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]));\n"
                  "  if (acc[0] == 1.2345e-30f) out[t] = acc[N / 2 - 1];\n")],
    "ring": [(_SM90, "      mbar_wait(s.empty + slot, phase ^ 1);\n", "      if (it >= p.stages) return;\n"),
             (_SM90, "    mbar_wait(s.full + slot, phase);\n",
              "    if (it < p.stages) mbar_wait(s.full + slot, phase);\n")],
    "f32 epilogue": [(_TF32, "  fwd_epilogue<N>(acc, op, p, s, const_cast<unsigned char*>(tiles[sm90::SRC_ACT]), cst, hvx, out, fpar,\n                  row0, t);\n",
                      "  if (acc[0] == 1.2345e-30f) out[t] = acc[N / 2 - 1];\n")],
    "f32 one pass": _ONE_PASS,
}
TIMING = {
    "full kernel": [],
    "without heads": ["heads"],
    "without bias loads": ["bias loads"],
    "without head-weight loads": ["head-weight loads"],
    "without hvx loads": ["hvx loads"],
    "without lo tile loads": ["lo tile loads"],
    "lockstep: the consumers issue without turns": ["no turns"],
    "turns handed on after half a layer's slabs": ["half turns"],
    "turns handed on after a layer's first slab": ["one-slab turns"],
    "products and ring, no epilogue": ["epilogue"],
    "products alone": ["epilogue", "ring"],
}
TIMING_F32 = {
    "float32 full kernel": [],
    "float32 products and ring, no epilogue": ["f32 epilogue"],
    "float32 one TF32 product in place of three": ["f32 one pass"],
}


def _edited_sources(parts: list[str], edits: dict) -> dict:
    """csrc's sources with the parts' edits applied; each edit goes to the one
    file named with it or else to every file that holds its text."""
    from simplenerf_torch.ops import build

    sources = {f.name: f.read_text() for f in build.CSRC.iterdir() if f.suffix in (".cu", ".cuh")}
    for part in parts:
        for edit in edits[part]:
            fname, old, new = edit if len(edit) == 3 else (None, *edit)
            hits = [f for f in sources if (fname in (None, f)) and old in sources[f]]
            if not hits:
                raise RuntimeError(f"probe edit for {part!r} no longer matches the kernel sources")
            for f in hits:
                sources[f] = sources[f].replace(old, new)
    return sources


def _applies(parts: list[str], edits: dict) -> bool:
    try:
        _edited_sources(parts, edits)
        return True
    except RuntimeError:
        return False


def _build(out: Path, name: str, parts: list[str], lib: str = "fused_mlp_fwd",
           edits: dict = EDITS, flags: tuple = ()) -> subprocess.Popen:
    """Start nvcc on csrc/<lib>.cu with the parts' edits applied, the sources
    copied to out/<variant>/, and the port's flags plus `flags`; the library
    goes to `proc.lib`."""
    from simplenerf_torch.ops import build

    stem = "".join(c if c.isalnum() else "_" for c in name)
    src_dir = out / stem
    src_dir.mkdir()
    for f, text in _edited_sources(parts, edits).items():
        (src_dir / f).write_text(text)
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", str(out / f"lib{stem}.so"),
           str(src_dir / f"{lib}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.lib = out / f"lib{stem}.so"
    return proc


def _load(path: Path) -> ctypes.CDLL:
    from simplenerf_torch.ops import build

    lib = ctypes.CDLL(str(path))
    for fn, argtypes in build._SIGNATURES["fused_mlp_fwd"].items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, ctypes.c_int
    return lib


def _bf16_ptxas(log: str, f32: bool = False) -> str:
    """Registers and spill bytes of the bf16 (or float32) forward kernel in an nvcc log."""
    import chip_smoke

    for entry, r in chip_smoke.ptxas_report(log).items():
        label = chip_smoke.kernel_label(entry)
        if "registers" in r and (label == "fused_mlp_fwd_tf32_kernel" if f32 else
                                 ("sm90" in label or label.endswith("bf16"))):
            why = sorted({ln.split("serialized", 1)[1].strip() for ln in log.splitlines()
                          if "serialized" in ln})
            serial = f" ptxas serialized its wgmma ({'; '.join(why)})," if why else ""
            return (f"{label}:{serial} {r['registers']} registers, {r.get('spill_stores', 0)} / "
                    f"{r.get('spill_loads', 0)} B spill stores / loads")
    return f"no {'float32' if f32 else 'bf16'} forward kernel in the log"


def _shapes(f32: bool = False):
    """name -> (call, flops) at the four shapes the main path gives the
    forward (float32: the training step's two)."""
    import torch

    import chip_smoke
    from simplenerf_torch.fields.mlp import MLPConfig
    from simplenerf_torch.ops import fused_mlp

    out = {}
    cd = torch.float32 if f32 else torch.bfloat16
    for name, nr, ns in (("serve coarse 65536 x 64", chip_smoke.CHUNK_RAYS, 64),
                         ("serve fine 65536 x 192", chip_smoke.CHUNK_RAYS, 192),
                         ("step fine 4096 x 192", chip_smoke.STEP_RAYS, chip_smoke.FINE_NS)):
        if f32 and "serve" in name:
            continue
        ops = chip_smoke.kernel_operands(MLPConfig(), nr, ns, cd, seed=ns)
        out[name] = ((lambda ops=ops: fused_mlp.fused_apply(*ops)), ops[0].flops_per_point() * nr * ns)
    ens, kps, lo, hvxs = chip_smoke.ensemble_operands(chip_smoke.STEP_RAYS, chip_smoke.COARSE_NS,
                                                      cd, seed=5)
    out["step trio 4096 x 64"] = ((lambda: fused_mlp.fused_apply_ensemble(ens, kps, lo, hvxs)),
                                  ens.flops_per_point() * lo.shape[0])
    return out


def _time(shapes) -> dict:
    """name -> (kernel ms by CUDA events, host ms to issue one call)."""
    import torch

    import chip_smoke

    out = {}
    for name, (call, _) in shapes.items():
        ms = chip_smoke.cuda_time_ms(call, iters=10 if "serve" in name else 20)
        host = []
        for _ in range(10):
            t0 = time.perf_counter()
            call()
            host.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        out[name] = (ms, statistics.median(host))
    return out


def _check(name: str, sound: bool, ops_list, want_list, tester, crop) -> bool:
    """Planes against the plain version and the crop against the plain path;
    True when the outcome is the expected one (sound passes, broken fails)."""
    import torch

    import chip_smoke
    from simplenerf_torch.ops import fused_mlp

    err = 0.0
    for ops, want in zip(ops_list, want_list):
        got = torch.stack(fused_mlp.fused_apply(*ops))
        err = max(err, (got - torch.stack(want)).abs().nan_to_num(float("inf")).max().item())
    crop_err, _ = chip_smoke.crop_errors(tester, crop)
    crop_worst = max(crop_err.values())
    passes = err <= chip_smoke.KERNEL_TOL["bfloat16"], crop_worst <= chip_smoke.CROP_TOL  # NaN fails
    print(f"probe fused_mlp_fwd {name}: max abs err {err:.3e} "
          f"({'passes' if passes[0] else 'fails'} the check); crop worst {crop_worst:.3e} "
          f"({'passes' if passes[1] else 'fails'}): "
          + ", ".join(f"{k} {v:.2e}" for k, v in crop_err.items()), flush=True)
    return passes == (sound, sound)


def _check_f32(name: str, sound: bool, cases) -> bool:
    """Float32 planes against the plain version (KERNEL_TOL) and against the
    float64 yardstick; True when the outcome is the expected one (sound
    passes both, broken fails one)."""
    import torch

    import chip_smoke
    from simplenerf_torch.ops import fused_mlp

    ok, readings = True, []
    for label, ops, want, exact in cases:
        got = torch.stack(fused_mlp.fused_apply(*ops))
        err = (got - torch.stack(want)).abs().nan_to_num(float("inf")).max().item()
        k_err = (got.double() - torch.stack(exact)).abs().nan_to_num(float("inf")).max().item()
        p_err = (torch.stack(want).double() - torch.stack(exact)).abs().max().item()
        ratio = k_err / max(p_err, 1e-300)
        ok &= err <= chip_smoke.KERNEL_TOL["float32"] and ratio <= chip_smoke.YARDSTICK
        readings.append(f"{label} max abs err {err:.3e}, vs float64 {k_err:.3e} against the plain "
                        f"version's {p_err:.3e} (ratio {ratio:.2f})")
    print(f"probe fused_mlp_fwd {name}: {'passes' if ok else 'fails'}: " + "; ".join(readings),
          flush=True)
    return ok == sound


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timing", action="store_true", help="only the timing split")
    ap.add_argument("--parent", type=Path,
                    help="a checkout of an earlier commit whose forward kernel (and wrappers) to "
                         "time instead of this one's; implies --timing")
    args = ap.parse_args()
    import torch

    import chip_smoke  # this checkout's: its helpers import the package lazily

    if args.parent:  # the package, its kernel sources and wrappers from the other checkout
        sys.path.insert(0, str(args.parent.resolve()))
    from simplenerf_torch.fields.mlp import MLPConfig
    from simplenerf_torch.ops import build, fused_mlp

    if not torch.cuda.is_available():
        raise SystemExit("the probe needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{chip_smoke.card_line()}; kernel sources {build.CSRC}", flush=True)
    broken = {} if args.timing or args.parent else {**VARIANTS, **F32_VARIANTS}
    timing = {name: parts for name, parts in {**TIMING, **TIMING_F32}.items()
              if _applies(parts, TIMING_EDITS)}
    skipped = [name for name in {**TIMING, **TIMING_F32} if name not in timing]
    if skipped:
        print(f"timing variants whose edits do not match these sources, skipped: {skipped}",
              flush=True)
    caught = True
    with tempfile.TemporaryDirectory() as tmp:
        procs = {name: _build(Path(tmp), name, parts) for name, parts in broken.items()}
        tprocs = {name: _build(Path(tmp), "timing " + name, parts, edits=TIMING_EDITS)
                  for name, parts in timing.items()}
        logs = {}
        for name, proc in {**procs, **{("timing", k): v for k, v in tprocs.items()}}.items():
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            logs[name] = log

        if broken:
            tol = chip_smoke.KERNEL_TOL["bfloat16"]
            ops_list, want_list = [], []
            for nr, ns in ((chip_smoke.CHUNK_RAYS, 192), (1037, 64)):
                ops = chip_smoke.kernel_operands(MLPConfig(), nr, ns, torch.bfloat16, seed=ns)
                ops_list.append(ops)
                want_list.append(fused_mlp.fused_apply_reference(*ops))
            db, _, run_dir, cfg, mc = chip_smoke.make_scene(Path(tmp) / "scene", 189, 252)
            tester, pose, K = chip_smoke.large_request(db, run_dir, cfg, mc, 4)
            crop, _, _ = chip_smoke.center_crop(tester, pose, K, c=63)
            print(f"broken variants: planes at {chip_smoke.CHUNK_RAYS} x 192 and 1037 x 64, "
                  f"tolerance {tol:g}; a 63x63 crop, tolerance {chip_smoke.CROP_TOL:g}", flush=True)
            for name, proc in procs.items():
                if name not in VARIANTS:
                    continue
                build._loaded["fused_mlp_fwd"] = _load(proc.lib)  # the wrappers launch the variant
                caught &= _check(name, not VARIANTS[name], ops_list, want_list, tester, crop)
            del ops_list, want_list
            cases = []
            for nr, ns in ((1037, 64), (chip_smoke.STEP_RAYS, chip_smoke.FINE_NS)):
                ops = chip_smoke.kernel_operands(MLPConfig(), nr, ns, torch.float32, seed=ns)
                ops64 = (fused_mlp.with_dtype(ops[0], "float64"), *chip_smoke._double(ops[1:]))
                cases.append((f"{nr} x {ns}", ops, fused_mlp.fused_apply_reference(*ops),
                               fused_mlp.fused_apply_reference(*ops64)))
            print(f"float32 variants: planes at 1037 x 64 and {chip_smoke.STEP_RAYS} x "
                  f"{chip_smoke.FINE_NS}, tolerance {chip_smoke.KERNEL_TOL['float32']:g}, and the "
                  f"float64 yardstick (limit {chip_smoke.YARDSTICK:g})", flush=True)
            for name in ["full kernel", *F32_VARIANTS]:
                build._loaded["fused_mlp_fwd"] = _load(procs[name].lib)
                caught &= _check_f32(name, name == "full kernel", cases)
            del cases
            torch.cuda.empty_cache()

        shapes, shapes32 = _shapes(), None
        for name, proc in tprocs.items():  # with --parent: the parent's sources, unedited
            build._loaded["fused_mlp_fwd"] = _load(proc.lib)
            f32 = name in TIMING_F32
            if f32 and shapes32 is None:
                shapes32 = _shapes(f32=True)
            got = _time(shapes32 if f32 else shapes)
            print(f"timing fused_mlp_fwd {name} ({_bf16_ptxas(logs[('timing', name)], f32)}):",
                  flush=True)
            for shape, (ms, host) in got.items():
                tflops = (shapes32 if f32 else shapes)[shape][1] / ms / 1e9
                print(f"timing   {shape}: {ms:.3f} ms ({tflops:.1f} TFLOP/s), host {host:.3f} ms "
                      f"to issue a call", flush=True)
        build._loaded.pop("fused_mlp_fwd", None)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
