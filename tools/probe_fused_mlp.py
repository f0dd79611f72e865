"""The fused MLP kernel with parts of it broken or taken out: what each costs
in time, and whether chip_smoke.py's check would catch it.

    python3 tools/probe_fused_mlp.py

Needs one CUDA card. Each variant is simplenerf_torch/ops/csrc/fused_mlp_fwd.cu
(with the header it includes) with one text edit, built with the port's nvcc
flags into a temporary directory (all variants at once), then run at the fine serving chunk of the
published model (64k rays x 192 samples, bf16, chip_smoke.py's seeded
operands). For each it prints the time (CUDA events after one warm-up) and
the max abs error of its planes against `fused_apply_reference`, beside
chip_smoke.py's bf16 tolerance; then it serves chip_smoke.py's 64x64 crop of
the 756x1008 request through the variant and through the plain version and
prints chip_smoke.py's crop errors. The unedited kernel must pass both
checks and every broken variant must fail both; the script exits 1
otherwise. A time difference
bounds what the removed part costs, as the parts overlap. An edit that no
longer matches the source raises: update it with the kernel.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:  # a caller may have put another checkout first
    sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from simplenerf_torch.fields.mlp import MLPConfig  # noqa: E402
from simplenerf_torch.ops import build, fused_mlp  # noqa: E402

_MMA = (
    '      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "\n'
    '      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"'
)
_LDSM = (
    '  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\\n"\n'
    '               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])\n'
    '               : "r"(smem_addr(p)));'
)
_HEAD = "  __syncthreads();  // the tile was written by every warp's epilogue\n"
# Part -> [(text in the source, text in its place)].
EDITS = {
    "matmul": [(_MMA, '      ""'), (_LDSM, "  r[0] = r[1] = r[2] = r[3] = smem_addr(p);")],
    "slab copies": [("if (q < per_row) cp_async16(", "if (q < 0) cp_async16(")],
    "heads": [(_HEAD, _HEAD + "  return;\n")],
    "lo tile": [("  load_tile(s.lo, p.lo_ld", "  if (0) load_tile(s.lo, p.lo_ld")],
    "biases": [("const float b0 = bias[col], b1 = bias[col + 1];", "const float b0 = 0.f, b1 = 0.f;")],
    "hvx row": [("hvx + (size_t)((row0 + r) / ns)", "hvx + (size_t)((row0 + r + 1) / ns)")],
    "last k-step": [("    if (kk >= kc) break;", "    if (kk + 16 >= kc) break;")],
}
# Variant -> parts edited. The first is the kernel as committed.
VARIANTS = {
    "full kernel": [],
    "without heads": ["heads"],
    "without lo tile loads": ["lo tile"],
    "without matmul (mma, ldmatrix) and slab copies": ["matmul", "slab copies"],
    "without layer biases": ["biases"],
    "hvx read one row late": ["hvx row"],
    "without each slab's last k-step": ["last k-step"],
}


def _build(out: Path, name: str, parts: list[str], lib: str = "fused_mlp_fwd",
           edits: dict = EDITS) -> subprocess.Popen:
    """Start nvcc on csrc/<lib>.cu with the parts' edits applied: copies of
    every csrc source go to out/<variant>/, each edit to the one file named
    with it or else to every file that holds its text."""
    stem = "".join(c if c.isalnum() else "_" for c in name)
    src_dir = out / stem
    src_dir.mkdir()
    sources = {f.name: f.read_text() for f in build.CSRC.iterdir() if f.suffix in (".cu", ".cuh")}
    for part in parts:
        for edit in edits[part]:
            fname, old, new = edit if len(edit) == 3 else (None, *edit)
            hits = [f for f in sources if (fname in (None, f)) and old in sources[f]]
            if not hits:
                raise RuntimeError(f"probe edit for {part!r} no longer matches the kernel sources")
            for f in hits:
                sources[f] = sources[f].replace(old, new)
    for f, text in sources.items():
        (src_dir / f).write_text(text)
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out / f"lib{stem}.so"),
           str(src_dir / f"{lib}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.lib = out / f"lib{stem}.so"
    return proc


def main(nr: int = chip_smoke.CHUNK_RAYS, ns: int = 192) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("the probe needs a CUDA device")
    tol = chip_smoke.KERNEL_TOL["bfloat16"]
    spec, kp, lo, hi, hvx = ops = chip_smoke.kernel_operands(MLPConfig(), nr, ns, torch.bfloat16, seed=ns)
    want = fused_mlp.fused_apply_reference(*ops)
    n = lo.shape[0]
    words, wts, fpar, smem = fused_mlp.pack_program(spec, kp, n)
    out = torch.empty((spec.n_planes, nr, ns), dtype=torch.float32, device="cuda")
    argtypes = build._SIGNATURES["fused_mlp_fwd"]["snerf_fused_mlp_fwd"]
    print(f"{chip_smoke.card_line()}; fine chunk {n} points, bf16, "
          f"{spec.flops_per_point() * n / 1e12:.2f} TFLOP; tolerance {tol:g}", flush=True)
    caught = True
    with tempfile.TemporaryDirectory() as tmp:
        procs = {name: _build(Path(tmp), name, parts) for name, parts in VARIANTS.items()}
        db, _, run_dir, cfg, mc = chip_smoke.make_scene(Path(tmp) / "scene", 189, 252)
        tester, pose, K = chip_smoke.large_request(db, run_dir, cfg, mc, 4)
        crop, _, _ = chip_smoke.center_crop(tester, pose, K)
        for name, proc in procs.items():
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for name, proc in procs.items():
            lib = ctypes.CDLL(str(proc.lib))
            fn = lib.snerf_fused_mlp_fwd
            fn.argtypes, fn.restype = argtypes, ctypes.c_int

            def run():
                stream = torch.cuda.current_stream().cuda_stream
                rc = fn(1, words.ctypes.data_as(ctypes.c_void_p), int(words.size), *map(
                    fused_mlp._ptr, (lo, hi, hvx, wts, fpar, out)), smem, ctypes.c_void_p(stream))
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            out.fill_(float("nan"))  # a plane left unwritten reads as infinitely wrong
            ms = chip_smoke.cuda_time_ms(run, iters=5)
            err = (out - torch.stack(want)).abs().nan_to_num(float("inf")).max().item()
            build._loaded["fused_mlp_fwd"] = lib  # the wrapper now launches the variant
            crop_err, _ = chip_smoke.crop_errors(tester, crop)
            crop_worst = max(crop_err.values())
            passes = err <= tol, crop_worst <= chip_smoke.CROP_TOL  # NaN fails
            sound = not VARIANTS[name]
            caught &= passes == (sound, sound)
            print(f"probe fused_mlp_fwd {name}: {ms:.3f} ms, max abs err {err:.3e} "
                  f"({'passes' if passes[0] else 'fails'} the check); crop worst {crop_worst:.3e} "
                  f"({'passes' if passes[1] else 'fails'}): "
                  + ", ".join(f"{k} {v:.2e}" for k, v in crop_err.items()), flush=True)
        build._loaded.pop("fused_mlp_fwd")
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
