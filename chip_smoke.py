#!/usr/bin/env python3
"""Chip smoke for simplenerf_torch: serve the published SimpleNeRF on one CUDA card.

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero without a result):
  1. device: the card's name and power limit, as nvidia-smi reports them;
  2. build: compile every CUDA source of the serving path with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the published width (8x256 trunk, 1x128 views, PE 10/4), for the main,
     points-augmentation, Lambertian and visibility-head MLPs, 64 and 192
     samples per ray, float32 and bfloat16, on 1037 rays;
  4. serve: a seeded synthetic scene (189x252, 6 frames, 3 for training),
     the published bf16 recipe with seeded random weights in a checkpoint,
     `runner.start_testing` over its test frames, then one 756x1008 request
     through `Tester.predict_frame`; the launch counters must show the
     kernel served every chunk, and a 4096-ray crop of the frame is held
     against the plain path;
  5. chunks: each kernel at the chunk shapes serving gives it (64k rays x
     64 / 192 samples for the 756x1008 frame, one test frame's chunk, and a
     41,152-ray chunk), held against its plain version; at the 64k shapes
     it is also timed with CUDA events after warm-up, beside the plain
     version and the card's bound.
The last line is {"ok": true, "device": {...}}; the line before it holds the
per-kernel JSON.
"""

from __future__ import annotations

import json
import math
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


def fail(msg: str):
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def check_planes(label: str, dname: str, got, want) -> float:
    """Max abs error of the kernel's planes against the plain version's; fails past KERNEL_TOL."""
    import torch

    err = torch.stack([(a - b).abs().max() for a, b in zip(got, want)]).nan_to_num(float("inf"))
    err = err.max().item()
    scale = max(b.abs().max().item() for b in want)
    print(f"kernel fused_mlp_fwd {label} {dname}: max abs err {err:.3e} "
          f"(tol {KERNEL_TOL[dname]:g}; planes up to {scale:.3e})", flush=True)
    if not err <= KERNEL_TOL[dname]:
        fail(f"fused_mlp_fwd disagrees with its plain version: {label} {dname}")
    return err


def check_kernels() -> dict:
    """Kernel vs plain version at the published width; returns max errors by dtype."""
    import torch

    from simplenerf_torch.fields.mlp import MLPConfig
    from simplenerf_torch.ops import fused_mlp

    configs = {
        "main": MLPConfig(),
        "points_aug": MLPConfig(points_sigma_pe_degree=3),
        "lambertian": MLPConfig(use_view_dirs=False, view_dependent_rgb=False),
        "visibility": MLPConfig(predict_visibility=True),
    }
    worst = {"float32": 0.0, "bfloat16": 0.0}
    nr = 1037  # not a multiple of any power of two
    for name, cfg in configs.items():
        for ns in (64, 192):
            for dtype in (torch.float32, torch.bfloat16):
                dname = "bfloat16" if dtype == torch.bfloat16 else "float32"
                ops = kernel_operands(cfg, nr, ns, dtype, seed=len(name) + ns)
                got = fused_mlp.fused_apply(*ops)
                want = fused_mlp.fused_apply_reference(*ops)
                err = check_planes(f"{name} {nr} rays x {ns}", dname, got, want)
                worst[dname] = max(worst[dname], err)
    return worst


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
              f"bound {bound_ms:.3f} ms", flush=True)
        del ops, lo, hi, hvx, kp
        torch.cuda.empty_cache()
    fused_mlp.fused_apply.launches = saved  # these launches are not the main path's
    return out


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
    lib = build.build_library("fused_mlp_fwd")
    build.load_library("fused_mlp_fwd")
    print(f"build: fused_mlp_fwd in {time.perf_counter() - t0:.1f} s -> {lib.name}", flush=True)
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: ptxas {line.strip()}", flush=True)

    worst = check_kernels()
    h, w = 189, 252
    with tempfile.TemporaryDirectory() as tmp:
        served = serve(Path(tmp), h, w)
    timing = chunk_kernels(test_rays=min(CHUNK_RAYS, -(-(h * w) // 256) * 256))

    fine, coarse = timing["fine"], timing["coarse"]
    print(f"serve: {served['frame_s']:.3f} s per served 756x1008 frame; "
          f"{served['test_s'] / served['frames']:.3f} s per 189x252 test frame incl. file output",
          flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    kernels = [{
        "name": "fused_mlp_fwd",
        "route": "cuda",
        "source": "simplenerf_torch/ops/csrc/fused_mlp_fwd.cu",
        "replaces": "simplenerf_tpu/ops/fused_mlp.py:448",
        "launches": served["launches"],
        "max_abs_err": max(worst["bfloat16"], timing["max_abs_err"]),
        "max_abs_err_f32": worst["float32"],
        "ms": fine["ms"],
        "plain_ms": fine["plain_ms"],
        "bound_ms": fine["bound_ms"],
        "bound_by": fine["bound_by"],
        "library_ms": None,
        "shape": f"fine chunk: {fine['rows']} points, bf16",
        "coarse_chunk": {k: coarse[k] for k in ("rows", "ms", "plain_ms", "bound_ms")},
    }]
    if not all(math.isfinite(v) for v in (fine["ms"], fine["plain_ms"], fine["bound_ms"])):
        fail("non-finite timing")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
