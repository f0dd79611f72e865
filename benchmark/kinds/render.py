"""Render traffic: frames through `Tester.predict_frame` at poses on a spiral
drawn from the seed, outputs back to the host. The check renders a sample of
the window's frames, at a sample of their pixels, in the reference."""

from __future__ import annotations

import copy
import math
import time
from pathlib import Path

import numpy as np

from benchmark import counts, harness, reference, scene
from benchmark import trace as trace_lib


def setup(cell, seed: int, device, workdir: Path) -> dict:
    from simplenerf_torch.data.preprocessor import ScenePreprocessor
    from simplenerf_torch.training.tester import Tester

    cfg = copy.deepcopy(cell.config["train_configs"])
    s31 = seed % 2**31
    cfg["seed"] = s31
    assumed = cell.config["assumed"]
    raw = scene.make_llff_scene(seed, assumed, device)
    pp = ScenePreprocessor(cfg, "train", raw, device=device, seed=s31)
    model_configs = pp.get_model_configs()
    del pp
    tester = Tester(cfg, model_configs, device=device, chunk=cell.traffic["chunk"])
    params = scene.make_weights(seed, cfg, device, sigma_bias=assumed["render_sigma_bias"])
    tester.params = scene.tree_map(lambda t: t.clone(), params)
    poses = scene.spiral_poses(seed, raw, cell.traffic["poses"], cell.traffic["radius_scale"])
    tester.predict_frame(poses[-1])  # warm-up: every shape a frame uses
    harness.sync(device)
    return {"cfg": cfg, "raw": raw, "tester": tester, "params": params, "poses": poses,
            "frames": [], "next": 0}


def render_frames(st: dict, n: int = None, seconds: float = None) -> dict:
    tester, poses = st["tester"], st["poses"]
    t0 = time.perf_counter()
    lat = []
    while True:
        i = st["next"]
        t1 = time.perf_counter()
        out = tester.predict_frame(poses[i % len(poses)])
        lat.append(time.perf_counter() - t1)
        st["frames"].append((i % len(poses), out))
        st["next"] += 1
        if (n is not None and len(lat) >= n) or (seconds is not None and time.perf_counter() - t0 >= seconds):
            break
    return {"frames": len(lat), "seconds": time.perf_counter() - t0, "latency_s": lat}


def window(st: dict, cell, seconds: float, device) -> tuple:
    """Frames until `seconds` have passed: ms a frame over all of them."""
    win = render_frames(st, seconds=seconds)
    lines = ["frame latencies ms: " + " ".join(f"{x * 1e3:.2f}" for x in win["latency_s"]),
             f"window: {win['frames']} frames in {win['seconds']:.4f} s"]
    return win["frames"], 1e3 * win["seconds"] / win["frames"], lines


def traced(st: dict, cell, device, workdir: Path) -> dict:
    tr = cell.traffic
    pre = st["tester"].preprocessor
    make_t, get_t = [], []
    pre.create_test_data = harness.Timed(pre.create_test_data, make_t)
    pre.retrieve_inference_outputs = harness.Timed(pre.retrieve_inference_outputs, get_t, device)
    render_frames(st, n=tr["span_frames"])
    del pre.create_test_data, pre.retrieve_inference_outputs
    ctx = {"spans": {"frame_host_s": [a + b for a, b in zip(make_t, get_t)]}}
    events, seconds = harness.profiled(device, lambda: render_frames(st, n=tr["trace_frames"]),
                                       "bench::window", workdir, host=False)
    ctx["window"] = harness.window_summary(events, seconds)
    ctx["window"]["frames"] = ctx["attempted"] = tr["trace_frames"]
    events, _ = harness.profiled(device, lambda: render_frames(st, n=tr["label_frames"]),
                                 "bench::labels", workdir)
    ctx["window"]["idle_gaps"] = harness.gap_labels(events, "bench::labels")
    ctx["ops"] = {"us": trace_lib.op_scoped_us(events), "units": tr["label_frames"]}
    ctx["counts"] = frame_counts(cell)
    return ctx


def frame_counts(cell) -> dict:
    cfg = cell.config["train_configs"]
    mlps = scene.model_mlps(cfg)
    h, w = cell.config["assumed"]["height"], cell.config["assumed"]["width"]
    nr = h * w
    chunk = cell.traffic["chunk"]
    n_chunks = -(-nr // chunk)
    ns_c = mlps["coarse"]["num_samples"]
    ns_f = ns_c + mlps["fine"]["num_samples"]
    dt = cell.dtype
    per_chunk = (counts.bound_s(counts.fwd_op([mlps["coarse"]], chunk, ns_c, dt), dt)
                 + counts.bound_s(counts.fwd_op([mlps["fine"]], chunk, ns_f, dt), dt))
    return {"frame_flops": counts.frame_flops(mlps, nr), "fwd_bound_s": n_chunks * per_chunk}


def release(st: dict):
    st.pop("tester")


def compare_frame(got: dict, want: dict) -> dict:
    """Gaps of the program's outputs from the reference's, at the same pixels."""
    def gap(key):
        return np.abs(got[key].astype(np.float64) - want[key].astype(np.float64))

    img, dn, dv = gap("image"), gap("depth_ndc"), gap("depth_var_ndc")
    return {"image_mae": float(img.mean()), "image_max": float(img.max()),
            "depth_ndc_mae": float(dn.mean()), "depth_ndc_max": float(dn.max()),
            "depth_var_ndc_mae": float(dv.mean())}


def at_pixels(frame: dict, pixels) -> dict:
    """A served frame's outputs (h, w[, c]) at flat raster indices."""
    n = frame["depth"].size
    return {k: v.reshape(n, -1)[pixels].reshape((len(pixels),) + v.shape[2:])
            for k, v in frame.items()}


def check(st: dict, cell, seed: int, device, precision=None, answer=None) -> dict:
    """The reference renders a sample of the window's frames at a sample of
    their pixels, both drawn from the seed; the widest reading over them.
    `answer(pose, pixels)` stands in for the program's frames (the control)."""
    frames = st["frames"]
    rng = np.random.default_rng([seed, 3])
    k = min(cell.traffic["check_frames"], len(frames))
    pick = sorted(rng.choice(len(frames), size=k, replace=False).tolist())
    h, w = cell.config["assumed"]["height"], cell.config["assumed"]["width"]
    n_pix = min(cell.traffic["check_pixels"], h * w)
    worst: dict = {}
    for j in pick:
        pose_i, frame = frames[j]
        pixels = np.sort(rng.choice(h * w, size=n_pix, replace=False))
        pose = st["poses"][pose_i]
        want = reference.render_frame(st["raw"], st["cfg"], st["params"], pose,
                                      precision or cell.dtype, device, pixels=pixels)
        got = answer(pose, pixels) if answer else at_pixels(frame, pixels)
        for key, v in compare_frame(got, want).items():
            worst[key] = max(worst.get(key, 0.0), v) if math.isfinite(v) else math.inf
        worst["acc_mean"] = float(want["acc"].mean())
    return {"numbers": worst, "frames": pick}
