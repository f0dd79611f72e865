"""Inputs made from the seed: the synthetic LLFF scene, the spiral of test
poses and the MLP weights.

The scene is a textured slanted plane seen by forward-facing cameras, in
the layout the LLFF loader hands to `ScenePreprocessor` (uint8 images,
OpenCV world-to-camera extrinsics, intrinsics, depth bounds, per-frame
COLMAP-style sparse depth points). Its few scalars (poses, plane, texture
frequencies) come from a numpy generator seeded with the run's seed; the
pixels are computed on the device in one pass per frame. The weights are
drawn on the device in one call and split into the parameter tree of each
MLP, with torch.nn.Linear's law U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
"""

from __future__ import annotations

import math

import numpy as np
import torch

N_WAVES = 8  # sinusoids summed per colour channel of the texture


def scene_scalars(seed: int, assumed: dict) -> dict:
    """The scene's scalars from the seed: camera poses, plane, texture."""
    rng = np.random.default_rng([seed, 1])
    n = assumed["train_frames"]
    base = assumed["camera_baseline"]
    tilt = math.radians(assumed["camera_tilt_deg"])
    c2ws = []
    for _ in range(n):
        ax, ay = rng.uniform(-tilt, tilt, size=2)
        rx = np.array([[1, 0, 0], [0, math.cos(ax), -math.sin(ax)], [0, math.sin(ax), math.cos(ax)]])
        ry = np.array([[math.cos(ay), 0, math.sin(ay)], [0, 1, 0], [-math.sin(ay), 0, math.cos(ay)]])
        c2w = np.eye(4)
        c2w[:3, :3] = ry @ rx
        c2w[:3, 3] = [*rng.uniform(-base, base, size=2), rng.uniform(-0.1 * base, 0.1 * base)]
        c2ws.append(c2w)
    return {
        "c2ws": np.stack(c2ws),
        "plane": np.array([assumed["plane_depth"], *rng.uniform(-0.15, 0.15, size=2)]),
        "freqs": rng.uniform(1.0, assumed["texture_max_freq"], size=(3, N_WAVES, 2))
        * rng.choice([-1.0, 1.0], size=(3, N_WAVES, 2)),
        "phases": rng.uniform(0.0, 2 * math.pi, size=(3, N_WAVES)),
        "sparse_seed": int(rng.integers(2**62)),
    }


def _plane_hits(c2w, K, plane, xs, ys, device):
    """World points and camera depths where the pixels' rays meet the plane
    z = z0 + a x + b y (all float64 on the device)."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)  # noqa: E731
    R, c, K = t(c2w[:3, :3]), t(c2w[:3, 3]), t(K)
    dirs = torch.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1], torch.ones_like(xs)], -1)
    d = dirs @ R.T
    z0, a, b = (float(v) for v in plane)
    depth = (z0 + a * c[0] + b * c[1] - c[2]) / (d[..., 2] - a * d[..., 0] - b * d[..., 1])
    return c + depth[..., None] * d, depth


def _texture(points, freqs, phases, device):
    """RGB in [0, 1] of the texture at world points (..., 3)."""
    f = torch.as_tensor(freqs, device=device)  # (3, N_WAVES, 2)
    ph = torch.as_tensor(phases, device=device)  # (3, N_WAVES)
    arg = torch.einsum("...j,cwj->...cw", points[..., :2], f) * (2 * math.pi) + ph
    return 0.5 + 0.5 * torch.sin(arg).mean(-1) * 1.6


def make_llff_scene(seed: int, assumed: dict, device) -> dict:
    """The loader's output for a train scene: {"frame_nums", "nerf_data",
    "sparse_depth_data"} as `data.llff.NerfLlffDataLoader.load_data` gives it."""
    s = scene_scalars(seed, assumed)
    h, w, n = assumed["height"], assumed["width"], assumed["train_frames"]
    f = assumed["focal"]
    K = np.array([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]])
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float64),
                            torch.arange(w, device=device, dtype=torch.float64), indexing="ij")
    rng = np.random.default_rng(s["sparse_seed"])
    images, sparse, near, far = [], {}, np.inf, 0.0
    for i in range(n):
        pts, depth = _plane_hits(s["c2ws"][i], K, s["plane"], xs, ys, device)
        rgb = _texture(pts, s["freqs"], s["phases"], device).clamp(0, 1)
        images.append((rgb * 255).round().to(torch.uint8).cpu().numpy())
        m = assumed["sparse_points_per_frame"]
        px = rng.uniform(0, w - 1, size=m)
        py = rng.uniform(0, h - 1, size=m)
        _, d = _plane_hits(s["c2ws"][i], K, s["plane"], torch.as_tensor(px, device=device),
                           torch.as_tensor(py, device=device), device)
        d = d.cpu().numpy()
        sparse[i] = {"x": px, "y": py, "depth": d, "reprojection_error": rng.uniform(0.1, 2.0, size=m)}
        dmin, dmax = float(depth.min()), float(depth.max())
        near, far = min(near, 0.9 * dmin), max(far, 1.1 * dmax)
    w2cs = np.linalg.inv(s["c2ws"])
    return {
        "frame_nums": np.arange(n, dtype=np.int64),
        "nerf_data": {
            "images": np.stack(images),
            "extrinsics": w2cs,
            "intrinsics": np.repeat(K[None], n, axis=0),
            "resolution": (h, w),
            "bounds": np.array([near, far]),
        },
        "sparse_depth_data": sparse,
    }


def spiral_poses(seed: int, raw: dict, count: int, radius_scale: float) -> np.ndarray:
    """`count` world-to-camera poses on a spiral about the train cameras'
    mean centre, at a phase drawn from the seed, looking along their mean
    view axis (the LLFF spiral videos' path)."""
    c2ws = np.linalg.inv(raw["nerf_data"]["extrinsics"])
    centre = c2ws[:, :3, 3].mean(0)
    spread = np.abs(c2ws[:, :3, 3] - centre).max() + 1e-3
    r = radius_scale * spread
    phase = np.random.default_rng([seed, 2]).uniform(0, 2 * math.pi)
    rot = c2ws[0, :3, :3]
    poses = []
    for k in range(count):
        th = phase + 2 * math.pi * k / count
        c2w = np.eye(4)
        c2w[:3, :3] = rot
        c2w[:3, 3] = centre + r * np.array([math.cos(th), math.sin(th), 0.2 * math.sin(2 * th)])
        poses.append(np.linalg.inv(c2w))
    return np.stack(poses)


def mlp_shapes(mlp: dict) -> dict:
    """Parameter shapes (fan_in, fan_out) of one MLP of the reference schema
    (`model.coarse_mlp` and the like), skip join after layer 4."""
    d, ds = mlp["points_positional_encoding_degree"], mlp.get("points_sigma_positional_encoding_degree")
    ds = d if ds is None else ds
    width, vw = mlp["points_net_width"], mlp["views_net_width"]
    p_in = 3 + 6 * ds
    extra = 6 * (d - ds)
    view_dep = mlp["view_dependent_rgb"] or mlp.get("predict_visibility", False)
    shapes = {"pts": []}
    fan_in = p_in
    for i in range(mlp["points_net_depth"]):
        shapes["pts"].append((fan_in, width))
        fan_in = width + (p_in if i == 4 else 0)
    shapes["pts_out"] = (width, 1 + (0 if mlp["view_dependent_rgb"] else 3))
    if view_dep:
        dirs = 3 + 6 * mlp["views_positional_encoding_degree"] if mlp["use_view_dirs"] else 0
        shapes["feature"] = (width, width)
        shapes["views"] = [(width + extra + dirs if i == 0 else vw, vw)
                           for i in range(mlp["views_net_depth"])]
        n_out = (3 if mlp["view_dependent_rgb"] else 0) + (1 if mlp.get("predict_visibility") else 0)
        shapes["views_out"] = (vw, n_out)
    return shapes


def model_mlps(train_configs: dict) -> dict:
    """{param tree key: MLP dict} of every MLP the configuration has."""
    model = train_configs["model"]
    out = {"coarse": model["coarse_mlp"], "fine": model["fine_mlp"]}
    for aug, prefix in (("points_augmentation", "points_aug_"), ("views_augmentation", "views_aug_")):
        for level, mlp in model.get(aug, {}).items():
            out[prefix + level.replace("_mlp", "")] = mlp
    return out


def _layer_list(shapes: dict) -> list:
    """[(path, (fan_in, fan_out))] of every dense layer, in a fixed order."""
    out = []
    for key in ("pts", "pts_out", "feature", "views", "views_out"):
        if key not in shapes:
            continue
        if isinstance(shapes[key], list):
            out += [((key, i), s) for i, s in enumerate(shapes[key])]
        else:
            out.append(((key,), shapes[key]))
    return out


def make_weights(seed: int, train_configs: dict, device, sigma_bias: float = 0.0) -> dict:
    """Every MLP's parameters from one uniform draw on the device: a tree
    {mlp: {"pts": [{"w", "b"}, ...], "pts_out": {...}, ...}} of float32
    tensors. `sigma_bias` is added to each sigma head's bias."""
    layers = []
    for name, mlp in sorted(model_mlps(train_configs).items()):
        layers += [(name, path, s) for path, s in _layer_list(mlp_shapes(mlp))]
    total = sum(fi * fo + fo for _, _, (fi, fo) in layers)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32) * 2 - 1
    tree: dict = {}
    pos = 0
    for name, path, (fi, fo) in layers:
        bound = 1.0 / math.sqrt(fi)
        w = u[pos : pos + fi * fo].view(fi, fo) * bound
        b = u[pos + fi * fo : pos + fi * fo + fo] * bound
        pos += fi * fo + fo
        if path == ("pts_out",) and sigma_bias:
            b = b.clone()
            b[0] += sigma_bias
        node = tree.setdefault(name, {})
        if len(path) == 2:
            node.setdefault(path[0], []).append({"w": w, "b": b})
        else:
            node[path[0]] = {"w": w, "b": b}
    return tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_items(tree, prefix=""):
    """[(path string, leaf)] in sorted-key order."""
    if isinstance(tree, dict):
        return [it for k in sorted(tree) for it in tree_items(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [it for i, v in enumerate(tree) for it in tree_items(v, f"{prefix}/{i}")]
    return [(prefix, tree)]
