"""Synthetic scene generator in the NeRF-LLFF on-disk layout.

Renders a cluster of Gaussian-density color blobs with an analytic numpy
volume renderer, giving images AND ground-truth depth from known cameras.
Written in the same directory contract the LLFF loader reads, it powers the
end-to-end tests, the benchmark, and QA fixtures without any downloaded
dataset (the reference repo ships no images either).

Cameras follow the storage convention: OpenCV (x down-y forward-z)
world-to-camera extrinsics (reference src/database_utils/README.md:69-76);
the blob cluster sits at positive world z so all cameras are forward-facing
(NDC-compatible after the preprocessor's convention flip).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from simplenerf_torch.data import io


def _blob_field(rng: np.random.Generator, num_blobs: int = 6, textured: bool = False):
    centers = np.stack(
        [
            rng.uniform(-1.2, 1.2, num_blobs),
            rng.uniform(-1.2, 1.2, num_blobs),
            rng.uniform(3.0, 5.0, num_blobs),
        ],
        axis=1,
    )
    scales = rng.uniform(0.25, 0.55, num_blobs)
    density = rng.uniform(8.0, 20.0, num_blobs)
    colors = rng.uniform(0.15, 0.95, (num_blobs, 3))
    tex = bg_tex = None
    if textured:
        # Harder (denser) blobs: a soft gaussian integrates — i.e. low-pass
        # filters — 3-D albedo along the ray; sharp surfaces keep it.
        density = rng.uniform(45.0, 110.0, num_blobs)
        # Two-band 3-D sinusoidal albedo per blob (world-anchored, hence
        # view-consistent): a coarse band (~1-unit period) and a fine band
        # (~0.25-unit period ≈ 10-15 px at the default focal/depth), so 5x5
        # image patches carry real texture and the reliable-consistency
        # patch arbitration (losses/consistency.py) is informative — the
        # regime SimpleNeRF's losses are designed for.
        tex = (
            rng.uniform(4.0, 7.0, (num_blobs, 3)) * rng.choice([-1.0, 1.0], (num_blobs, 3)),
            rng.uniform(0, 2 * np.pi, num_blobs),
            rng.uniform(18.0, 30.0, (num_blobs, 3)) * rng.choice([-1.0, 1.0], (num_blobs, 3)),
            rng.uniform(0, 2 * np.pi, num_blobs),
        )
        # Textured background PLANE at fixed world z (geometrically
        # consistent, unlike the plain mode's screen-space gradient).
        bg_tex = (
            rng.uniform(2.0, 5.0, (3, 2)) * rng.choice([-1.0, 1.0], (3, 2)),
            rng.uniform(0, 2 * np.pi, 3),
            rng.uniform(12.0, 22.0, (3, 2)) * rng.choice([-1.0, 1.0], (3, 2)),
            rng.uniform(0, 2 * np.pi, 3),
        )
    return centers, scales, density, colors, tex, bg_tex


def render_analytic(
    h: int,
    w: int,
    intrinsic: np.ndarray,
    w2c: np.ndarray,
    field,
    near: float = 1.5,
    far: float = 7.0,
    num_samples: int = 128,
):
    """Analytic volume render (numpy, OpenCV convention). Returns rgb, z-depth."""
    centers, scales, density, colors, tex, bg_tex = field
    x, y = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    pix = np.stack([x, y, np.ones_like(x)], -1)
    dirs_cam = pix @ np.linalg.inv(intrinsic).T  # z forward = +1
    c2w = np.linalg.inv(w2c)
    dirs_w = dirs_cam @ c2w[:3, :3].T
    origin = c2w[:3, 3]

    t = np.linspace(near, far, num_samples)
    pts = origin[None, None, None] + dirs_w[:, :, None, :] * t[None, None, :, None]
    sigma = np.zeros((h, w, num_samples))
    rgb = np.zeros((h, w, num_samples, 3))
    wsum = np.zeros((h, w, num_samples))
    for c, s, d, col in zip(centers, scales, density, colors):
        g = d * np.exp(-np.sum((pts - c) ** 2, -1) / (2 * s * s))
        sigma += g
        rgb += g[..., None] * col
        wsum += g
    rgb = rgb / np.maximum(wsum[..., None], 1e-8)

    dt = (far - near) / (num_samples - 1)
    alpha = 1.0 - np.exp(-sigma * dt)
    trans = np.cumprod(1.0 - alpha + 1e-10, axis=-1)
    trans = np.concatenate([np.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    weights = alpha * trans
    image = np.sum(weights[..., None] * rgb, axis=-2)
    acc = np.sum(weights, axis=-1)
    depth = np.sum(weights * t, axis=-1) / np.maximum(acc, 1e-6)
    if tex is not None:
        # World-anchored surface albedo: modulate the composited foreground
        # by a two-band sinusoidal texture evaluated at the per-ray surface
        # hit point. View-consistent (pure function of world position) yet
        # crisp — per-SAMPLE modulation washes out under the volume
        # integral, which is exactly the low-pass behavior the arbitration
        # losses must see through, not the texture we want to give them.
        k1, p1, k2, p2 = tex
        hit = origin[None, None] + dirs_w * depth[..., None]
        mod = 0.55 + 0.225 * np.sin(hit @ k1[0] + p1[0]) + 0.225 * np.sin(hit @ k2[0] + p2[0])
        image = image * mod[..., None]
    if bg_tex is None:
        # background: soft grey gradient, far depth
        bg = 0.35 + 0.25 * (y / h)[..., None] * np.ones(3)
        bg_depth = far
    else:
        # Textured plane at world z just inside `far`: the ray hits it at
        # parametric t_bg (== camera z-depth since dirs_cam_z = 1), and its
        # two-band sinusoidal albedo is a function of the world hit point —
        # fully view-consistent high-frequency background.
        z_bg = far - 0.5
        t_bg = (z_bg - origin[2]) / np.maximum(dirs_w[..., 2], 1e-6)
        hit = origin[None, None] + dirs_w * t_bg[..., None]
        kb1, pb1, kb2, pb2 = bg_tex
        chans = [
            0.45
            + 0.2 * np.sin(hit[..., 0] * kb1[i, 0] + hit[..., 1] * kb1[i, 1] + pb1[i])
            + 0.15 * np.sin(hit[..., 0] * kb2[i, 0] + hit[..., 1] * kb2[i, 1] + pb2[i])
            for i in range(3)
        ]
        bg = np.clip(np.stack(chans, axis=-1), 0, 1)
        bg_depth = t_bg
    image = image + (1 - acc[..., None]) * bg
    depth = acc * depth + (1 - acc) * bg_depth
    return np.clip(image, 0, 1), depth


def _colmap_like_sparse(rng, image, depth, focal, baseline, n_points,
                        px_sigma, outlier_frac):
    """Sparse depth with real-COLMAP statistics instead of a GT oracle.

    The reference's prior generator triangulates SIFT matches with known
    poses (src/prior_generators/sparse_depth/Tester01.py:232-289); its
    output is (a) concentrated on textured corners, (b) noisy with the
    triangulation law sigma_z ~ err_px * z^2 / (f * baseline), (c) polluted
    by a few wrong matches, (d) confidence-weighted
    2*exp(-(err/mean_err)^2) (:265). This models exactly those statistics:
      - keypoints drawn with probability ∝ local gradient energy,
      - reprojection errors half-normal with scale px_sigma,
      - depth noise sigma_z = err * z^2 / (f * baseline),
      - outlier_frac of points re-drawn uniformly in the frame's depth
        range (mismatches triangulate to unrelated depths).
    """
    h, w = depth.shape
    gray = image.mean(-1)
    gy, gx = np.gradient(gray)
    resp = (gx * gx + gy * gy).ravel() + 1e-12
    flat = rng.choice(h * w, size=min(n_points, h * w), replace=False,
                      p=resp / resp.sum())
    ys, xs = np.divmod(flat, w)
    d = depth[ys, xs]
    err = np.abs(rng.standard_normal(len(d))) * px_sigma
    d_noisy = d + rng.standard_normal(len(d)) * err * d * d / (focal * baseline)
    outliers = rng.random(len(d)) < outlier_frac
    d_noisy[outliers] = rng.uniform(depth.min(), depth.max(), outliers.sum())
    # Guard the mean: px_sigma=0 makes every err 0 and the reference's
    # confidence formula 2*exp(-(err/mean_err)^2) would be 0/0 -> NaN.
    weight = 2 * np.exp(-((err / (np.mean(err) + 1e-12)) ** 2))
    return xs, ys, d_noisy, err, weight


def generate_scene(
    root: Path,
    scene_name: str = "blobs",
    num_frames: int = 6,
    h: int = 48,
    w: int = 64,
    set_num: int = 2,
    num_train: int = 3,
    resolution_suffix: str = "_down4",
    seed: int = 7,
    sparse_points_per_frame: int = 96,
    textured: bool = False,
    sparse_depth_noise: float = 0.01,
    sparse_mode: str = "uniform",
    sparse_px_sigma: float = 1.0,
    sparse_outlier_frac: float = 0.05,
) -> dict:
    """Write a full synthetic scene; returns ground-truth arrays for tests.

    `textured=True` produces the few-shot evaluation regime SimpleNeRF
    targets: world-anchored high-frequency albedo on the blobs plus a
    textured background plane, so image patches disambiguate depth and the
    reliable-consistency arbitration has signal to work with.
    """
    rng = np.random.default_rng(seed)
    root = Path(root)
    scene_dir = root / f"all/database_data/{scene_name}"
    (scene_dir / f"rgb{resolution_suffix}").mkdir(parents=True, exist_ok=True)

    field = _blob_field(rng, textured=textured)
    focal = 0.9 * w
    intrinsic = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1.0]])

    images, depths, extrinsics = [], [], []
    for i in range(num_frames):
        # Cameras fan out on a small grid, looking roughly at the cluster.
        t = np.array(
            [0.45 * (i - (num_frames - 1) / 2) / max(num_frames - 1, 1) * 2,
             0.25 * rng.uniform(-1, 1),
             0.15 * rng.uniform(-1, 1)]
        )
        yaw = 0.06 * (i - (num_frames - 1) / 2)
        cy, sy = np.cos(yaw), np.sin(yaw)
        rot = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        w2c = np.eye(4)
        w2c[:3, :3] = rot
        w2c[:3, 3] = -rot @ t
        extrinsics.append(w2c)
        image, depth = render_analytic(h, w, intrinsic, w2c, field)
        images.append(image)
        depths.append(depth)

    images = np.stack(images)
    depths = np.stack(depths)
    extrinsics = np.stack(extrinsics)

    for i in range(num_frames):
        io.write_image(
            scene_dir / f"rgb{resolution_suffix}/{i:04}.png",
            np.round(images[i] * 255).astype(np.uint8),
        )
    np.savetxt(
        scene_dir / "DepthBounds.csv",
        np.stack([depths.reshape(num_frames, -1).min(1) * 0.9,
                  depths.reshape(num_frames, -1).max(1) * 1.1], 1),
        delimiter=",",
    )
    np.savetxt(scene_dir / "CameraExtrinsics.csv", extrinsics.reshape(num_frames, 16), delimiter=",")
    np.savetxt(
        scene_dir / f"CameraIntrinsics{resolution_suffix}.csv",
        np.tile(intrinsic.reshape(1, 9), (num_frames, 1)),
        delimiter=",",
    )

    # Train/val/test split CSVs.
    frame_ids = np.arange(num_frames)
    train_frames = np.linspace(0, num_frames - 1, num_train).round().astype(int)
    rest = [f for f in frame_ids if f not in train_frames]
    val_frames = rest[:1]
    test_frames = rest
    sets_dir = root / f"train_test_sets/set{set_num:02}"
    sets_dir.mkdir(parents=True, exist_ok=True)
    for name, frames in (
        ("TrainVideosData", train_frames),
        ("ValidationVideosData", val_frames),
        ("TestVideosData", test_frames),
    ):
        # Split CSVs accumulate across scenes (multi-scene databases, like
        # the reference's 8-scene LLFF set CSVs); regenerating a scene
        # replaces its rows.
        csv_path = sets_dir / f"{name}.csv"
        scenes, nums = [], []
        if csv_path.exists():
            old = io.read_csv(csv_path)
            keep = [i for i, s in enumerate(old["scene_name"]) if s != str(scene_name)]
            scenes = [old["scene_name"][i] for i in keep]
            nums = [old["pred_frame_num"][i] for i in keep]
        io.write_csv(csv_path, {
            "scene_name": scenes + [scene_name] * len(frames),
            "pred_frame_num": nums + [int(f) for f in frames],
        })

    # COLMAP-style sparse depth CSVs. sparse_mode:
    #   "uniform" — GT-oracle prior (uniform pixels, relative depth noise);
    #               the strong-anchor regime of studies 1-5.
    #   "colmap"  — COLMAP-realistic statistics (texture-seeded keypoints,
    #               triangulation noise ~ z^2/(f*baseline), outliers); the
    #               regime the method was actually designed for.
    sd_dir = root / f"all/estimated_depths/DE02/{scene_name}/estimated_depths{resolution_suffix}"
    sd_dir.mkdir(parents=True, exist_ok=True)
    # Effective stereo baseline = mean distance between train camera centers.
    centers = np.stack(
        [-extrinsics[i, :3, :3].T @ extrinsics[i, :3, 3] for i in train_frames]
    )
    baseline = float(np.mean(np.linalg.norm(np.diff(centers, axis=0), axis=-1))) \
        if len(centers) > 1 else 0.2
    for i in train_frames:
        if sparse_mode == "colmap":
            xs, ys, d, err, weight = _colmap_like_sparse(
                rng, images[i], depths[i], focal, baseline,
                sparse_points_per_frame, sparse_px_sigma, sparse_outlier_frac,
            )
        else:
            xs = rng.integers(0, w, sparse_points_per_frame)
            ys = rng.integers(0, h, sparse_points_per_frame)
            d = depths[i, ys, xs] * (1 + sparse_depth_noise * rng.standard_normal(sparse_points_per_frame))
            err = np.abs(rng.standard_normal(sparse_points_per_frame)) * 0.5
            weight = 2 * np.exp(-((err / np.mean(err)) ** 2))
        io.write_csv(
            sd_dir / f"{i:04}.csv",
            {"x": xs, "y": ys, "depth": d, "reprojection_error": err, "weight": weight},
        )

    return {
        "images": images,
        "depths": depths,
        "extrinsics": extrinsics,
        "intrinsic": intrinsic,
        "train_frames": train_frames,
        "val_frames": np.array(val_frames),
        "test_frames": np.array(test_frames),
        "field": field,
    }


def generate_realestate_scene(
    root: Path,
    scene_num: int = 0,
    num_frames: int = 50,
    h: int = 48,
    w: int = 64,
    set_num: int = 2,
    num_train: int = 3,
    num_extrapolation_frames: int = 5,
    seed: int = 7,
    sparse_points_per_frame: int = 96,
    textured: bool = False,
    sparse_mode: str = "uniform",
    sparse_depth_noise: float = 0.01,
    sparse_px_sigma: float = 1.0,
    sparse_outlier_frac: float = 0.05,
    max_test_frames: int | None = None,
) -> dict:
    """Write a synthetic scene in the RealEstate10K on-disk layout.

    Layout (reference RealEstateDataLoader01 and the RealEstate QA
    scripts): scenes are 5-digit numbers under test/database_data/, images
    under rgb/ with no resolution suffix, 50-frame video clips, fixed depth
    bounds [1, 100], sparse depth under
    test/estimated_depths/<dirname>/<scene>/estimated_depths/. The
    train/test split follows the reference's sparse recipe
    (TrainTestCreator01): train = sorted prefix of [10, 20, 30, 0, 40],
    test = the interior frames plus ±num_extrapolation_frames beyond the
    ends, validation = every len(test)//len(train)-th test frame.

    The camera is a video-style forward dolly (RE10K clips are walkthrough
    videos); the geometry is the LLFF generator's analytic blob field.
    `max_test_frames` thins only the test CSV; images and cameras of every
    frame are still written.
    """
    rng = np.random.default_rng(seed)
    root = Path(root)
    scene_key = f"{scene_num:05}"
    scene_dir = root / f"test/database_data/{scene_key}"
    (scene_dir / "rgb").mkdir(parents=True, exist_ok=True)

    field = _blob_field(rng, textured=textured)
    focal = 0.9 * w
    intrinsic = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1.0]])

    images, depths, extrinsics = [], [], []
    for i in range(num_frames):
        # Gentle dolly: slide sideways and slightly forward with a slow yaw,
        # like a real-estate walkthrough clip.
        s = (i - (num_frames - 1) / 2) / max(num_frames - 1, 1)
        t = np.array([0.9 * s, 0.12 * np.sin(2 * np.pi * s), 0.3 * s])
        yaw = 0.12 * s
        cy, sy = np.cos(yaw), np.sin(yaw)
        rot = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        w2c = np.eye(4)
        w2c[:3, :3] = rot
        w2c[:3, 3] = -rot @ t
        extrinsics.append(w2c)
        image, depth = render_analytic(h, w, intrinsic, w2c, field)
        images.append(image)
        depths.append(depth)

    images = np.stack(images)
    depths = np.stack(depths)
    extrinsics = np.stack(extrinsics)

    for i in range(num_frames):
        io.write_image(scene_dir / f"rgb/{i:04}.png", np.round(images[i] * 255).astype(np.uint8))
    np.savetxt(scene_dir / "CameraExtrinsics.csv", extrinsics.reshape(num_frames, 16), delimiter=",")
    np.savetxt(
        scene_dir / "CameraIntrinsics.csv",
        np.tile(intrinsic.reshape(1, 9), (num_frames, 1)),
        delimiter=",",
    )

    # Reference sparse split, scaled only by num_frames when a fixture uses
    # fewer than the real 50.
    base = [10, 20, 30, 0, 40]
    if num_frames != 50:
        base = [round(f * (num_frames - 1) / 49) for f in base]
    train_frames = sorted(base[:num_train])
    lo, hi = min(train_frames), max(train_frames)
    test_frames = [
        f for f in range(num_frames)
        if f not in train_frames
        and ((lo < f < hi) or (abs(lo - f) <= num_extrapolation_frames)
             or (abs(f - hi) <= num_extrapolation_frames))
    ]
    val_frames = test_frames[:: max(len(test_frames) // max(len(train_frames), 1), 1)]
    test_csv_frames = test_frames
    if max_test_frames is not None and len(test_frames) > max_test_frames:
        test_csv_frames = test_frames[:: -(-len(test_frames) // max_test_frames)][:max_test_frames]

    sets_dir = root / f"train_test_sets/set{set_num:02}"
    sets_dir.mkdir(parents=True, exist_ok=True)
    for name, frames in (
        ("TrainVideosData", train_frames),
        ("ValidationVideosData", val_frames),
        ("TestVideosData", test_csv_frames),
    ):
        # Rows of other scenes stay; regenerating a scene replaces its rows.
        csv_path = sets_dir / f"{name}.csv"
        scenes, nums = [], []
        if csv_path.exists():
            old = io.read_csv(csv_path)
            keep = [i for i, s in enumerate(old["scene_num"]) if int(s) != scene_num]
            scenes = [old["scene_num"][i] for i in keep]
            nums = [old["pred_frame_num"][i] for i in keep]
        io.write_csv(csv_path, {
            "scene_num": scenes + [scene_num] * len(frames),
            "pred_frame_num": nums + [int(f) for f in frames],
        })

    # Sparse depth CSVs (no resolution suffix in this database).
    sd_dir = root / f"test/estimated_depths/DE02/{scene_key}/estimated_depths"
    sd_dir.mkdir(parents=True, exist_ok=True)
    centers = np.stack(
        [-extrinsics[i, :3, :3].T @ extrinsics[i, :3, 3] for i in train_frames]
    )
    baseline = float(np.mean(np.linalg.norm(np.diff(centers, axis=0), axis=-1))) \
        if len(centers) > 1 else 0.2
    for i in train_frames:
        if sparse_mode == "colmap":
            xs, ys, d, err, weight = _colmap_like_sparse(
                rng, images[i], depths[i], focal, baseline,
                sparse_points_per_frame, sparse_px_sigma, sparse_outlier_frac,
            )
        else:
            xs = rng.integers(0, w, sparse_points_per_frame)
            ys = rng.integers(0, h, sparse_points_per_frame)
            d = depths[i, ys, xs] * (1 + sparse_depth_noise * rng.standard_normal(sparse_points_per_frame))
            err = np.abs(rng.standard_normal(sparse_points_per_frame)) * 0.5
            weight = 2 * np.exp(-((err / (np.mean(err) + 1e-12)) ** 2))
        io.write_csv(sd_dir / f"{i:04}.csv",
                     {"x": xs, "y": ys, "depth": d, "reprojection_error": err, "weight": weight})

    return {
        "images": images,
        "depths": depths,
        "extrinsics": extrinsics,
        "intrinsic": intrinsic,
        "train_frames": np.array(train_frames),
        "val_frames": np.array(val_frames),
        "test_frames": np.array(test_csv_frames),
        "field": field,
    }


def write_scene_priors(
    root: Path,
    scene_name: str,
    frames,
    images: np.ndarray,
    depths: np.ndarray,
    extrinsics: np.ndarray,
    intrinsic: np.ndarray,
    dense_dirname: str = "DE_GT",
    masks_dirname: str = "VP_GT",
    resolution_suffix: str = "_down4",
) -> None:
    """Write a scene's dense-depth and visibility priors in the LLFF layout,
    from ground truth, for `frames` (the train frames):

    - all/estimated_depths/<dense_dirname>/<scene>/estimated_depths<suffix>/NNNN.npy,
      the frame's depth;
    - all/visibility_prior/<masks_dirname>/<scene>/visibility_masks/AAAA_BBBB.png
      for every ordered pair of frames: 255 where a pixel of frame A is
      visible in frame B (frame B splatted into A at its depth,
      `qa.masks.MaskComputer`), else 0.

    images (n, h, w, 3) in [0, 1] or uint8, depths (n, h, w) and extrinsics
    (n, 4, 4) are indexed by frame number; intrinsic (3, 3) is shared.
    """
    from simplenerf_torch.qa.masks import MaskComputer

    root = Path(root)
    dense = root / f"all/estimated_depths/{dense_dirname}/{scene_name}/estimated_depths{resolution_suffix}"
    masks = root / f"all/visibility_prior/{masks_dirname}/{scene_name}/visibility_masks"
    dense.mkdir(parents=True, exist_ok=True)
    masks.mkdir(parents=True, exist_ok=True)
    computer = MaskComputer()
    frames = [int(f) for f in frames]
    for f1 in frames:
        np.save(dense / f"{f1:04}.npy", np.asarray(depths[f1], np.float32))
        for f2 in frames:
            if f2 == f1:
                continue
            visible = computer.compute_mask(images[f2], depths[f2], depths[f1], extrinsics[f2],
                                            extrinsics[f1], intrinsic, intrinsic)
            io.write_image(masks / f"{f1:04}_{f2:04}.png", visible.astype(np.uint8) * 255)
