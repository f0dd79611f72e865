"""Render-path pose creators (offline dataset tooling).

Port of simplenerf_tpu/dataset_tools/video_poses.py. LLFF spiral: the
classic NeRF spiral around the average camera, made in the normalized
training frame and mapped back to the storage convention (OpenCV w2c
CSVs) so the tester reads them unchanged (focus-depth heuristic,
90th-percentile radii, zrate 0.5). RealEstate10K: the clip's original
camera path, optionally upsampled. The CSV is written as pandas writes
it, without pandas.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from simplenerf_torch.geometry import poses as pose_lib

# Homogeneous convention-flip conjugator: C(X) = F X F.
_FLIP4 = np.diag([1.0, -1.0, -1.0, 1.0])


def poses_avg_c2w(c2w_poses: np.ndarray) -> np.ndarray:
    center = c2w_poses[:, :3, 3].mean(0)
    forward = pose_lib.normalize(c2w_poses[:, :3, 2].sum(0))
    up = c2w_poses[:, :3, 1].sum(0)
    return pose_lib.view_matrix(forward, up, center)


def render_path_spiral(
    c2w: np.ndarray, up: np.ndarray, rads: np.ndarray, focal: float,
    zrate: float, rots: int, n: int,
) -> np.ndarray:
    """Spiral of c2w poses looking at a fixed focus point."""
    poses = []
    rads4 = np.array([*rads, 1.0])
    focus = c2w[:3, :4] @ np.array([0, 0, -focal, 1.0])
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, n + 1)[:-1]:
        c = c2w[:3, :4] @ (np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]) * rads4)
        z = pose_lib.normalize(c - focus)
        poses.append(pose_lib.view_matrix(z, up, c))
    return np.stack(poses)


def create_spiral_video_poses(
    extrinsics: np.ndarray,
    bounds: np.ndarray,
    bd_factor: float = 0.75,
    num_frames: int = 120,
    num_rotations: int = 2,
) -> np.ndarray:
    """Spiral path as storage-convention w2c 4x4 poses, centre pose first.

    extrinsics: (n, 4, 4) OpenCV w2c; bounds: (near, far) scene depth bounds.
    """
    pp = pose_lib.preprocess_poses(
        extrinsics, bounds=np.asarray(bounds, float).copy(), bd_factor=bd_factor, train_mode=True
    )
    norm_poses = pp["poses"].astype(np.float64)  # c2w in the normalized frame
    sc, avg = pp["sc"], pp["average_pose"]
    bds = pp["bounds"]

    c2w_avg = poses_avg_c2w(norm_poses)
    up = pose_lib.normalize(norm_poses[:, :3, 1].sum(0))

    close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    rads = np.percentile(np.abs(norm_poses[:, :3, 3]), 90, axis=0)

    spiral_c2w = render_path_spiral(c2w_avg, up, rads, focal, zrate=0.5, rots=num_rotations, n=num_frames)

    # Undo the normalization: P_norm = F (avg @ inv(w2c)) F  =>
    # w2c = F inv(P) F @ avg, then unscale the translation.
    video_w2c = np.stack([_FLIP4 @ np.linalg.inv(p) @ _FLIP4 @ avg for p in spiral_c2w])
    video_w2c[:, :3, 3] /= sc

    center = poses_avg_c2w(video_w2c)
    return np.concatenate([center[None], video_w2c], axis=0).astype(np.float32)


def create_original_path_poses(extrinsics: np.ndarray, num_frames: int = 0) -> np.ndarray:
    """RE10K-style path: the clip's own poses, linearly upsampled if asked."""
    extrinsics = np.asarray(extrinsics, float)
    if num_frames <= len(extrinsics):
        return extrinsics.astype(np.float32)
    # Piecewise-linear interpolation on translations, nearest on rotations.
    t_in = np.linspace(0, 1, len(extrinsics))
    t_out = np.linspace(0, 1, num_frames)
    out = []
    for t in t_out:
        i = min(int(np.searchsorted(t_in, t)), len(extrinsics) - 1)
        out.append(extrinsics[i])
    return np.stack(out).astype(np.float32)


def save_video_poses(database_dirpath: Path, scene_name: str, poses: np.ndarray,
                     dirname: str = "video_poses01") -> Path:
    """Write the flattened 16-values-per-row CSV that
    `runner.start_testing_videos` reads, all/database_data/<scene>/<dirname>/VideoPoses.csv."""
    out = Path(database_dirpath) / f"all/database_data/{scene_name}/{dirname}"
    out.mkdir(parents=True, exist_ok=True)
    path = out / "VideoPoses.csv"
    # Each value's shortest repr in its own dtype, as pandas writes it.
    rows = np.asarray(poses).reshape(len(poses), 16)
    path.write_text("".join(",".join(str(v) for v in row) + "\n" for row in rows))
    return path
