"""COLMAP sparse-depth prior generation (offline, CPU, subprocess).

Port of simplenerf_tpu/priors/colmap.py, with tables as {column: array}
dicts and CSVs written by the port's csv helper (no pandas).

Triangulates keypoints with KNOWN camera poses and emits per-frame
(x, y, depth, reprojection_error, weight) tables plus percentile depth
bounds: the DS-NeRF-style prior SimpleNeRF trains against. The pipeline
follows the reference's ColmapTester: write images and a known-pose COLMAP
text model -> colmap feature_extractor -> patch the camera in the sqlite
database -> exhaustive_matcher -> point_triangulator (two-view tracks
allowed, min tri angle 4) -> model_converter to TXT -> read back the 3-D
points, keep each frame's z-depths within its 0.5/99.5 percentile bounds,
confidence weight 2*exp(-(err/mean_err)^2).

Without the `colmap` binary on PATH, `run_colmap` raises; the parsing and
the depth math run without it.
"""

from __future__ import annotations

import shutil
import sqlite3
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
from scipy.spatial.transform import Rotation

from simplenerf_torch.data import io

_COLUMNS = ("x", "y", "depth", "reprojection_error", "weight")


def colmap_available() -> bool:
    return shutil.which("colmap") is not None


def quaternion_wxyz(rotation_matrix: np.ndarray) -> np.ndarray:
    q = Rotation.from_matrix(rotation_matrix).as_quat()  # xyzw
    return np.roll(q, 1)  # wxyz, COLMAP order


# ----------------------------------------------------------- text model IO


def read_points3d_txt(path: Path) -> dict:
    """{point_id: (xyz, error, image_ids)} from a COLMAP points3D.txt."""
    points = {}
    for line in Path(path).read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        track = parts[8:]
        points[int(parts[0])] = (np.array(parts[1:4], float), float(parts[7]),
                                 np.array(track[0::2], int))
    return points


def read_images_txt(path: Path) -> dict:
    """{image_id: (name, w2c(4x4), xys(n,2), point3d_ids(n,))}."""
    images = {}
    lines = [l for l in Path(path).read_text().splitlines() if l and not l.startswith("#")]
    for header, data in zip(lines[0::2], lines[1::2]):
        parts = header.split()
        qw, qx, qy, qz = map(float, parts[1:5])
        w2c = np.eye(4)
        w2c[:3, :3] = Rotation.from_quat([qx, qy, qz, qw]).as_matrix()
        w2c[:3, 3] = np.array(parts[5:8], float)
        d = data.split()
        xys = np.array(d, float).reshape(-1, 3)[:, :2] if d else np.zeros((0, 2))
        ids = np.array(d[2::3], int) if d else np.zeros((0,), int)
        images[int(parts[0])] = (parts[9], w2c, xys, ids)
    return images


# ----------------------------------------------------------- depth math


def depths_and_weights(points: dict, images: dict):
    """Per-image keypoint z-depths with DS-NeRF confidence weights.

    Returns ({image_id: {x, y, depth, reprojection_error, weight} arrays},
    {near, far} arrays in image-id order), with each image's 0.5/99.5
    percentile z bounds (reference get_bounds, compute_colmap_depth), or
    (None, None) when there are no points or an image sees none.
    """
    if not points:
        return None, None
    err_mean = np.array([p[1] for p in points.values()]).mean()

    per_image_z: dict = {i: [] for i in images}
    for xyz, _, image_ids in points.values():
        for iid in np.unique(image_ids):
            if iid in images:
                c2w = np.linalg.inv(images[iid][1])
                per_image_z[iid].append(float(c2w[:3, 2] @ (xyz - c2w[:3, 3])))
    bounds = {}
    for iid, zs in per_image_z.items():
        if not zs:
            return None, None
        bounds[iid] = (np.percentile(zs, 0.5), np.percentile(zs, 99.5))

    frames = {}
    for iid, (_, w2c, xys, ids) in sorted(images.items()):
        c2w = np.linalg.inv(w2c)
        rows = []
        for (x, y), pid in zip(xys, ids):
            if pid == -1 or pid not in points:
                continue
            xyz, err, _ = points[pid]
            depth = float(c2w[:3, 2] @ (xyz - c2w[:3, 3]))
            if depth < bounds[iid][0] or depth > bounds[iid][1]:
                continue
            rows.append([x, y, depth, err, 2 * np.exp(-((err / err_mean) ** 2))])
        table = np.asarray(rows, np.float64).reshape(-1, len(_COLUMNS))
        frames[iid] = {c: table[:, j] for j, c in enumerate(_COLUMNS)}
    near_far = np.array([bounds[i] for i in sorted(images)], np.float64)
    return frames, {"near": near_far[:, 0], "far": near_far[:, 1]}


# ----------------------------------------------------------- the estimator


class ColmapSparseDepthEstimator:
    def __init__(self, workspace: Path):
        self.workspace = Path(workspace)
        self.images_dirpath = self.workspace / "images"
        self.sparse_dirpath = self.workspace / "sparse"
        self.db_path = self.workspace / "database.db"

    # -- workspace -----------------------------------------------------
    def prepare_workspace(self, images: np.ndarray, intrinsics: np.ndarray) -> None:
        """Write the images, cameras.txt (one shared FULL_OPENCV camera) and
        an empty points3D.txt."""
        for intrinsic in intrinsics:
            if not np.allclose(intrinsic, intrinsics[0]):
                raise ValueError("per-frame intrinsics are not supported")
        if self.workspace.exists():
            shutil.rmtree(self.workspace)
        self.images_dirpath.mkdir(parents=True)
        self.sparse_dirpath.mkdir(parents=True)
        for i, image in enumerate(images):
            io.write_image(self.images_dirpath / f"{i:04}.png", image)

        k = intrinsics[0]
        h, w = images[0].shape[:2]
        cam = f"1 FULL_OPENCV {w} {h} {k[0,0]} {k[1,1]} {k[0,2]} {k[1,2]} 0 0 0 0 0 0 0 0 \n"
        (self.sparse_dirpath / "cameras.txt").write_text(cam)
        (self.sparse_dirpath / "points3D.txt").write_text("")

    def write_known_poses(self, extrinsics: np.ndarray, image_id_by_name: dict) -> None:
        """images.txt rows binding each database image to its known w2c pose."""
        lines = []
        for frame_num, w2c in enumerate(extrinsics):
            q_str = " ".join(map(str, quaternion_wxyz(w2c[:3, :3])))
            t_str = " ".join(map(str, w2c[:3, 3]))
            name = f"{frame_num:04}.png"
            lines.append(f"{image_id_by_name[name]} {q_str} {t_str} 1 {name}\n\n")
        (self.sparse_dirpath / "images.txt").write_text("".join(lines))

    def _patch_camera_params(self, intrinsic: np.ndarray) -> dict:
        """Set the database camera to PINHOLE(fx, fy, cx, cy); {name: image id}."""
        db = sqlite3.connect(self.db_path.as_posix())
        params = np.asarray(
            [intrinsic[0, 0], intrinsic[1, 1], intrinsic[0, 2], intrinsic[1, 2]], np.float64
        )
        db.execute("UPDATE cameras SET model=6, params=? WHERE camera_id=1", (params.tobytes(),))
        ids = {name: iid for iid, name in db.execute("SELECT image_id, name FROM images")}
        db.commit()
        db.close()
        return ids

    def _run(self, args: list[str]) -> None:
        result = subprocess.run(args, capture_output=True, text=True)
        if result.returncode != 0:
            raise RuntimeError(f"{' '.join(args)} failed:\n{result.stderr[-2000:]}")

    def run_colmap(self, extrinsics: np.ndarray, intrinsic: np.ndarray) -> None:
        if not colmap_available():
            raise RuntimeError(
                "colmap binary not found on PATH; install COLMAP to generate "
                "sparse-depth priors (see simplenerf_torch/priors/colmap.py)"
            )
        db, images, sparse = (p.as_posix() for p in (self.db_path, self.images_dirpath,
                                                     self.sparse_dirpath))
        self._run(["colmap", "feature_extractor", "--database_path", db,
                   "--image_path", images, "--ImageReader.single_camera", "1"])
        self.write_known_poses(extrinsics, self._patch_camera_params(intrinsic))
        self._run(["colmap", "exhaustive_matcher", "--database_path", db])
        self._run(["colmap", "point_triangulator", "--database_path", db, "--image_path", images,
                   "--input_path", sparse, "--output_path", sparse,
                   "--Mapper.tri_ignore_two_view_tracks", "0", "--Mapper.num_threads", "16",
                   "--Mapper.init_min_tri_angle", "4", "--Mapper.multiple_models", "0",
                   "--Mapper.extract_colors", "0"])
        self._run(["colmap", "model_converter", "--input_path", sparse, "--output_path", sparse,
                   "--output_type", "TXT"])

    def estimate_sparse_depth(self, images: np.ndarray, extrinsics: np.ndarray,
                              intrinsics: np.ndarray):
        """The whole pipeline: ([per-image table in image-id order], bounds
        table), or (None, None) when triangulation gives no usable points."""
        self.prepare_workspace(images, intrinsics)
        self.run_colmap(extrinsics, intrinsics[0])
        points = read_points3d_txt(self.sparse_dirpath / "points3D.txt")
        model_images = read_images_txt(self.sparse_dirpath / "images.txt")
        frames, bounds = depths_and_weights(points, model_images)
        if frames is None:
            return None, None
        return [frames[i] for i in sorted(frames)], bounds


def generate_scene_priors(
    database_dirpath: Path,
    scene_name: str,
    frame_nums: np.ndarray,
    images: np.ndarray,
    extrinsics: np.ndarray,
    intrinsics: np.ndarray,
    output_dirname: str = "DE02",
    resolution_suffix: str = "_down4",
    workspace: Optional[Path] = None,
) -> bool:
    """Write per-frame sparse-depth CSVs + EstimatedBounds.csv for one scene
    (the reference's DepthEstimator02_NeRF_LLFF layout). Skips a scene whose
    outputs exist. Returns True on success. The COLMAP workspace defaults to
    <temp dir>/simplenerf_colmap/<scene>."""
    out_dir = (
        Path(database_dirpath)
        / f"all/estimated_depths/{output_dirname}/{scene_name}/estimated_depths{resolution_suffix}"
    )
    if all((out_dir / f"{f:04}.csv").exists() for f in frame_nums):
        return True
    workspace = Path(workspace) if workspace else Path(tempfile.gettempdir()) / "simplenerf_colmap" / scene_name
    frames, bounds = ColmapSparseDepthEstimator(workspace).estimate_sparse_depth(
        images, extrinsics, intrinsics)
    if frames is None:
        return False
    out_dir.mkdir(parents=True, exist_ok=True)
    for frame_num, table in zip(frame_nums, frames):
        io.write_csv(out_dir / f"{frame_num:04}.csv", table)
    io.write_csv(out_dir.parent / "EstimatedBounds.csv", bounds)
    return True
