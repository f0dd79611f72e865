"""Camera pose normalization (host-side, numpy).

Scenes store OpenCV-convention (x, -y, -z) world-to-camera 4x4 extrinsics
(reference: src/database_utils/README.md:69-76). Training normalizes them by
(a) scaling translations so the near bound maps to 1/bd_factor,
(b) recentring about the average camera pose, and
(c) flipping to the NeRF (x, y, z) convention.
Reference behavior: src/data_preprocessors/DataPreprocessor01.py:937-1088.

These run once per scene on the host; plain numpy is the right tool (no
gradients, tiny matrices). Test-time reuses the stored translation scale and
average pose from the scene digest (ModelConfigs), so renders align with the
training coordinate frame.
"""

from __future__ import annotations

import numpy as np

# Sign flip taking OpenCV camera axes (x right, y down, z forward) to the
# NeRF convention (x right, y up, z backward).
_CONVENTION_FLIP = np.diag([1.0, -1.0, -1.0])


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def view_matrix(z: np.ndarray, up: np.ndarray, position: np.ndarray) -> np.ndarray:
    """Build a 4x4 camera-to-world matrix from a forward axis, up hint and origin."""
    forward = normalize(z)
    right = normalize(np.cross(up, forward))
    true_up = normalize(np.cross(forward, right))
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = forward
    c2w[:3, 3] = position
    return c2w


def average_pose(w2c_poses: np.ndarray) -> np.ndarray:
    """Mean camera pose of a set of w2c extrinsics, returned as w2c.

    Matches DataPreprocessor01.compute_average_pose (reference
    src/data_preprocessors/DataPreprocessor01.py:992-1017): average the
    camera origins, take the summed view/up axes, orthonormalize.
    """
    rot_c2w = np.transpose(w2c_poses[:, :3, :3], (0, 2, 1))
    origins = -rot_c2w @ w2c_poses[:, :3, 3:]  # camera centers in world
    center = origins.mean(axis=0)[:, 0]
    forward = normalize(rot_c2w[:, :, 2].sum(axis=0))
    up = rot_c2w[:, :, 1].sum(axis=0)
    c2w = view_matrix(forward, up, center)
    return np.linalg.inv(c2w)


def recenter_poses(w2c_poses: np.ndarray, avg_w2c: np.ndarray) -> np.ndarray:
    """Express every camera relative to the average pose.

    The reference composes avg_w2c @ inv(w2c) (DataPreprocessor01.py:978-981),
    which yields camera-to-world matrices in the recentred frame — downstream
    ray generation treats these as c2w.
    """
    return avg_w2c[None] @ np.linalg.inv(w2c_poses)


def change_coordinate_system(poses: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Conjugate rotations by `perm` and flip translations (DataPreprocessor01.py:1019-1030)."""
    rot = perm.T @ poses[:, :3, :3] @ perm
    t = poses[:, :3, 3:] * perm.diagonal()[None, :, None]
    out = poses.copy()
    out[:, :3, :3] = rot
    out[:, :3, 3:] = t
    return out


def preprocess_poses(
    poses: np.ndarray,
    *,
    bounds: np.ndarray | None = None,
    bd_factor: float | None = None,
    recenter: bool = True,
    translation_scale: float | None = None,
    avg_pose: np.ndarray | None = None,
    train_mode: bool = True,
    spherify: bool = False,
    spherify_transform: dict | None = None,
) -> dict:
    """Full pose pipeline (DataPreprocessor01.preprocess_poses, :937-976).

    Train mode computes the translation scale sc = 1/(near * bd_factor) and
    the average pose; test mode reuses the stored values so rays land in the
    same normalized frame. With `spherify`, the spherification step runs
    after the convention flip (reference :971-973); in test mode the stored
    `spherify_transform` from the training digest must be supplied so test
    poses land in the same spherified frame (the reference recomputes the
    transform from whatever pose set it is given, which is singular for a
    single test pose — storing it alongside translation_scale/average_pose
    is the same reuse pattern the rest of the pipeline already follows).

    Returns dict with 'poses' (normalized, float32), and in train mode also
    'sc', 'bounds' (scaled), 'average_pose' (+ 'spherify_transform' and
    'render_poses' when spherify).
    """
    poses = poses.astype(np.float64).copy()
    out: dict = {}
    if train_mode:
        sc = 1.0
        if bounds is not None:
            bounds = np.asarray(bounds, dtype=np.float64).copy()
            if bd_factor is not None:
                sc = 1.0 / (float(bounds[0]) * bd_factor)
            poses[:, :3, 3] *= sc
            bounds = bounds * sc
            out["bounds"] = bounds
        out["sc"] = sc
        avg = average_pose(poses) if recenter else np.eye(4)
        out["average_pose"] = avg
    else:
        assert translation_scale is not None and avg_pose is not None
        poses[:, :3, 3] *= translation_scale
        if bounds is not None:
            bounds = np.asarray(bounds, dtype=np.float64) * translation_scale
            out["bounds"] = bounds
        avg = np.asarray(avg_pose, dtype=np.float64)

    poses = recenter_poses(poses, avg)
    poses = change_coordinate_system(poses, _CONVENTION_FLIP)

    if spherify:
        if not train_mode:
            assert spherify_transform is not None, (
                "test-mode spherify needs the stored transform from ModelConfigs"
            )
        poses, render_poses, bounds, transform = spherify_poses(
            poses, bounds, transform=spherify_transform
        )
        if bounds is not None:
            out["bounds"] = bounds
        out["render_poses"] = render_poses
        out["spherify_transform"] = transform

    out["poses"] = poses.astype(np.float32)
    return out


def _to44(p: np.ndarray) -> np.ndarray:
    """(n, 3, 4) -> (n, 4, 4) with [0, 0, 0, 1] bottom rows."""
    bottom = np.tile(np.eye(4)[-1].reshape(1, 1, 4), (p.shape[0], 1, 1))
    return np.concatenate([p[:, :3, :4], bottom], axis=1)


def spherify_poses(poses: np.ndarray, bounds: np.ndarray | None, transform: dict | None = None):
    """Spherify a ring of inward-facing cameras (DataPreprocessor01.py:1032-1088).

    Recentres the world on the point minimizing distance to all camera
    z-axes, aligns the mean camera offset with +z, and rescales so the mean
    camera distance is 1; also emits a 120-pose circular render path.

    transform: optional {"c2w": (4,4), "scale": float} from a previous
    (training) call, reused verbatim so other pose sets (test/video poses)
    map into the SAME spherified frame. Returns
    (poses_reset (n,4,4), render_poses (120,4,4), bounds, transform).
    Poses are plain 4x4 here; the reference carries a vestigial LLFF hwf
    column (:1086-1087) its own ray generation never reads.
    """
    if transform is None:
        rays_d = poses[:, :3, 2:3]
        rays_o = poses[:, :3, 3:4]

        a = np.eye(3) - rays_d * np.transpose(rays_d, (0, 2, 1))
        b = -a @ rays_o
        focus = np.squeeze(
            -np.linalg.inv((np.transpose(a, (0, 2, 1)) @ a).mean(0)) @ b.mean(0)
        )

        up = (poses[:, :3, 3] - focus).mean(0)
        vec0 = normalize(up)
        vec1 = normalize(np.cross([0.1, 0.2, 0.3], vec0))
        vec2 = normalize(np.cross(vec0, vec1))
        c2w = np.stack([vec1, vec2, vec0, focus], axis=1)

        reset = np.linalg.inv(_to44(c2w[None]))[0] @ _to44(poses)
        radius = np.sqrt(np.mean(np.sum(np.square(reset[:, :3, 3]), -1)))
        sc = 1.0 / radius
        transform = {"c2w": _to44(c2w[None])[0].tolist(), "scale": float(sc)}

    inv_c2w = np.linalg.inv(np.asarray(transform["c2w"], dtype=np.float64))
    sc = float(transform["scale"])
    poses_reset = inv_c2w[None] @ _to44(poses)
    poses_reset[:, :3, 3] *= sc
    if bounds is not None:
        bounds = np.asarray(bounds, dtype=np.float64) * sc
    radius = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(max(radius**2 - zh**2, 0.0))
    render_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        cam_origin = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up = np.array([0.0, 0.0, -1.0])
        vec2 = normalize(cam_origin)
        vec0 = normalize(np.cross(vec2, up))
        vec1 = normalize(np.cross(vec2, vec0))
        render_poses.append(np.stack([vec0, vec1, vec2, cam_origin], axis=1))
    render_poses = _to44(np.stack(render_poses, 0))
    return poses_reset, render_poses, bounds, transform
