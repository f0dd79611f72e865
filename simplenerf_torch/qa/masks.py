"""Visibility masks: depth-based forward warping and splatting (numpy).

Port of simplenerf_tpu/qa/masks.py. A test-view pixel is "visible in a
train view" when forward-warping the train frame (at its depth) into the
test camera lands on it with a consistent depth:
- `forward_warp` / `bilinear_splat`: the reference Warper's bilinear
  splat, with depth weights exp(log(1+d)/max*50) so near surfaces win;
- `MaskComputer`: visible iff the splat mask is set AND
  |warped_depth - test_depth| < threshold * max(train_depth), threshold
  0.05.
The splat's scatter-accumulate runs in the native C++ op
(`simplenerf_torch.native`, built at first use; it raises without a
compiler); its numpy body (np.add.at) is the plain version, taken only
with `plain=True`, which tests hold the op against. This is offline host
tooling, run once per scene.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from simplenerf_torch import native
from simplenerf_torch.qa.metrics import combine_visibility_masks


def compute_transformed_points(
    depth1: np.ndarray,
    transformation1: np.ndarray,
    transformation2: np.ndarray,
    intrinsic1: np.ndarray,
    intrinsic2: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Per-pixel positions of view-1 points in view-2's image space (h, w, 3)."""
    h, w = depth1.shape
    if intrinsic2 is None:
        intrinsic2 = intrinsic1
    transformation = transformation2 @ np.linalg.inv(transformation1)

    x2d, y2d = np.meshgrid(np.arange(w), np.arange(h))
    pix = np.stack([x2d, y2d, np.ones((h, w))], axis=2)  # (h, w, 3)
    cam_points = depth1[..., None] * (pix @ np.linalg.inv(intrinsic1).T)
    world_homo = np.concatenate([cam_points, np.ones((h, w, 1))], axis=2)
    trans = world_homo @ transformation.T
    return trans[..., :3] @ intrinsic2.T


def bilinear_splat(
    values: np.ndarray,
    trans_pos: np.ndarray,
    depth1: np.ndarray,
    mask1: Optional[np.ndarray] = None,
    plain: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Scatter `values` (h, w, c) to positions `trans_pos` (h, w, 2) with
    bilinear weights, down-weighted by depth so near surfaces win.

    Positions are shifted by one pixel onto an (h+2, w+2) canvas whose
    border collects the splats that fall outside, then cropped. The
    scatter runs in the native op, or with `plain` in numpy."""
    if mask1 is None:
        mask1 = np.ones(values.shape[:2], bool)
    if plain:
        acc, acc_w = _splat_accumulate_plain(values, trans_pos, depth1, mask1)
    else:
        acc, acc_w = native.bilinear_splat_accumulate(values, trans_pos, depth1, mask1)
    cropped = acc[1:-1, 1:-1]
    cropped_w = acc_w[1:-1, 1:-1]
    valid = cropped_w > 0
    with np.errstate(invalid="ignore"):
        out = np.where(valid[..., None], cropped / cropped_w[..., None], 0)
    return out, valid


def _splat_accumulate_plain(values, trans_pos, depth1, mask1):
    """The numpy scatter-accumulate (the JAX package's np.add.at path):
    (acc (h+2, w+2, c), acc_w (h+2, w+2))."""
    h, w, c = values.shape
    pos = trans_pos + 1
    floor = np.floor(pos).astype(int)
    ceil = np.ceil(pos).astype(int)
    pos[..., 0] = np.clip(pos[..., 0], 0, w + 1)
    pos[..., 1] = np.clip(pos[..., 1], 0, h + 1)
    floor[..., 0] = np.clip(floor[..., 0], 0, w + 1)
    floor[..., 1] = np.clip(floor[..., 1], 0, h + 1)
    ceil[..., 0] = np.clip(ceil[..., 0], 0, w + 1)
    ceil[..., 1] = np.clip(ceil[..., 1], 0, h + 1)

    fx = pos[..., 0] - floor[..., 0]
    fy = pos[..., 1] - floor[..., 1]
    cx = ceil[..., 0] - pos[..., 0]
    cy = ceil[..., 1] - pos[..., 1]
    prox = {
        "nw": (1 - fy) * (1 - fx),
        "sw": (1 - cy) * (1 - fx),
        "ne": (1 - fy) * (1 - cx),
        "se": (1 - cy) * (1 - cx),
    }
    corners = {
        "nw": (floor[..., 1], floor[..., 0]),
        "sw": (ceil[..., 1], floor[..., 0]),
        "ne": (floor[..., 1], ceil[..., 0]),
        "se": (ceil[..., 1], ceil[..., 0]),
    }

    sat_depth = np.clip(depth1, 0, 1000)
    log_depth = np.log1p(sat_depth)
    depth_weights = np.exp(log_depth / log_depth.max() * 50)

    acc = np.zeros((h + 2, w + 2, c))
    acc_w = np.zeros((h + 2, w + 2))
    for key in prox:
        weight = prox[key] * mask1 / depth_weights
        np.add.at(acc, corners[key], values * weight[..., None])
        np.add.at(acc_w, corners[key], weight)
    return acc, acc_w


def forward_warp(
    frame1: np.ndarray,
    depth1: np.ndarray,
    transformation1: np.ndarray,
    transformation2: np.ndarray,
    intrinsic1: np.ndarray,
    intrinsic2: Optional[np.ndarray] = None,
    mask1: Optional[np.ndarray] = None,
    plain: bool = False,
):
    """Warp frame1 into view 2. Returns (warped_frame, mask, warped_depth).
    `plain`: the splat's numpy plain version."""
    trans_points = compute_transformed_points(depth1, transformation1, transformation2, intrinsic1, intrinsic2)
    trans_coords = trans_points[..., :2] / trans_points[..., 2:3]
    trans_depth = trans_points[..., 2]

    warped, mask2 = bilinear_splat(frame1.astype(float), trans_coords, trans_depth, mask1, plain)
    warped_depth, _ = bilinear_splat(trans_depth[..., None], trans_coords, trans_depth, mask1,
                                     plain)
    return warped, mask2, warped_depth[..., 0]


class MaskComputer:
    """`plain`: splat with the numpy plain version (tests, chip_smoke)."""

    def __init__(self, depth_error_threshold: float = 0.05, plain: bool = False):
        self.depth_error_threshold = depth_error_threshold
        self.plain = plain

    def compute_mask(
        self,
        frame_train: np.ndarray,
        depth_train: np.ndarray,
        depth_test: np.ndarray,
        extrinsic_train: np.ndarray,
        extrinsic_test: np.ndarray,
        intrinsic_train: np.ndarray,
        intrinsic_test: np.ndarray,
    ) -> np.ndarray:
        threshold = self.depth_error_threshold * depth_train.max()
        _, warp_mask, warped_depth = forward_warp(
            frame_train, depth_train, extrinsic_train, extrinsic_test, intrinsic_train, intrinsic_test,
            plain=self.plain,
        )
        return warp_mask & (np.abs(warped_depth - depth_test) < threshold)


def generate_visibility_masks(
    output_dirpath: Path,
    scene_name: str,
    train_frames: dict,
    test_frames: dict,
    depth_error_threshold: float = 0.05,
) -> None:
    """Write {test:04}_{train:04}.npy masks for every (test, train) pair.

    train_frames/test_frames: {frame_num: dict(frame?, depth, extrinsic,
    intrinsic)} — depths are pseudo-GT (dense-NeRF renders in the reference,
    analytic GT for the synthetic scene). Skips existing files (resumable).
    """
    computer = MaskComputer(depth_error_threshold)
    out = Path(output_dirpath) / scene_name / "visibility_masks"
    out.mkdir(parents=True, exist_ok=True)
    for test_num, test in test_frames.items():
        for train_num, train in train_frames.items():
            path = out / f"{test_num:04}_{train_num:04}.npy"
            if path.exists():
                continue
            frame = train.get("frame")
            if frame is None:
                frame = np.zeros((*train["depth"].shape, 3), np.uint8)
            mask = computer.compute_mask(
                frame, train["depth"], test["depth"],
                train["extrinsic"], test["extrinsic"],
                train["intrinsic"], test["intrinsic"],
            )
            np.save(path, mask)


def load_visibility_mask(database_dirpath: Path, masks_dirname: str, scene_name: str,
                         test_num: int, train_nums,
                         database_subdir: str = "all") -> Optional[np.ndarray]:
    """Combined >=2-view visibility mask for one test frame, or None if any
    per-view mask file is missing. database_subdir is 'all' in the LLFF
    layout and 'test' in the RealEstate10K layout (reference
    qa/11_MaskedRMSE/src/MaskedRMSE01_RealEstate.py:70 vs the _NeRF_LLFF
    variant)."""
    masks = []
    for train_num in train_nums:
        path = (
            Path(database_dirpath)
            / f"{database_subdir}/visibility_masks/{masks_dirname}/{scene_name}/visibility_masks/{test_num:04}_{train_num:04}.npy"
        )
        if not path.exists():
            return None
        masks.append(np.load(path))
    return combine_visibility_masks(np.stack(masks))
