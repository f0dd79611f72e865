"""NeRF-LLFF raw data loader (numpy + csv; no pandas).

Reads the reference's on-disk scene layout: frame splits from
train_test_sets/setNN/{Mode}VideosData.csv, images from
all/database_data/<scene>/rgb{suffix}/NNNN.png, depth bounds, flattened
4x4 w2c extrinsics and 3x3 intrinsics CSVs, per-frame COLMAP sparse-depth
CSVs, dense depth .npy files and visibility-prior masks.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from simplenerf_torch.data import io


class NerfLlffDataLoader:
    def __init__(self, configs: dict, data_dirpath: Path, mode: Optional[str]):
        self.configs = configs
        self.data_dirpath = Path(data_dirpath)
        self.mode = mode
        self.scene_name = configs["data_loader"]["scene_id"]
        self.resolution_suffix = configs["data_loader"]["resolution_suffix"]
        dl = configs["data_loader"]
        self.sparse_depth_needed = "sparse_depth" in dl
        self.dense_depth_needed = "dense_depth" in dl
        self.visibility_prior_needed = "visibility_prior" in dl

    # ------------------------------------------------------------------
    def load_data(self) -> dict:
        frame_nums = self.get_frame_nums()
        data = {"frame_nums": frame_nums, "nerf_data": self.load_nerf_data(frame_nums)}
        if self.sparse_depth_needed and self.mode == "train":
            data["sparse_depth_data"] = self.load_sparse_depth_data(frame_nums)
        if self.dense_depth_needed and self.mode == "train":
            data["dense_depth_data"] = self.load_dense_depth_data(frame_nums)
        if self.visibility_prior_needed and self.mode == "train":
            data["visibility_prior_data"] = self.load_visibility_prior_data(frame_nums)
        return data

    def get_frame_nums(self) -> np.ndarray:
        set_num = self.configs["data_loader"]["train_set_num"]
        path = self.data_dirpath / f"train_test_sets/set{set_num:02}/{self.mode.capitalize()}VideosData.csv"
        table = io.read_csv(path)
        frames = [
            int(f)
            for s, f in zip(table["scene_name"], table["pred_frame_num"])
            if s == str(self.scene_name)
        ]
        return np.asarray(frames, dtype=np.int64)

    def scene_dirpath(self) -> Path:
        return self.data_dirpath / f"all/database_data/{self.scene_name}"

    def load_nerf_data(self, frame_nums: np.ndarray) -> dict:
        scene_dir = self.scene_dirpath()
        images = np.stack(
            [io.read_image(scene_dir / f"rgb{self.resolution_suffix}/{f:04}.png") for f in frame_nums]
        )
        bds = np.loadtxt(scene_dir / "DepthBounds.csv", delimiter=",")[frame_nums]
        bounds = np.array([bds.min(), bds.max()])
        extrinsics = np.loadtxt(scene_dir / "CameraExtrinsics.csv", delimiter=",").reshape(-1, 4, 4)[frame_nums]
        intrinsics = np.loadtxt(
            scene_dir / f"CameraIntrinsics{self.resolution_suffix}.csv", delimiter=","
        ).reshape(-1, 3, 3)[frame_nums]
        h, w = images.shape[1:3]
        return {
            "images": images,
            "extrinsics": extrinsics,
            "intrinsics": intrinsics,
            "resolution": (h, w),
            "bounds": bounds,
        }

    def load_sparse_depth_data(self, frame_nums: np.ndarray) -> dict:
        """{frame: {column: float64 array}} from the per-frame sparse-depth CSVs."""
        dirname = self.configs["data_loader"]["sparse_depth"]["dirname"]
        out = {}
        for f in frame_nums:
            path = (
                self.data_dirpath
                / f"all/estimated_depths/{dirname}/{self.scene_name}/estimated_depths{self.resolution_suffix}/{f:04}.csv"
            )
            out[int(f)] = {k: np.asarray(v, dtype=np.float64) for k, v in io.read_csv(path).items()}
        return out

    def load_dense_depth_data(self, frame_nums: np.ndarray) -> dict:
        dd_cfg = self.configs["data_loader"]["dense_depth"]
        dirname = dd_cfg["dirname"]
        weights_suffix = dd_cfg.get("weights_suffix", "")
        depths, weights = [], []
        for f in frame_nums:
            base = self.data_dirpath / f"all/estimated_depths/{dirname}/{self.scene_name}"
            depth = np.load(base / f"estimated_depths{self.resolution_suffix}/{f:04}.npy")
            depths.append(depth)
            wpath = base / f"Weights{self.resolution_suffix}{weights_suffix}/{f:04}.npy"
            weights.append(np.load(wpath) if wpath.exists() else np.ones_like(depth))
        return {"depth_values": np.stack(depths), "depth_weights": np.stack(weights)}

    def load_visibility_prior_data(self, frame_nums: np.ndarray) -> dict:
        vp_cfg = self.configs["data_loader"]["visibility_prior"]
        base = self.data_dirpath / "all/visibility_prior"
        out = {}
        if vp_cfg.get("load_masks"):
            out["masks"] = np.array([
                [
                    io.read_mask(base / f"{vp_cfg['masks_dirname']}/{self.scene_name}/visibility_masks/{f1:04}_{f2:04}.png")
                    for f2 in frame_nums if f2 != f1
                ]
                for f1 in frame_nums
            ])  # (n, n-1, h, w)
        if vp_cfg.get("load_weights"):
            out["weights"] = np.array([
                [
                    np.load(base / f"{vp_cfg['weights_dirname']}/{self.scene_name}/visibility_weights/{f1:04}_{f2:04}.npy")
                    for f2 in frame_nums if f2 != f1
                ]
                for f1 in frame_nums
            ])
        return out
