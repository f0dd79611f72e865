"""RealEstate10K raw data loader (numpy + csv; no pandas).

Port of simplenerf_tpu/data/realestate.py. Same contract as the LLFF
loader; scenes are 5-digit numbers under test/database_data/, bounds are
fixed [1, 100], intrinsics have no resolution suffix (reference
RealEstateDataLoader01), sparse depth lies under test/estimated_depths/.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from simplenerf_torch.data import io


class RealEstateDataLoader:
    def __init__(self, configs: dict, data_dirpath: Path, mode: Optional[str]):
        self.configs = configs
        self.data_dirpath = Path(data_dirpath)
        self.mode = mode
        self.scene_num = int(configs["data_loader"]["scene_id"])
        dl = configs["data_loader"]
        self.sparse_depth_needed = "sparse_depth" in dl
        self.dense_depth_needed = "dense_depth" in dl
        self.visibility_prior_needed = "visibility_prior" in dl

    def load_data(self) -> dict:
        frame_nums = self.get_frame_nums()
        data = {"frame_nums": frame_nums, "nerf_data": self.load_nerf_data(frame_nums)}
        if self.sparse_depth_needed and self.mode == "train":
            data["sparse_depth_data"] = self.load_sparse_depth_data(frame_nums)
        return data

    def get_frame_nums(self) -> np.ndarray:
        set_num = self.configs["data_loader"]["train_set_num"]
        path = self.data_dirpath / f"train_test_sets/set{set_num:02}/{self.mode.capitalize()}VideosData.csv"
        table = io.read_csv(path)
        frames = [
            int(f)
            for s, f in zip(table["scene_num"], table["pred_frame_num"])
            if int(s) == self.scene_num
        ]
        return np.asarray(frames, dtype=np.int64)

    def scene_dirpath(self) -> Path:
        return self.data_dirpath / f"test/database_data/{self.scene_num:05}"

    def load_nerf_data(self, frame_nums: np.ndarray) -> dict:
        scene_dir = self.scene_dirpath()
        images = np.stack([io.read_image(scene_dir / f"rgb/{f:04}.png") for f in frame_nums])
        extrinsics = np.loadtxt(scene_dir / "CameraExtrinsics.csv", delimiter=",").reshape(-1, 4, 4)[frame_nums]
        intrinsics = np.loadtxt(scene_dir / "CameraIntrinsics.csv", delimiter=",").reshape(-1, 3, 3)[frame_nums]
        h, w = images.shape[1:3]
        return {
            "images": images,
            "extrinsics": extrinsics,
            "intrinsics": intrinsics,
            "resolution": (h, w),
            "bounds": np.array([1.0, 100.0], dtype=np.float32),
        }

    def load_sparse_depth_data(self, frame_nums: np.ndarray) -> dict:
        """{frame: {column: float64 array}} from the per-frame sparse-depth CSVs."""
        dirname = self.configs["data_loader"]["sparse_depth"]["dirname"]
        out = {}
        for f in frame_nums:
            path = (
                self.data_dirpath
                / f"test/estimated_depths/{dirname}/{self.scene_num:05}/estimated_depths/{f:04}.csv"
            )
            out[int(f)] = {k: np.asarray(v, dtype=np.float64) for k, v in io.read_csv(path).items()}
        return out
