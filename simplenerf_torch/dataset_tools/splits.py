"""Train/validation/test split creators (offline dataset tooling).

Port of simplenerf_tpu/dataset_tools/splits.py, writing its CSVs with the
port's csv helper (no pandas).

NeRF-LLFF: test = every 8th frame, validation = middle test frame, train =
n uniformly spaced of the rest (reference TrainTestCreator01_
UniformSparseSampling). RealEstate10K: train = first frames at stride 10,
the rest test (reference real_estate TrainTestCreator01).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from simplenerf_torch.data import io


def sample_sparse_train_frames(frame_nums, num_frames: int) -> np.ndarray:
    """n uniformly spaced interior samples (the reference's
    linspace(-1, len, n+2)[1:-1] rounding)."""
    frame_nums = np.asarray(sorted(frame_nums))
    if num_frames == -1:
        return frame_nums
    idx = np.round(np.linspace(-1, len(frame_nums), num_frames + 2)).astype(int)[1:-1]
    return frame_nums[idx]


def llff_split(frame_nums, num_train_frames: int):
    """(train, val, test) frame numbers for one LLFF scene."""
    frame_nums = sorted(frame_nums)
    test = list(range(0, len(frame_nums), 8))
    train_pool = sorted(set(frame_nums) - set(test))
    train = sample_sparse_train_frames(train_pool, num_train_frames)
    val = [test[len(test) // 2]]
    return np.asarray(train), np.asarray(val), np.asarray(test)


def _write_sets(set_dirpath: Path, key: str, rows: dict) -> None:
    for name, data in rows.items():
        io.write_csv(set_dirpath / f"{name}VideosData.csv", {
            key: [r[0] for r in data],
            "pred_frame_num": [r[1] for r in data],
        })


def create_llff_train_test_set(database_dirpath: Path, set_num: int, num_train_frames: int) -> None:
    """Scan all/database_data/<scene>/rgb* and write the three split CSVs."""
    database_dirpath = Path(database_dirpath)
    scenes_dirpath = database_dirpath / "all/database_data"
    set_dirpath = database_dirpath / f"train_test_sets/set{set_num:02}"
    set_dirpath.mkdir(parents=True, exist_ok=True)

    rows = {"Train": [], "Validation": [], "Test": []}
    for scene_dir in sorted(scenes_dirpath.iterdir()):
        rgb_dirs = sorted(scene_dir.glob("rgb*"))
        if not rgb_dirs:
            continue
        frame_nums = sorted(int(p.stem) for p in rgb_dirs[0].glob("*.png"))
        train, val, test = llff_split(frame_nums, num_train_frames)
        for name, frames in (("Train", train), ("Validation", val), ("Test", test)):
            rows[name] += [[scene_dir.name, int(f)] for f in frames]
    _write_sets(set_dirpath, "scene_name", rows)


def realestate_split(num_frames: int, num_train_frames: int):
    """(train, val, test) for a 50-frame RE10K clip: train prefix at stride
    10, one validation frame past the last train frame, everything else test."""
    train = np.arange(num_train_frames) * 10
    test = np.array([f for f in np.arange(num_frames) if f not in train])
    val = np.array([int(train[-1]) + 5]) if len(train) else np.array([5])
    return train, val, test


def create_realestate_train_test_set(
    database_dirpath: Path, set_num: int, num_train_frames: int, num_frames: int = 50
) -> None:
    """Split every scene under test/database_data/ and write the three CSVs."""
    database_dirpath = Path(database_dirpath)
    scenes_dirpath = database_dirpath / "test/database_data"
    set_dirpath = database_dirpath / f"train_test_sets/set{set_num:02}"
    set_dirpath.mkdir(parents=True, exist_ok=True)
    rows = {"Train": [], "Validation": [], "Test": []}
    for scene_dir in sorted(scenes_dirpath.iterdir()):
        scene_num = int(scene_dir.name)
        train, val, test = realestate_split(num_frames, num_train_frames)
        for name, frames in (("Train", train), ("Validation", val), ("Test", test)):
            rows[name] += [[scene_num, int(f)] for f in frames]
    _write_sets(set_dirpath, "scene_num", rows)
