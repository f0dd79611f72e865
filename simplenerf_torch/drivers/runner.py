"""Experiment orchestration for serving: render every test frame of every scene.

Port of the testing part of simplenerf_tpu/drivers/runner.py: resolves
scene lists from the split CSVs, loads each scene's trained model from
runs/training/trainNNNN/<scene>/, and renders its test frames (with the
train frames as secondary poses when the model predicts visibility) into
runs/testing/testNNNN/<scene>/. Existing outputs are skipped. Training,
videos and QA come in later slices.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Optional

import numpy as np

from simplenerf_torch import config as config_lib
from simplenerf_torch.data import io
from simplenerf_torch.data.factory import get_data_loader
from simplenerf_torch.training.tester import Tester


def scene_key(configs: dict, scene_id) -> str:
    return f"{int(scene_id):05}" if str(scene_id).isdigit() else str(scene_id)


def resolve_scene_ids(configs: dict, database_dirpath: Path, mode: str = "train"):
    """Scene list from configs or the split CSV."""
    if "scene_names" in configs["data_loader"] and configs["data_loader"]["scene_names"]:
        return list(configs["data_loader"]["scene_names"])
    set_num = configs["data_loader"]["train_set_num"]
    table = io.read_csv(Path(database_dirpath) / f"train_test_sets/set{set_num:02}/TrainVideosData.csv")
    if "scene_name" in table:
        return sorted(set(table["scene_name"]))
    return sorted({int(s) for s in table["scene_num"]})


def load_scene_tester(
    train_run_dir: Path, scene_id, test_configs: dict, checkpoint_name: Optional[str] = None,
    device=None,
) -> Tester:
    train_run_dir = Path(train_run_dir)
    train_configs = config_lib.load_configs(train_run_dir / "Configs.json")
    train_configs["data_loader"]["scene_id"] = scene_id
    key = scene_key(train_configs, scene_id)
    model_configs = json.loads((train_run_dir / key / "ModelConfigs.json").read_text())
    tester = Tester(train_configs, model_configs, device=device)
    ckpt = (
        train_run_dir / key / "saved_models" / checkpoint_name
        if checkpoint_name
        else train_run_dir / key / "saved_models/Model_Latest.msgpack"
    )
    tester.load_model(ckpt)
    return tester


def _scene_frames(database_dirpath: Path, configs: dict, scene_id, mode: str):
    cfg = copy.deepcopy(configs)
    cfg["data_loader"]["scene_id"] = scene_id
    loader = get_data_loader(cfg, database_dirpath, mode)
    return loader.get_frame_nums(), loader


def start_testing(
    test_configs: dict,
    database_dirpath: Path,
    output_dirpath: Path,
    run_qa: bool = True,
    device=None,
) -> dict:
    """Render all test frames for every scene; returns {scene: [frame nums]}.

    QA scoring (`run_qa=True`) comes in a later slice and raises here.
    """
    if run_qa:
        raise NotImplementedError("QA scoring is not ported yet; call with run_qa=False")
    database_dirpath = Path(database_dirpath)
    test_num = test_configs.get("test_num", 0)
    train_num = test_configs.get("train_num", 0)
    test_dir = Path(output_dirpath) / f"testing/test{test_num:04}"
    train_run_dir = Path(output_dirpath) / f"training/train{train_num:04}"
    test_dir.mkdir(parents=True, exist_ok=True)
    # Drift guard: re-testing with changed test configs raises instead of
    # overwriting the saved Configs.json.
    config_lib.save_test_configs(test_dir, test_configs)

    train_configs = config_lib.load_configs(train_run_dir / "Configs.json")
    scene_ids = test_configs.get("scene_names") or resolve_scene_ids(train_configs, database_dirpath)

    rendered = {}
    for scene_id in scene_ids:
        key = scene_key(train_configs, scene_id)
        tester = load_scene_tester(
            train_run_dir, scene_id, test_configs,
            checkpoint_name=test_configs.get("checkpoint_name"), device=device,
        )
        test_nums, test_loader = _scene_frames(database_dirpath, train_configs, scene_id, "test")
        raw = test_loader.load_data()
        extrinsics = raw["nerf_data"]["extrinsics"]
        intrinsics = raw["nerf_data"]["intrinsics"]

        secondary = None
        if tester.render_cfg.predict_visibility:
            _, train_loader = _scene_frames(database_dirpath, train_configs, scene_id, "train")
            secondary = list(train_loader.load_data()["nerf_data"]["extrinsics"])

        frames_data = {
            int(frame_num): {
                "extrinsic": extrinsics[i],
                "intrinsic": intrinsics[i],
                "secondary_poses": secondary,
            }
            for i, frame_num in enumerate(test_nums)
        }
        tester.test_scene(test_dir / key, frames_data)
        rendered[key] = [int(f) for f in np.asarray(test_nums)]
    return rendered
