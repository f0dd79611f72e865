"""Experiment orchestration: train -> test -> QA -> videos, per scene.

Port of simplenerf_tpu/drivers/runner.py: resolves scene lists from the
split CSVs, trains each scene into runs/training/trainNNNN/<scene>/
(configs, ModelConfigs.json, checkpoints, logs, validation samples, plots),
renders each scene's test frames (with the train frames as secondary poses
when the model predicts visibility) into runs/testing/testNNNN/<scene>/,
scores them with the QA suite in-process, and renders pose-path videos.
Finished scenes and existing outputs are skipped. Both database layouts
are read: NeRF-LLFF (all/) and RealEstate10K (test/). `start_training`
takes a ray-sharded mesh (parallel.make_mesh) for a job of several
processes; each process then trains into its own `output_dirpath`.
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
from simplenerf_torch.data.preprocessor import ScenePreprocessor
from simplenerf_torch.qa.runner import QARunner
from simplenerf_torch.training.tester import Tester
from simplenerf_torch.training.trainer import Trainer


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


def start_training(
    train_configs: dict, database_dirpath: Path, output_dirpath: Path, device=None, mesh=None
) -> Path:
    """Train every scene; returns the train run directory. With a `mesh`
    each step is sharded over its ranks' rays (the device defaults to the
    mesh's)."""
    if mesh is not None and device is None:
        device = mesh.device
    database_dirpath = Path(database_dirpath)
    train_num = train_configs.get("train_num", 0)
    run_dir = Path(output_dirpath) / f"training/train{train_num:04}"
    run_dir.mkdir(parents=True, exist_ok=True)
    config_lib.save_configs(run_dir, train_configs)

    for scene_id in resolve_scene_ids(train_configs, database_dirpath):
        scene_cfg = copy.deepcopy(train_configs)
        scene_cfg["data_loader"]["scene_id"] = scene_id
        scene_dir = run_dir / scene_key(scene_cfg, scene_id)
        done_marker = scene_dir / "saved_models/Model_Latest.msgpack"

        raw = get_data_loader(scene_cfg, database_dirpath, "train").load_data()
        train_pp = ScenePreprocessor(scene_cfg, "train", raw, device=device,
                                     seed=scene_cfg.get("seed", 0))
        scene_dir.mkdir(parents=True, exist_ok=True)
        (scene_dir / "ModelConfigs.json").write_text(json.dumps(train_pp.get_model_configs(), indent=2))

        val_pp = None
        if scene_cfg.get("validation_interval", 0):
            try:
                val_raw = get_data_loader(scene_cfg, database_dirpath, "validation").load_data()
            except FileNotFoundError:  # no validation split: train frames only
                val_raw = None
            if val_raw is not None:
                val_pp = ScenePreprocessor(scene_cfg, "validation", val_raw,
                                           model_configs=train_pp.get_model_configs(),
                                           device=device)

        trainer = Trainer(scene_cfg, scene_dir, train_pp, val_pp=val_pp, mesh=mesh)
        if trainer.start_iter >= scene_cfg["num_iterations"] and done_marker.exists():
            trainer.logger.close()
            continue
        trainer.train()
        trainer.logger.close()
        trainer.logger.save_plots()
    return run_dir


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
    gt_depth_dirpath: Optional[Path] = None,
    depth_scale="auto",
    device=None,
) -> dict:
    """Render all test frames of every scene, then run the QA suite.

    Returns the QA scores {family: mean score} (`{}` with run_qa=False);
    the frames are under testing/testNNNN/<scene>/predicted_frames/.
    depth_scale: a float, {scene: float}, or "auto", which takes each
    scene's 1/translation_scale from its training ModelConfigs: the
    normalized-frame -> world-unit factor of the QA depth families.
    """
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

    scene_names, train_frames, test_frames, scale_by_scene = [], {}, {}, {}
    for scene_id in scene_ids:
        key = scene_key(train_configs, scene_id)
        if depth_scale == "auto":
            mc = json.loads((train_run_dir / key / "ModelConfigs.json").read_text())
            scale_by_scene[key] = 1.0 / float(mc.get("translation_scale", 1.0))
        tester = load_scene_tester(
            train_run_dir, scene_id, test_configs,
            checkpoint_name=test_configs.get("checkpoint_name"), device=device,
        )
        test_nums, test_loader = _scene_frames(database_dirpath, train_configs, scene_id, "test")
        train_nums, train_loader = _scene_frames(database_dirpath, train_configs, scene_id, "train")
        raw = test_loader.load_data()
        extrinsics = raw["nerf_data"]["extrinsics"]
        intrinsics = raw["nerf_data"]["intrinsics"]

        secondary = None
        if tester.render_cfg.predict_visibility:
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
        scene_names.append(key)
        train_frames[key] = [int(f) for f in train_nums]
        test_frames[key] = [int(f) for f in test_nums]

    if not run_qa:
        return {}
    loader_name = train_configs["data_loader"]["data_loader_name"]
    return QARunner(
        database_dirpath,
        test_dir,
        scene_names,
        train_frames,
        test_frames,
        resolution_suffix=train_configs["data_loader"]["resolution_suffix"],
        masks_dirname=test_configs.get("qa_masks_dirname"),
        gt_depth_dirpath=gt_depth_dirpath,
        depth_scale=scale_by_scene if depth_scale == "auto" else depth_scale,
        database_subdir="test" if loader_name.startswith("RealEstate") else "all",
    ).run()


def start_testing_videos(
    test_configs: dict,
    database_dirpath: Path,
    output_dirpath: Path,
    video_poses_dirname: str = "video_poses01",
    static_camera: bool = False,
    device=None,
) -> None:
    """Render each scene's pose-path video from
    all/database_data/<scene>/<video_poses_dirname>/VideoPoses.csv
    (RealEstate10K: train_test_sets/setNN/<video_poses_dirname>/<scene>.csv)
    into testing/testNNNN/<scene>/PredictedVideo/NNNN.png (io.write_video's
    layout). static_camera keeps the ray camera at the path's first pose
    and sweeps only the shading view direction, into StaticCameraVideo/.
    A scene without a pose file, or whose video is complete, is skipped."""
    database_dirpath = Path(database_dirpath)
    test_num = test_configs.get("test_num", 0)
    train_num = test_configs.get("train_num", 0)
    test_dir = Path(output_dirpath) / f"testing/test{test_num:04}"
    train_run_dir = Path(output_dirpath) / f"training/train{train_num:04}"
    train_configs = config_lib.load_configs(train_run_dir / "Configs.json")
    scene_ids = test_configs.get("scene_names") or resolve_scene_ids(train_configs, database_dirpath)

    realestate = train_configs["data_loader"]["data_loader_name"].startswith("RealEstate")
    for scene_id in scene_ids:
        key = scene_key(train_configs, scene_id)
        if realestate:
            # RE10K keeps per-scene video pose CSVs under the set directory
            # (reference RealEstateTrainerTester01).
            set_num = test_configs.get("test_set_num", train_configs["data_loader"]["train_set_num"])
            base = database_dirpath / f"train_test_sets/set{set_num:02}/{video_poses_dirname}"
            poses_path = base / f"{key}.csv"
            if not poses_path.exists():
                poses_path = base / f"{scene_id}.csv"
        else:
            poses_path = database_dirpath / f"all/database_data/{key}/{video_poses_dirname}/VideoPoses.csv"
        if not poses_path.exists():
            continue
        poses = np.loadtxt(poses_path, delimiter=",").reshape(-1, 4, 4)
        name = "StaticCameraVideo" if static_camera else "PredictedVideo"
        out_path = test_dir / key / f"{name}.mp4"
        if (out_path.with_suffix("") / f"{len(poses) - 1:04}.png").exists():
            continue
        tester = load_scene_tester(train_run_dir, scene_id, test_configs, device=device)
        if static_camera:
            fixed = np.tile(poses[:1], (len(poses), 1, 1))
            frames = tester.render_video_poses(fixed, view_poses=poses)
        else:
            frames = tester.render_video_poses(poses)
        io.write_video(out_path, frames)
