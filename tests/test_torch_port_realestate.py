"""The port's RealEstate10K layout against the JAX package.

- `generate_realestate_scene`: the same arrays as the JAX generator's for
  one seed, and the written files read back equal (images, cameras, split
  and sparse-depth CSVs);
- the RealEstate10K loader: frame splits, images, cameras, the fixed
  [1, 100] bounds and the sparse depth of every mode;
- the slice as a whole: `simplenerf_torch.drivers.realestate.main` on the
  CPU (tiny widths) trains, tests with QA (GT depths, VM02 masks under
  test/visibility_masks/) and renders the video from the set directory's
  pose CSV; the JAX package's `start_testing` then scores the port's
  checkpoint from the same run directory, and every QA score is equal.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from simplenerf_tpu.data import get_data_loader as jget_data_loader
from simplenerf_tpu.data.synthetic import generate_realestate_scene as jgenerate
from simplenerf_tpu.drivers import runner as jrunner
from simplenerf_torch.data import io
from simplenerf_torch.data.factory import get_data_loader
from simplenerf_torch.data.realestate import RealEstateDataLoader
from simplenerf_torch.data.synthetic import generate_realestate_scene
from simplenerf_torch.dataset_tools import video_poses
from simplenerf_torch.drivers import presets, realestate
from simplenerf_torch.qa import masks
from simplenerf_torch.qa.runner import ALL_METRICS

H, W = 24, 32
SCENE = dict(scene_num=0, num_frames=20, h=H, w=W, num_train=3, seed=5, max_test_frames=3)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """One RE10K-layout scene written by each package's generator."""
    root = tmp_path_factory.mktemp("re10k")
    gt = generate_realestate_scene(root / "port", **SCENE)
    jgt = jgenerate(root / "jax", **SCENE)
    return root, gt, jgt


def test_generator_matches_jax(scenes):
    root, gt, jgt = scenes
    assert gt.keys() == jgt.keys()
    for key in ("images", "depths", "extrinsics", "intrinsic", "train_frames", "val_frames",
                "test_frames"):
        np.testing.assert_array_equal(gt[key], jgt[key], err_msg=key)
    assert list(gt["train_frames"]) == [4, 8, 12] and len(gt["test_frames"]) == 3
    port, jax_ = root / "port", root / "jax"
    scene = "test/database_data/00000"
    for f in range(SCENE["num_frames"]):
        np.testing.assert_array_equal(io.read_image(port / f"{scene}/rgb/{f:04}.png"),
                                      io.read_image(jax_ / f"{scene}/rgb/{f:04}.png"))
    for name in ("CameraExtrinsics.csv", "CameraIntrinsics.csv"):
        assert (port / scene / name).read_text() == (jax_ / scene / name).read_text()
    for name in ("Train", "Validation", "Test"):
        rel = f"train_test_sets/set02/{name}VideosData.csv"
        assert io.read_csv(port / rel) == io.read_csv(jax_ / rel)
    sd = "test/estimated_depths/DE02/00000/estimated_depths"
    for f in gt["train_frames"]:
        got, want = io.read_csv(port / f"{sd}/{f:04}.csv"), io.read_csv(jax_ / f"{sd}/{f:04}.csv")
        assert got.keys() == want.keys()
        for col in got:
            np.testing.assert_array_equal(np.asarray(got[col], float), np.asarray(want[col], float))
    # A second scene keeps the first one's split rows.
    generate_realestate_scene(root / "port", **{**SCENE, "scene_num": 3})
    rows = io.read_csv(port / "train_test_sets/set02/TrainVideosData.csv")
    assert rows["scene_num"] == ["0"] * 3 + ["3"] * 3


def _configs(views: int = 3, iters: int = 4):
    train_cfg, test_cfg = realestate.build_configs(views, [0], iters, "float32", 0)
    train_cfg["data_loader"]["scene_id"] = 0
    return train_cfg, test_cfg


@pytest.mark.parametrize("mode", ["train", "validation", "test"])
def test_loader_matches_jax(scenes, mode):
    root, gt, _ = scenes
    cfg, _ = _configs()
    loader = get_data_loader(cfg, root / "port", mode)
    assert isinstance(loader, RealEstateDataLoader)
    got = loader.load_data()
    want = jget_data_loader(cfg, root / "port", mode).load_data()
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["frame_nums"], want["frame_nums"])
    for key, v in want["nerf_data"].items():
        np.testing.assert_array_equal(np.asarray(got["nerf_data"][key]), np.asarray(v), err_msg=key)
    np.testing.assert_array_equal(got["nerf_data"]["bounds"], [1.0, 100.0])
    if mode == "train":
        np.testing.assert_array_equal(got["frame_nums"], gt["train_frames"])
        for f, table in want["sparse_depth_data"].items():
            for col in table.columns:  # pandas parses floats to ~1e-16 absolute
                np.testing.assert_allclose(got["sparse_depth_data"][f][col], table[col].to_numpy(),
                                           rtol=0, atol=1e-15)
    else:
        assert "sparse_depth_data" not in got


def _tiny_published(**kw):
    """The published experiment's config at tiny widths, through the kernels'
    plain versions."""
    cfg = presets.tiny_synthetic_config(**kw, num_rays=64, sparse_depth_rays=32,
                                        consistency_start_iter=2)
    cfg["model"]["fused_mlp"] = "on"
    cfg["log_interval"] = 2
    return cfg


def test_realestate_driver_end_to_end_matches_jax(scenes, tmp_path, monkeypatch):
    _, gt, _ = scenes
    db = tmp_path / "db"
    generate_realestate_scene(db, **SCENE)
    # GT depths, VM02 masks in the RealEstate10K subtree, a 4-pose video.
    gtd = tmp_path / "gt_depth/00000"
    gtd.mkdir(parents=True)
    info = {int(f): {"frame": np.round(gt["images"][f] * 255).astype(np.uint8), "depth": gt["depths"][f],
                     "extrinsic": gt["extrinsics"][f], "intrinsic": gt["intrinsic"]}
            for f in range(SCENE["num_frames"])}
    for f in gt["test_frames"]:
        np.save(gtd / f"{f:04}.npy", gt["depths"][f])
    masks.generate_visibility_masks(db / "test/visibility_masks/VM02", "00000",
                                    {f: info[f] for f in gt["train_frames"]},
                                    {f: info[f] for f in gt["test_frames"]})
    poses = video_poses.create_spiral_video_poses(gt["extrinsics"][gt["train_frames"]], [1.0, 100.0],
                                                  num_frames=3)
    set_num, run_num = realestate.VIEWS_TO_SET[3]
    pose_dir = db / f"train_test_sets/set{set_num:02}/video_poses01"
    pose_dir.mkdir(parents=True)
    np.savetxt(pose_dir / "00000.csv", poses.reshape(len(poses), 16), delimiter=",")

    monkeypatch.setattr(realestate, "simplenerf_config", _tiny_published)
    out = tmp_path / "runs"
    scores = realestate.main(["--database-dir", str(db), "--output-dir", str(out), "--views", "3",
                              "--scenes", "0", "--iters", "4", "--compute-dtype", "float32",
                              "--gt-depth-dir", str(tmp_path / "gt_depth"), "--device", "cpu"])
    scene = out / f"training/train{run_num:04}/00000"
    assert (scene / "saved_models/Model_Iter000004.msgpack").exists()
    mc = json.loads((scene / "ModelConfigs.json").read_text())
    np.testing.assert_allclose(mc["bounds"], np.array([1.0, 100.0]) / 0.75)
    test_dir = out / f"testing/test{run_num:04}"
    for f in gt["test_frames"]:
        assert io.read_image(test_dir / f"00000/predicted_frames/{f:04}.png").shape == (H, W, 3)
    frames = sorted(p.name for p in (test_dir / "00000/PredictedVideo").glob("*.png"))
    assert frames == [f"{i:04}.png" for i in range(len(poses))]
    assert set(scores) == set(ALL_METRICS) - {"LPIPS", "MaskedLPIPS"}

    # The JAX package scores the port's checkpoint from the same run directory.
    _, jtest_cfg = _configs()
    jtest_cfg["test_num"] = run_num + 1
    jscores = jrunner.start_testing(jtest_cfg, db, out, gt_depth_dirpath=tmp_path / "gt_depth")
    assert jscores.keys() == scores.keys()
    assert scores == jscores, (scores, jscores)
