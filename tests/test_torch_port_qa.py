"""The port's QA suite, video tools and LLFF driver against the JAX package.

- each of the 14 QA metric functions on seeded frames and depths, equal to
  the JAX package's at 1e-12 (the same numpy and scipy code); LPIPS is
  None on both sides without the `lpips` package;
- the visibility-mask splat, forward warp and MaskComputer through the
  port's numpy plain version, equal to the JAX package's numpy path (the
  native splat against both: tests/test_torch_port_native.py);
- QARunner: the frame-wise and scene-wise CSVs and QA_Scores.json agree
  with the JAX runner's on the same prediction directory, and scored
  frames are not scored again;
- spiral and original-path video poses at 1e-12, their CSV, and the video
  frames written as PNGs and decoded back;
- the slice as a whole: `simplenerf_torch.drivers.llff.main` on the CPU
  (tiny widths) trains with validation, tests with QA and renders both
  videos; the JAX package's `start_testing` then loads the port's
  checkpoint from the same run directory and its QA scores agree at 1e-3.
"""

import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from simplenerf_tpu import native as jnative
from simplenerf_tpu.dataset_tools import video_poses as jvideo_poses
from simplenerf_tpu.drivers import runner as jrunner
from simplenerf_tpu.qa import masks as jmasks
from simplenerf_tpu.qa import metrics as JM
from simplenerf_tpu.qa.runner import QARunner as JQARunner
from simplenerf_torch.data import io
from simplenerf_torch.data.synthetic import generate_scene
from simplenerf_torch.dataset_tools import video_poses
from simplenerf_torch.drivers import llff, presets
from simplenerf_torch.qa import masks
from simplenerf_torch.qa import metrics as M
from simplenerf_torch.qa.runner import ALL_METRICS, QARunner

H, W = 24, 32


@pytest.fixture
def numpy_splat(monkeypatch):
    """The JAX package's masks through its numpy splat, not its native one."""
    monkeypatch.setattr(jnative, "_tried", True)
    monkeypatch.setattr(jnative, "_lib", None)


def _frames(seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    smooth = np.stack([x * 7 % 256, y * 9 % 256, (x + y) * 4 % 256], -1)
    gt = np.clip(smooth + rng.integers(-20, 20, (H, W, 3)), 0, 255).astype(np.uint8)
    pred = np.clip(gt.astype(int) + rng.integers(-30, 30, gt.shape), 0, 255).astype(np.uint8)
    depth_gt = rng.uniform(2.0, 6.0, (H, W))
    depth_pred = depth_gt * rng.uniform(0.9, 1.1, (H, W))
    mask = rng.random((H, W)) > 0.4
    return gt, pred, depth_gt, depth_pred, mask


@pytest.mark.parametrize("name", sorted(ALL_METRICS))
def test_metric_matches_jax(name):
    gt, pred, dgt, dpred, mask = _frames(seed=len(name))
    depth = name.startswith(("Depth", "MaskedDepth"))
    args = [dgt, dpred] if depth else [gt, pred]
    if name.startswith("Masked"):
        args.append(mask)
    jfn = _jax_families()[name]
    got, want = ALL_METRICS[name](*args), jfn(*args)
    if name.endswith("LPIPS"):
        assert got is None and want is None  # no lpips package on either side
        return
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _jax_families():
    from simplenerf_tpu.qa import runner as jr

    return {**jr.FRAME_METRICS, **jr.MASKED_FRAME_METRICS, **jr.DEPTH_METRICS,
            **jr.MASKED_DEPTH_METRICS}


def test_metric_families_and_ssim_map_match_jax():
    assert sorted(ALL_METRICS) == sorted(_jax_families()) and len(ALL_METRICS) == 14
    gt, pred, _, _, mask = _frames(seed=1)
    score, ssim_map = M.ssim(gt, pred, full=True)
    jscore, jmap = JM.ssim(gt, pred, full=True)
    assert score == jscore
    np.testing.assert_array_equal(ssim_map, jmap)
    stack = np.stack([mask, ~mask, mask])
    np.testing.assert_array_equal(M.combine_visibility_masks(stack), JM.combine_visibility_masks(stack))


def _warp_inputs(seed):
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    depth = rng.uniform(2.0, 5.0, (H, W))
    K = np.array([[25.0, 0, W / 2], [0, 25.0, H / 2], [0, 0, 1]])
    angle = 0.05
    E2 = np.eye(4)
    E2[:3, :3] = [[np.cos(angle), 0, np.sin(angle)], [0, 1, 0], [-np.sin(angle), 0, np.cos(angle)]]
    E2[:3, 3] = [0.3, -0.1, 0.05]
    mask1 = rng.random((H, W)) > 0.1
    return frame, depth, np.eye(4), E2, K, mask1


def test_bilinear_splat_matches_jax_numpy_path(numpy_splat):
    frame, depth, E1, E2, K, mask1 = _warp_inputs(0)
    pts = masks.compute_transformed_points(depth, E1, E2, K)
    np.testing.assert_array_equal(pts, jmasks.compute_transformed_points(depth, E1, E2, K))
    coords, z = pts[..., :2] / pts[..., 2:3], pts[..., 2]
    for m in (None, mask1):
        got = masks.bilinear_splat(frame.astype(float), coords.copy(), z, m, plain=True)
        want = jmasks.bilinear_splat(frame.astype(float), coords.copy(), z, m)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert got[1].any() and not got[1].all()


def test_forward_warp_matches_jax_numpy_path(numpy_splat):
    frame, depth, E1, E2, K, mask1 = _warp_inputs(1)
    got = masks.forward_warp(frame, depth, E1, E2, K, mask1=mask1, plain=True)
    want = jmasks.forward_warp(frame, depth, E1, E2, K, mask1=mask1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_mask_computer_matches_jax_numpy_path(numpy_splat, tmp_path):
    frame, depth, E1, E2, K, _ = _warp_inputs(2)
    depth_test = depth * np.random.default_rng(3).uniform(0.97, 1.03, depth.shape)
    got = masks.MaskComputer(0.05, plain=True).compute_mask(frame, depth, depth_test, E1, E2, K, K)
    want = jmasks.MaskComputer(0.05).compute_mask(frame, depth, depth_test, E1, E2, K, K)
    np.testing.assert_array_equal(got, want)
    assert 0.05 < got.mean() < 0.95
    # The mask files and their >= 2-view combination, both ways.
    train = {0: {"frame": frame, "depth": depth, "extrinsic": E1, "intrinsic": K},
             1: {"depth": depth_test, "extrinsic": E2, "intrinsic": K}}
    test = {7: {"depth": depth_test, "extrinsic": E2, "intrinsic": K}}
    masks.generate_visibility_masks(tmp_path / "all/visibility_masks/VM02", "s", train, test)
    saved = np.load(tmp_path / "all/visibility_masks/VM02/s/visibility_masks/0007_0000.npy")
    np.testing.assert_array_equal(saved, got)
    np.testing.assert_array_equal(masks.load_visibility_mask(tmp_path, "VM02", "s", 7, [0, 1]),
                                  jmasks.load_visibility_mask(tmp_path, "VM02", "s", 7, [0, 1]))
    assert masks.load_visibility_mask(tmp_path, "VM02", "s", 7, [0, 2]) is None


def _fake_run(root):
    """Two scenes of GT frames, depths and masks, and one prediction directory."""
    rng = np.random.default_rng(0)
    db, pred, gtd = root / "db", root / "pred", root / "gt_depth"
    scenes = {"toy": [3, 4], "zed": [1, 5, 6]}
    for scene, frames in scenes.items():
        for f in frames:
            gt, p, dgt, dpred, _ = _frames(seed=10 * f + len(scene))
            io.write_image(db / f"all/database_data/{scene}/rgb_down4/{f:04}.png", gt)
            io.write_image(pred / scene / f"predicted_frames/{f:04}.png", p)
            (gtd / scene).mkdir(parents=True, exist_ok=True)
            np.save(gtd / scene / f"{f:04}.npy", dgt)
            (pred / scene / "predicted_depths").mkdir(parents=True, exist_ok=True)
            np.save(pred / scene / f"predicted_depths/{f:04}.npy", dpred)
            for train in (0, 2):
                mdir = db / f"all/visibility_masks/VM02/{scene}/visibility_masks"
                mdir.mkdir(parents=True, exist_ok=True)
                np.save(mdir / f"{f:04}_{train:04}.npy", rng.random((H, W)) > 0.3)
    return db, pred, gtd, scenes


def test_qa_runner_matches_jax(tmp_path):
    db, pred, gtd, scenes = _fake_run(tmp_path)
    jpred = tmp_path / "jpred"
    shutil.copytree(pred, jpred)
    train = {s: [0, 2] for s in scenes}
    scale = {"toy": 1.5, "zed": 0.5}
    kw = dict(masks_dirname="VM02", gt_depth_dirpath=gtd, depth_scale=scale)
    scores = QARunner(db, pred, list(scenes), train, scenes, **kw).run()
    jscores = JQARunner(db, jpred, list(scenes), train, scenes, **kw).run()
    assert set(scores) == set(jscores) == set(ALL_METRICS) - {"LPIPS", "MaskedLPIPS"}
    for k in jscores:
        np.testing.assert_allclose(scores[k], jscores[k], rtol=1e-12, atol=1e-12, err_msg=k)
    mine, theirs = (json.loads((d / "QA_Scores.json").read_text()) for d in (pred, jpred))
    assert mine == theirs and set(mine["skipped"]) == {"LPIPS", "MaskedLPIPS"}
    for name in jscores:
        for kind in ("FrameWise", "SceneWise"):
            got = io.read_csv(pred / f"QA_Scores/{name}_{kind}.csv")
            want = io.read_csv(jpred / f"QA_Scores/{name}_{kind}.csv")
            assert list(got) == list(want) and got["scene_name"] == want["scene_name"], name
            for col in list(got)[1:]:
                np.testing.assert_allclose(np.asarray(got[col], float), np.asarray(want[col], float),
                                           rtol=1e-12, atol=1e-12, err_msg=f"{name} {kind} {col}")
    # Frames already scored are not scored again: a changed prediction
    # leaves the CSVs as they were, and the scores are the same.
    io.write_image(pred / "toy/predicted_frames/0003.png", np.zeros((H, W, 3), np.uint8))
    before = (pred / "QA_Scores/PSNR_FrameWise.csv").read_text()
    assert QARunner(db, pred, list(scenes), train, scenes, **kw).run() == scores
    assert (pred / "QA_Scores/PSNR_FrameWise.csv").read_text() == before


def test_video_poses_match_jax(tmp_path):
    extr, _, _ = _scene_extrinsics(tmp_path)
    bounds = np.array([2.0, 9.0])
    got = video_poses.create_spiral_video_poses(extr, bounds, num_frames=5)
    want = jvideo_poses.create_spiral_video_poses(extr, bounds, num_frames=5)
    assert got.shape == (6, 4, 4) and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(video_poses.create_original_path_poses(extr, 7),
                                  jvideo_poses.create_original_path_poses(extr, 7))
    mine = video_poses.save_video_poses(tmp_path / "a", "s", got)
    theirs = jvideo_poses.save_video_poses(tmp_path / "b", "s", got)
    assert mine.read_text() == theirs.read_text()
    # Video frames: PNGs under the target without its suffix, decoded back equal.
    frames = np.random.default_rng(0).integers(0, 256, (3, H, W, 3)).astype(np.uint8)
    out = io.write_video(tmp_path / "v/PredictedVideo.mp4", frames)
    assert out == tmp_path / "v/PredictedVideo"
    assert sorted(p.name for p in out.iterdir()) == ["0000.png", "0001.png", "0002.png"]
    for i in range(3):
        np.testing.assert_array_equal(io.read_image(out / f"{i:04}.png"), frames[i])


def _scene_extrinsics(tmp_path):
    gt = generate_scene(tmp_path / "scene", num_frames=6, h=H, w=W, num_train=3, seed=0)
    return gt["extrinsics"][gt["train_frames"]], gt, tmp_path / "scene"


def _tiny_published(**kw):
    """The published experiment's config at tiny widths, through the kernels'
    plain versions, with validation every 2 steps."""
    cfg = presets.tiny_synthetic_config(**kw, scene_id="blobs", num_rays=64, sparse_depth_rays=32,
                                        consistency_start_iter=2)
    cfg["model"]["fused_mlp"] = "on"
    cfg["validation_interval"] = 2
    cfg["log_interval"] = 2
    return cfg


def test_llff_driver_end_to_end_matches_jax(tmp_path, monkeypatch):
    _, gt, db = _scene_extrinsics(tmp_path)
    # GT depths, VM02 masks and a 3-pose spiral for the scene.
    gtd = tmp_path / "gt_depth/blobs"
    gtd.mkdir(parents=True)
    info = {int(f): {"frame": np.round(gt["images"][f] * 255).astype(np.uint8), "depth": gt["depths"][f],
                     "extrinsic": gt["extrinsics"][f], "intrinsic": gt["intrinsic"]}
            for f in range(len(gt["images"]))}
    for f in gt["test_frames"]:
        np.save(gtd / f"{f:04}.npy", gt["depths"][f])
    masks.generate_visibility_masks(db / "all/visibility_masks/VM02", "blobs",
                                    {f: info[f] for f in gt["train_frames"]},
                                    {f: info[f] for f in gt["test_frames"]})
    bds = np.loadtxt(db / "all/database_data/blobs/DepthBounds.csv", delimiter=",")
    spiral = video_poses.create_spiral_video_poses(
        gt["extrinsics"][gt["train_frames"]], [bds.min(), bds.max()], num_frames=3)
    video_poses.save_video_poses(db, "blobs", spiral)

    monkeypatch.setattr(llff, "simplenerf_config", _tiny_published)
    out = tmp_path / "runs"
    scores = llff.main(["--database-dir", str(db), "--output-dir", str(out), "--views", "2",
                        "--scenes", "blobs", "--iters", "4", "--compute-dtype", "float32",
                        "--gt-depth-dir", str(tmp_path / "gt_depth"), "--device", "cpu"])
    run_num = llff.VIEWS_TO_SET[2][1]
    scene = out / f"training/train{run_num:04}/blobs"
    assert (scene / "saved_models/Model_Iter000004.msgpack").exists()
    assert (scene / f"samples/predicted_frames/{gt['val_frames'][0]:04}_fine_Iter00004.png").exists()
    rows = [json.loads(r) for r in (scene / "logs/scalars.jsonl").read_text().splitlines()]
    assert {"validation/train_images/psnr", "validation/val_images/psnr"} <= {k for r in rows for k in r}
    test_dir = out / f"testing/test{run_num:04}"
    for name in ("PredictedVideo", "StaticCameraVideo"):
        assert len(list((test_dir / f"blobs/{name}").glob("*.png"))) == len(spiral)
    assert set(scores) == set(ALL_METRICS) - {"LPIPS", "MaskedLPIPS"}

    # The JAX package tests the port's checkpoint from the same run directory.
    _, jtest_cfg = llff.build_configs(2, ["blobs"], 4, "float32", 0)
    jtest_cfg["test_num"] = run_num + 1
    jscores = jrunner.start_testing(jtest_cfg, db, out, gt_depth_dirpath=tmp_path / "gt_depth")
    assert set(jscores) == set(scores)
    for k in ("PSNR", "SSIM", "DepthMAE"):
        np.testing.assert_allclose(scores[k], jscores[k], rtol=0, atol=1e-3, err_msg=k)
    jtest_dir = out / f"testing/test{run_num + 1:04}"

    def layout(d):
        return sorted(str(p.relative_to(d)) for p in d.rglob("*")
                      if p.is_file() and "Video" not in str(p))

    assert layout(test_dir) == layout(jtest_dir)
