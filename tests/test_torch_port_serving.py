"""The serving slice end to end against the JAX package, on a tiny synthetic scene.

A JAX-written checkpoint is served by the port's `load_scene_tester` /
`start_testing` and by the JAX `Tester`; the frames agree. Checkpoints
cross in the other direction too, and both train-mode preprocessors write
the same ModelConfigs.
"""

import json

import jax
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from simplenerf_tpu import config as jconfig
from simplenerf_tpu.data import get_data_loader as jget_loader
from simplenerf_tpu.data.preprocessor import ScenePreprocessor as JPreprocessor
from simplenerf_tpu.data.synthetic import generate_scene as jgenerate
from simplenerf_tpu.drivers import presets as jpresets
from simplenerf_tpu.drivers import runner as jrunner
from simplenerf_tpu.render import renderer as jrenderer
from simplenerf_tpu.training import checkpoints as jckpt
from simplenerf_torch import config
from simplenerf_torch.data import io
from simplenerf_torch.data.factory import get_data_loader
from simplenerf_torch.data.preprocessor import ScenePreprocessor
from simplenerf_torch.data.synthetic import generate_scene
from simplenerf_torch.drivers import presets, runner
from simplenerf_torch.render import renderer
from simplenerf_torch.training import checkpoints, tester

H, W = 24, 32


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A scene, a train run dir with a JAX checkpoint, and both testers."""
    root = tmp_path_factory.mktemp("serve")
    db = root / "db"
    jgenerate(db, num_frames=5, h=H, w=W, num_train=3, seed=3)
    cfg = jpresets.tiny_synthetic_config(compute_dtype="float32")
    run_dir = root / "runs/training/train0000"
    jconfig.save_configs(run_dir, cfg)
    raw = jget_loader(cfg, db, "train").load_data()
    mc = JPreprocessor(cfg, "train", raw).get_model_configs()
    (run_dir / "blobs").mkdir(parents=True)
    (run_dir / "blobs/ModelConfigs.json").write_text(json.dumps(mc, indent=2))
    rcfg = jconfig.render_config_from_dict(cfg)
    params = jrenderer.init(jax.random.PRNGKey(5), rcfg)
    opt_state = optax.adam(1e-3).init(params)
    jckpt.save_checkpoint(run_dir / "blobs/saved_models", 7, params, opt_state)
    return dict(root=root, db=db, cfg=cfg, run_dir=run_dir, mc=mc, params=params, raw=raw)


def test_synthetic_scene_and_loader_match_jax(served, tmp_path):
    gt = generate_scene(tmp_path / "db", num_frames=5, h=H, w=W, num_train=3, seed=3)
    cfg = served["cfg"]
    for mode in ("train", "test"):
        mine = get_data_loader(cfg, tmp_path / "db", mode).load_data()
        theirs = jget_loader(cfg, served["db"], mode).load_data()
        np.testing.assert_array_equal(mine["frame_nums"], theirs["frame_nums"])
        for k in ("images", "extrinsics", "intrinsics", "bounds"):
            np.testing.assert_array_equal(mine["nerf_data"][k], theirs["nerf_data"][k], err_msg=k)
    sparse = get_data_loader(cfg, tmp_path / "db", "train").load_sparse_depth_data(gt["train_frames"][:1])
    theirs = served["raw"]["sparse_depth_data"][int(gt["train_frames"][0])]
    # pandas' fast float parser is not round-trip exact (a few ulp).
    for k in ("x", "y", "depth", "reprojection_error", "weight"):
        np.testing.assert_allclose(next(iter(sparse.values()))[k], theirs[k].to_numpy(),
                                   rtol=1e-13, atol=1e-15, err_msg=k)


def test_model_configs_match_jax(served):
    raw = get_data_loader(served["cfg"], served["db"], "train").load_data()
    mine = ScenePreprocessor(served["cfg"], "train", raw, device="cpu").get_model_configs()
    assert json.loads(json.dumps(mine)) == json.loads(json.dumps(served["mc"]))


def test_create_test_data_matches_jax(served):
    cfg, mc = served["cfg"], served["mc"]
    raw = served["raw"]["nerf_data"]
    secondary = list(raw["extrinsics"][:2])
    want = JPreprocessor(cfg, "test", model_configs=mc).create_test_data(
        raw["extrinsics"][0], secondary_poses=secondary, intrinsic=raw["intrinsics"][0]
    )
    got = ScenePreprocessor(cfg, "test", model_configs=mc, device="cpu").create_test_data(
        raw["extrinsics"][0], secondary_poses=secondary, intrinsic=raw["intrinsics"][0]
    )
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("fused", ["auto", "on"])
def test_predict_frame_matches_jax_tester(served, fused):
    """JAX-written checkpoint -> port load_scene_tester; frames agree with JAX's Tester."""
    jt = jrunner.load_scene_tester(served["run_dir"], "blobs", {})
    tt = runner.load_scene_tester(served["run_dir"], "blobs", {}, device="cpu")
    if fused == "on":  # the field through ops.fused_mlp (its plain version on CPU)
        tt.render_cfg = tt.render_cfg.__class__(**{**tt.render_cfg.__dict__, "fused_mlp": "on"})
        tt._eval_step = tester.build_eval_renderer(tt.render_cfg)
    raw = served["raw"]["nerf_data"]
    want = jt.predict_frame(raw["extrinsics"][1], intrinsic=raw["intrinsics"][1])
    got = tt.predict_frame(raw["extrinsics"][1], intrinsic=raw["intrinsics"][1])
    assert set(got) == set(want)
    assert got["image"].shape == (H, W, 3) and got["image"].dtype == np.uint8
    # uint8 images: a float32 difference can cross a rounding boundary.
    assert np.abs(got["image"].astype(int) - want["image"].astype(int)).max() <= 1
    np.testing.assert_allclose(got["depth_ndc"], want["depth_ndc"], rtol=1e-4, atol=1e-4)
    # Metric depth is NDC depth through 1/(1 - z), which magnifies float32
    # differences near the far plane; the variances weigh squared offsets of
    # the fine samples, which inverse-CDF bracket flips move
    # (test_torch_parity's 5e-3 on z_vals_fine).
    for k in ("depth", "depth_var", "depth_var_ndc"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=1e-4, err_msg=k)


def test_render_video_poses_stacks_frames(served):
    tt = runner.load_scene_tester(served["run_dir"], "blobs", {}, device="cpu")
    poses = served["raw"]["nerf_data"]["extrinsics"][1:3]
    video = tt.render_video_poses(poses)
    assert video.shape == (2, H, W, 3) and video.dtype == np.uint8
    np.testing.assert_array_equal(video[1], tt.predict_frame(poses[1])["image"])


def test_start_testing_writes_frames(served):
    out = served["root"] / "runs"
    test_cfg = {"train_num": 0, "test_num": 3}
    # Without QA, as the JAX package: no scores.
    assert runner.start_testing(test_cfg, served["db"], out, run_qa=False, device="cpu") == {}
    scene_dir = out / "testing/test0003/blobs"
    frames = sorted(int(p.stem) for p in (scene_dir / "predicted_frames").glob("*.png"))
    assert frames == [1, 3]
    for f in frames:
        img = io.read_image(scene_dir / f"predicted_frames/{f:04}.png")
        assert img.shape == (H, W, 3)
        depth = np.load(scene_dir / f"predicted_depths_ndc/{f:04}.npy")
        assert depth.shape == (H, W) and np.isfinite(depth).all()
    # Skip-if-exists: a second run renders nothing new and keeps the files;
    # with QA it scores the frames (no masks or GT depths here: the RGB
    # families) and writes QA_Scores.json, the skipped families named.
    stamp = (scene_dir / "predicted_frames/0001.png").stat().st_mtime_ns
    scores = runner.start_testing(test_cfg, served["db"], out, run_qa=True, device="cpu")
    assert (scene_dir / "predicted_frames/0001.png").stat().st_mtime_ns == stamp
    assert set(scores) == {"RMSE", "PSNR", "SSIM"}
    assert all(np.isfinite(v) for v in scores.values())
    saved = json.loads((out / "testing/test0003/QA_Scores.json").read_text())
    assert {k: saved[k] for k in scores} == scores
    assert len(saved["skipped"]) == 14 - len(scores)
    assert (out / "testing/test0003/QA_Scores/PSNR_FrameWise.csv").exists()


def test_port_checkpoint_loads_in_jax(served, tmp_path):
    rcfg = config.render_config_from_dict(served["cfg"])
    params = renderer.init(torch.Generator().manual_seed(2), rcfg)
    checkpoints.save_checkpoint(tmp_path, 12, params)
    assert checkpoints.latest_checkpoint(tmp_path).name == "Model_Latest.msgpack"
    jtarget = jrenderer.init(jax.random.PRNGKey(0), jconfig.render_config_from_dict(served["cfg"]))
    it, jparams, _ = jckpt.load_checkpoint(tmp_path / "Model_Latest.msgpack", jtarget)
    assert it == 12
    flat_j = jax.tree_util.tree_leaves(jparams)
    flat_t = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), params))
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a), b)
    # And back: the port reads its own file, and refuses another architecture.
    it2, again, _ = checkpoints.load_checkpoint(tmp_path / "Model_Latest.msgpack", params)
    assert it2 == 12 and torch.equal(again["fine"]["pts"][0]["w"], params["fine"]["pts"][0]["w"])
    small = renderer.init(torch.Generator(), config.render_config_from_dict(
        presets.tiny_synthetic_config(mlp_width=32)))
    with pytest.raises(ValueError):
        checkpoints.load_checkpoint(tmp_path / "Model_Latest.msgpack", small)
