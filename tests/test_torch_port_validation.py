"""The port's validation renders, trace window and logger against the JAX package.

- the "validation" mode of the preprocessor: the validation frames' poses,
  bounds, near/far and ray cache, normalized by the train scene's digest;
- `Trainer.run_validation` from one shared initialization (the port through
  the kernels' plain versions, `fused_mlp="on"`): the same files under
  samples/, frames within one 8-bit step, depths, variances and loss maps
  at 1e-4 (of their scale, where it passes 1), the validation scalars at
  1e-4 relative;
- a `profiling` window writes a torch.profiler trace with the port's spans,
  and the step body's device ms at the next log;
- the logger's TensorBoard events and plots.

Tolerances: both sides run the same float32 arithmetic in another order
(tests/test_torch_port_serving.py).
"""

import copy
import json
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from simplenerf_tpu.data import get_data_loader as jget_loader
from simplenerf_tpu.data import preprocessor as jpre
from simplenerf_tpu.data.synthetic import generate_scene
from simplenerf_tpu.drivers.presets import tiny_synthetic_config
from simplenerf_tpu.training import trainer as jtrainer
from simplenerf_torch import convert
from simplenerf_torch.data import io
from simplenerf_torch.data import preprocessor as pre
from simplenerf_torch.data.factory import get_data_loader
from simplenerf_torch.training import trainer
from simplenerf_torch.training.logger import TrainLogger

H, W = 24, 32


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("db")
    generate_scene(root, num_frames=6, h=H, w=W, num_train=3, seed=3)
    cfg = tiny_synthetic_config(num_rays=64, sparse_depth_rays=32, consistency_start_iter=1)
    cfg["resume_training"] = False
    cfg["validation_save_loss_maps"] = True
    raw = {m: jget_loader(cfg, root, m).load_data() for m in ("train", "validation")}
    jtrain = jpre.ScenePreprocessor(cfg, "train", raw["train"], seed=0)
    jval = jpre.ScenePreprocessor(cfg, "validation", raw["validation"],
                                  model_configs=jtrain.get_model_configs())
    return dict(root=root, cfg=cfg, jtrain=jtrain, jval=jval)


def _port_pps(scene, cfg):
    root = scene["root"]
    train = pre.ScenePreprocessor(cfg, "train", get_data_loader(cfg, root, "train").load_data(),
                                  device="cpu", seed=0)
    val = pre.ScenePreprocessor(cfg, "validation",
                                get_data_loader(cfg, root, "validation").load_data(),
                                model_configs=train.get_model_configs(), device="cpu")
    return train, val


def test_validation_preprocessor_matches_jax(scene):
    _, val = _port_pps(scene, scene["cfg"])
    want = scene["jval"]
    np.testing.assert_array_equal(val.frame_nums, want.frame_nums)
    assert val.frame_nums.size == 1 and val.resolution == want.resolution == (H, W)
    np.testing.assert_allclose(val.poses, want.poses, rtol=0, atol=1e-6)
    np.testing.assert_allclose(val.bounds, want.bounds, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose([val.near, val.far], [want.near, want.far], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(val.images, want.images)
    assert json.loads(json.dumps(val.model_configs)) == \
        json.loads(json.dumps(scene["jtrain"].get_model_configs()))
    assert set(val.cache) == set(want.cache)  # no packed copy in validation mode
    for k, v in want.cache.items():
        np.testing.assert_allclose(val.cache[k].numpy(), np.asarray(v), rtol=0, atol=1e-6, err_msg=k)
    for a, b in zip(val.next_indices(0, image_num=int(val.frame_nums[0])),
                    want.next_indices(0, image_num=int(want.frame_nums[0]))):
        np.testing.assert_array_equal(a, b)


def test_test_rays_of_a_train_pose_equal_its_cached_rays(scene):
    """A validation render and the Tester's render of the same pose see the
    same rays, to the bit (the NDC projection takes float32 focals in both)."""
    train, _ = _port_pps(scene, scene["cfg"])
    raw = get_data_loader(scene["cfg"], scene["root"], "train").load_data()["nerf_data"]
    test_pp = pre.ScenePreprocessor(scene["cfg"], "test", model_configs=train.get_model_configs(),
                                    device="cpu")
    for i, frame in enumerate(train.frame_nums):
        idx, mask, _ = train.next_indices(0, image_num=int(frame))
        cached = pre.gather_batch(train.cache, train.common, train.batch_constants(),
                                  torch.as_tensor(idx), torch.as_tensor(mask), None)
        test = test_pp.create_test_data(raw["extrinsics"][i], intrinsic=raw["intrinsics"][i])
        for k, v in test.items():
            assert torch.equal(v, cached[k]), (int(frame), k)


def test_validation_needs_model_configs(scene):
    raw = get_data_loader(scene["cfg"], scene["root"], "validation").load_data()
    with pytest.raises(ValueError, match="model_configs"):
        pre.ScenePreprocessor(scene["cfg"], "validation", raw, device="cpu")
    with pytest.raises(ValueError, match="unknown preprocessor mode"):
        pre.ScenePreprocessor(scene["cfg"], "eval", raw, device="cpu")


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _validation_rows(log_dir):
    rows = [json.loads(line) for line in (log_dir / "scalars.jsonl").read_text().splitlines()]
    return {k: v for r in rows for k, v in r.items() if k.startswith("validation/")}


def test_run_validation_matches_jax(scene, tmp_path):
    cfg = scene["cfg"]
    jt = jtrainer.Trainer(cfg, tmp_path / "jax", scene["jtrain"], val_pp=scene["jval"])
    jt.run_validation(10)

    pcfg = copy.deepcopy(cfg)
    pcfg["model"]["fused_mlp"] = "on"  # the kernels' plain versions
    train, val = _port_pps(scene, pcfg)
    t = trainer.Trainer(pcfg, tmp_path / "port", train, val_pp=val)
    t.set_params(convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jt.params)))
    t.run_validation(10)
    t.logger.close()

    mine, theirs = tmp_path / "port/samples", tmp_path / "jax/samples"
    files = _files(theirs)
    assert _files(mine) == files
    frames = [f for f in files if f.startswith("predicted_frames/")]
    maps = [f for f in files if f.startswith("Losses/") and f.endswith(".npy")]
    assert len(frames) == 2 * 4 and len(maps) >= 4 * 4  # 3 train + 1 validation frames
    for f in files:
        if f.endswith(".png"):
            a, b = io.read_image(mine / f).astype(int), io.read_image(theirs / f).astype(int)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, f
        else:
            a, b = np.load(mine / f), np.load(theirs / f)
            assert a.shape == (H, W), f
            # 1e-4 in units of the array's largest value where that is past
            # 1: metric depths are NDC depths through 1/(1 - z) (to ~15 here)
            # and the consistency maps square their differences (to ~130),
            # which magnifies float32 order differences alike (measured:
            # 7.9e-4 on depths up to 13, 3.0e-3 on a map up to 79).
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * max(1.0, np.abs(b).max()),
                                       err_msg=f)

    got, want = _validation_rows(tmp_path / "port/logs"), _validation_rows(tmp_path / "jax/logs")
    assert set(got) == set(want)
    for tag in ("train_images", "val_images"):
        assert f"validation/{tag}/psnr" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7, err_msg=k)


def test_profiling_window_writes_trace_and_timing(tmp_path):
    from simplenerf_torch.data.synthetic import generate_scene as port_scene
    from simplenerf_torch.drivers import presets

    port_scene(tmp_path / "db", num_frames=4, h=16, w=24, num_train=3, seed=0)
    cfg = presets.tiny_synthetic_config(num_rays=8, sparse_depth_rays=8, num_samples_coarse=4,
                                        num_samples_fine=8, num_iterations=6)
    cfg["profiling"] = {"start_iter": 2, "num_iters": 2}
    cfg["log_interval"] = 3
    cfg["model_save_interval"] = 6
    raw = get_data_loader(cfg, tmp_path / "db", "train").load_data()
    t = trainer.Trainer(cfg, tmp_path / "run", pre.ScenePreprocessor(cfg, "train", raw, device="cpu"))
    t.train()
    t.logger.close()
    traces = list((tmp_path / "run/profile").glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    spans = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    steps = ("step.forward", "step.losses", "step.backward", "step.adam")
    for name in ("train.stage", "train.stage.indices", "train.stage.draws") + steps:
        assert spans.count(name) == 2, name  # the window's two steps
    rows = [json.loads(r) for r in (tmp_path / "run/logs/scalars.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in rows] == [3, 6]
    # The traced steps 2 and 3 are logged at 3 and at 6.
    assert all(r[f"device_ms/{n}"] > 0 for r in rows for n in steps)


def test_logger_writes_tensorboard_events_and_plots(tmp_path):
    pytest.importorskip("tensorboard")
    pytest.importorskip("matplotlib")
    logger = TrainLogger(tmp_path / "logs")
    for it in (10, 20):
        logger.log_scalars(it, {"MSE01": 1.0 / it, "validation/train_images/psnr": it / 2})
    logger.close()
    assert list((tmp_path / "logs").glob("events.out.tfevents.*"))
    logger.save_plots()
    pngs = sorted(p.name for p in (tmp_path / "logs/plots").glob("*.png"))
    assert pngs == ["MSE01.png", "validation_train_images_psnr.png"]
    assert io.read_image(tmp_path / "logs/plots/MSE01.png").ndim == 3


def test_save_plots_without_matplotlib_skips_with_a_line(tmp_path, monkeypatch, capsys):
    logger = TrainLogger(tmp_path / "logs")
    logger.log_scalars(1, {"MSE01": 0.5})
    logger.close()
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    logger.save_plots()
    assert "matplotlib is not installed" in capsys.readouterr().out
    assert not (tmp_path / "logs/plots").exists()
