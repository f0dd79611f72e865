"""The port's dense-depth and visibility losses, prior data and prior tools
against the JAX package.

- DenseDepthMSE01, VisibilityLoss01 and VisibilityPriorLoss01 and their
  loss maps on seeded random planes (atol 1e-6);
- the train cache and a gathered batch with dense depth, the visibility
  prior (masks and weights) and mip-NeRF radii on, on the 24x32 synthetic
  scene with written prior files;
- area downsampling by a ratio that does not divide the image (factor 3:
  24x32 -> 8x10, factor 5: -> 4x6) against the JAX package's OpenCV
  INTER_AREA, with the intrinsics (atol 1e-5);
- three float32 training steps with visibility heads and the three losses
  (see `test_three_visibility_steps_match_jax` for what is held), and a
  validation round with them;
- the split creators, COLMAP text-model parsing and depth math, the COLMAP
  workspace and its missing-binary error, and the dataset extractors on
  COLMAP binaries and an RE10K camera file the test writes.
"""

import copy
import json
import shutil
import struct

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from simplenerf_tpu.data import get_data_loader as jget_data_loader
from simplenerf_tpu.data import preprocessor as jpre
from simplenerf_tpu.dataset_tools import extractors as jextractors
from simplenerf_tpu.dataset_tools import splits as jsplits
from simplenerf_tpu.losses import depth_supervision as jdepth
from simplenerf_tpu.losses import visibility as jvisibility
from simplenerf_tpu.priors import colmap as jcolmap
from simplenerf_tpu.render import renderer as jrenderer
from simplenerf_tpu.training import trainer as jtrainer
from simplenerf_torch import convert
from simplenerf_torch.data import io
from simplenerf_torch.data import preprocessor as pre
from simplenerf_torch.data.factory import get_data_loader
from simplenerf_torch.data.synthetic import generate_scene, write_scene_priors
from simplenerf_torch.dataset_tools import extractors, splits
from simplenerf_torch.drivers import presets
from simplenerf_torch.losses import depth_supervision, visibility
from simplenerf_torch.priors import colmap
from simplenerf_torch.training import trainer

H, W = 24, 32


# ------------------------------------------------------------------ losses


def _planes(seed: int, nr: int = 40, ns: int = 7, k: int = 3):
    rng = np.random.default_rng(seed)
    outputs = {}
    for level in ("coarse", "fine"):
        outputs[f"depth_{level}"] = rng.uniform(0.5, 4.0, nr).astype(np.float32)
        outputs[f"raw_visibility_{level}"] = rng.random((nr, ns)).astype(np.float32)
        outputs[f"visibility_{level}"] = rng.random((nr, ns)).astype(np.float32)
        outputs[f"visibility2_{level}"] = rng.random((nr, k)).astype(np.float32)
    batch = {
        "indices_mask_nerf": rng.random(nr) > 0.3,
        "dense_depth_values": rng.uniform(0.5, 4.0, (nr, 1)).astype(np.float32),
        "visibility_prior_masks": (rng.random((nr, k)) > 0.5).astype(np.float32),
        "visibility_prior_weights": rng.random((nr, k)).astype(np.float32),
    }
    return batch, outputs


PRIOR_KEYS = {"masks": ("visibility_prior_weights",), "weights": ("visibility_prior_masks",),
              "ones": ("visibility_prior_masks", "visibility_prior_weights")}


@pytest.mark.parametrize("name,drop", [
    ("DenseDepthMSE01", ()),
    ("VisibilityLoss01", ()),
    ("VisibilityPriorLoss01", PRIOR_KEYS["masks"]),
    ("VisibilityPriorLoss01", PRIOR_KEYS["weights"]),
    ("VisibilityPriorLoss01", PRIOR_KEYS["ones"]),
], ids=["dense", "visibility", "prior-masks", "prior-weights", "prior-ones"])
def test_losses_and_maps_match_jax(name, drop):
    batch, outputs = _planes(seed=len(name) + len(drop))
    for key in drop:
        del batch[key]
    make = {"DenseDepthMSE01": (depth_supervision.make_dense_depth_loss, jdepth.make_dense_depth_loss),
            "VisibilityLoss01": (visibility.make_visibility_loss, jvisibility.make_visibility_loss),
            "VisibilityPriorLoss01": (visibility.make_visibility_prior_loss,
                                      jvisibility.make_visibility_prior_loss)}[name]
    got, got_maps = make[0]()({k: torch.as_tensor(v) for k, v in batch.items()},
                              {k: torch.as_tensor(v) for k, v in outputs.items()}, return_maps=True)
    want, want_maps = make[1]()({k: jnp.asarray(v) for k, v in batch.items()},
                                {k: jnp.asarray(v) for k, v in outputs.items()}, return_maps=True)
    assert float(want) > 0
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)
    assert set(got_maps) == set(want_maps) == {f"{name}_coarse", f"{name}_fine"}
    for key, m in want_maps.items():
        assert got_maps[key].shape == (40,)
        np.testing.assert_allclose(got_maps[key].numpy(), np.asarray(m), rtol=0, atol=1e-6)
    # Without its inputs each loss is 0 on both sides.
    empty = {"indices_mask_nerf": batch["indices_mask_nerf"]}
    assert float(make[0]()({k: torch.as_tensor(v) for k, v in empty.items()},
                           {"depth_coarse": torch.zeros(40)})) == 0.0


# ------------------------------------------------------- prior data + cache


@pytest.fixture(scope="module")
def prior_scene(tmp_path_factory):
    """The 24x32 synthetic scene with dense-depth, visibility-mask and
    visibility-weight priors for its train frames."""
    root = tmp_path_factory.mktemp("priors_db")
    gt = generate_scene(root, num_frames=5, h=H, w=W, num_train=3, seed=3)
    write_scene_priors(root, "blobs", gt["train_frames"], gt["images"], gt["depths"],
                       gt["extrinsics"], gt["intrinsic"])
    rng = np.random.default_rng(11)
    wdir = root / "all/visibility_prior/VW01/blobs/visibility_weights"
    wdir.mkdir(parents=True)
    for f1 in gt["train_frames"]:
        for f2 in gt["train_frames"]:
            if f1 != f2:
                np.save(wdir / f"{f1:04}_{f2:04}.npy", rng.random((H, W)).astype(np.float32))
    return root, gt


def _prior_config(load_weights: bool = False):
    cfg = presets.tiny_synthetic_config(num_rays=64, sparse_depth_rays=32, consistency_start_iter=1,
                                        raw_noise_std=0.0)
    cfg["model"]["perturb"] = False
    cfg["resume_training"] = False
    cfg = presets.with_visibility_priors(cfg)
    if load_weights:
        cfg["data_loader"]["visibility_prior"].update(load_weights=True, weights_dirname="VW01")
    return cfg


def test_prior_cache_and_batch_match_jax(prior_scene):
    root, gt = prior_scene
    cfg = _prior_config(load_weights=True)
    jpp = jpre.ScenePreprocessor(cfg, "train", jget_data_loader(cfg, root, "train").load_data(), seed=0)
    pp = pre.ScenePreprocessor(cfg, "train", get_data_loader(cfg, root, "train").load_data(),
                               device="cpu", seed=0)
    n = 3 * H * W
    for key, width in (("dense_depth_values", 1), ("dense_depth_weights", 1),
                       ("dense_depth_values_ndc", 1), ("visibility_prior_masks", 2),
                       ("visibility_prior_weights", 2), ("radii", 1), ("radii_ndc", 1)):
        assert pp.cache[key].shape == (n, width), key
    assert set(pp.cache) == set(jpp.cache)
    assert pp.packed_layout == jpp.packed_layout
    for key, want in jpp.cache.items():
        np.testing.assert_allclose(pp.cache[key].numpy(), np.asarray(want), rtol=0, atol=1e-5,
                                   err_msg=key)
    # The metric dense depths are the written depths in the normalized frame.
    np.testing.assert_allclose(pp.cache["dense_depth_values"].numpy().reshape(3, H, W),
                               gt["depths"][gt["train_frames"]] * pp.sc, rtol=1e-6)
    assert (pp.cache["visibility_prior_masks"].numpy() == 0).any()
    assert (pp.cache["visibility_prior_masks"].numpy() == 1).any()

    indices, m_nerf, m_sd = pp.next_indices(0)
    jindices, jm_nerf, jm_sd = jpp.next_indices(0)
    np.testing.assert_array_equal(indices, jindices)
    t = torch.as_tensor
    batch = pre.gather_batch(pp.cache, pp.common, pp.batch_constants(), t(indices), t(m_nerf),
                             t(m_sd), packed_layout=pp.packed_layout)
    jbatch = jpre.gather_batch(jpp.cache, jpp.common, jpp.batch_constants(), jnp.asarray(jindices),
                               jnp.asarray(jm_nerf), jnp.asarray(jm_sd),
                               packed_layout=jpp.packed_layout)
    assert set(batch) == set(jbatch)
    for key, want in jbatch.items():
        if key != "common":
            np.testing.assert_allclose(np.asarray(batch[key]), np.asarray(want), rtol=0, atol=1e-5,
                                       err_msg=key)
    # Radii on the NeRF rays, the -1 fill on the sparse-depth rows.
    radii = batch["radii"].numpy()[:, 0]
    assert (radii[m_nerf] > 0).all() and (radii[m_sd] == -1).all()
    # Test batches carry both radii keys, as the JAX package's do (the
    # reference's test batches only 'radii_ndc'; docs/PARITY.md).
    mc = pp.get_model_configs()
    pose = get_data_loader(cfg, root, "train").load_data()["nerf_data"]["extrinsics"][0]
    tb = pre.ScenePreprocessor(cfg, "test", model_configs=mc, device="cpu").create_test_data(pose)
    jtb = jpre.ScenePreprocessor(cfg, "test", model_configs=jpp.get_model_configs()).create_test_data(pose)
    for key in ("radii", "radii_ndc"):
        assert tb[key].shape == (H * W, 1)
        np.testing.assert_allclose(tb[key].numpy(), np.asarray(jtb[key]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tb[key].numpy(), pp.cache[key].numpy()[: H * W], rtol=0, atol=1e-5)


@pytest.mark.parametrize("factor,size", [(3, (8, 10)), (5, (4, 6))])
def test_area_downsampling_matches_opencv(prior_scene, factor, size):
    root, _ = prior_scene
    cfg = presets.tiny_synthetic_config()
    cfg["data_loader"]["downsampling_factor"] = factor
    cfg["data_loader"].pop("sparse_depth")
    jpp = jpre.ScenePreprocessor(cfg, "train", jget_data_loader(cfg, root, "train").load_data(), seed=0)
    pp = pre.ScenePreprocessor(cfg, "train", get_data_loader(cfg, root, "train").load_data(),
                               device="cpu", seed=0)
    assert pp.resolution == jpp.resolution == size
    np.testing.assert_allclose(pp.images, jpp.images, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pp.intrinsics, jpp.intrinsics, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pp.cache["target_rgb"].numpy(), np.asarray(jpp.cache["target_rgb"]),
                               rtol=0, atol=1e-5)


# ------------------------------------------------------ three train steps

STEPS = 3


def _jax_grads(jt, params, batch, it):
    w = jnp.asarray(jt.loss_computer.weights_vector(it))
    key = jax.random.fold_in(jt.base_key, it)

    def loss_fn(p):
        out = jrenderer.render_rays(p, jt.render_cfg, batch, key, train=True)
        return jt.loss_computer.compute(batch, out, w)[0]

    return np.asarray(jax.flatten_util.ravel_pytree(jax.grad(loss_fn)(params))[0])


@pytest.fixture(scope="module")
def jax_priors_run(prior_scene):
    """The JAX Trainer's three steps with visibility heads and the prior
    losses: its initial params, each step's params and gradient (at those
    params), loss values and the final Adam moments."""
    root, _ = prior_scene
    cfg = _prior_config()
    jpp = jpre.ScenePreprocessor(cfg, "train", jget_data_loader(cfg, root, "train").load_data(), seed=0)
    jt = jtrainer.Trainer(cfg, root.parent / "jax_priors_run", jpp)
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(jt.params))
    shadow = jpre.ScenePreprocessor(cfg, "train", jget_data_loader(cfg, root, "train").load_data(),
                                    seed=0)  # the same index stream, for the batches
    steps = []
    for it in range(STEPS):
        params = jax.device_get(jt.params)
        idx, m_nerf, m_sd = shadow.next_indices(it)
        batch = jpre.gather_batch(shadow.cache, shadow.common, shadow.batch_constants(),
                                  jnp.asarray(idx), jnp.asarray(m_nerf), jnp.asarray(m_sd),
                                  packed_layout=shadow.packed_layout)
        grad = _jax_grads(jt, params, batch, it)
        values = {k: float(v) for k, v in jt.train_one_iter(it).items()}
        steps.append({"params": jax.tree_util.tree_map(np.asarray, params), "grad": grad,
                      "values": values})
    adam = jax.device_get(jt.opt_state)[0]
    return dict(cfg=cfg, init=init, steps=steps, mu=np.asarray(adam.mu), nu=np.asarray(adam.nu))


@pytest.mark.parametrize("fused", ["auto", "on"], ids=["unfused", "kernel-plain-versions"])
def test_three_visibility_steps_match_jax(prior_scene, jax_priors_run, tmp_path, fused):
    """Three float32 steps with a visibility head on the coarse and fine
    main MLPs, DenseDepthMSE01, VisibilityLoss01 and VisibilityPriorLoss01,
    from the JAX Trainer's initialization.

    Held: each step's gradient at the JAX run's parameters of that step
    (1e-5 of the largest; reads 2.1e-6 to 2.4e-6, float32 summation
    order), each step's loss values (rtol 1e-3: the third step's inputs
    already carry the first two updates' rounding) and the Adam moments
    after three steps at the tolerances of test_three_train_steps_match_jax.
    Its parameter check (atol 1e-4) is not held here: DenseDepthMSE01's
    gradients reach ~184 through the NDC -> metric depth pole, so float32
    noise of ~5e-4 lands on weights whose gradients are ~1e-5, and Adam's
    normalization turns that into parameter differences of up to 9.5e-4 on
    25 of the 47,282 parameters (readings: tools/priors_parity.py). VisibilityPriorLoss01 is 0 in every step on both sides:
    the train step renders no secondary views."""
    root, _ = prior_scene
    run = jax_priors_run
    cfg = copy.deepcopy(run["cfg"])
    cfg["model"]["fused_mlp"] = fused

    def port_trainer(out):
        raw = get_data_loader(cfg, root, "train").load_data()
        return trainer.Trainer(cfg, out, pre.ScenePreprocessor(cfg, "train", raw, device="cpu", seed=0))

    # The gradient of each step at the JAX run's parameters of that step.
    g = port_trainer(tmp_path / "grads")
    for it, want in enumerate(run["steps"]):
        idx = g.train_pp.next_indices(it)
        g.set_params(convert.params_from_numpy(want["params"]))
        total, _ = g.loss(g.batch(*idx), it, generator=g.step_generator(it))
        total.backward()
        grad = np.concatenate([p.grad.numpy().reshape(-1) for p in g.leaves])
        np.testing.assert_allclose(grad, want["grad"], rtol=0,
                                   atol=1e-5 * np.abs(want["grad"]).max(), err_msg=f"step {it}")

    # Three free-running steps from the JAX run's initialization.
    t = port_trainer(tmp_path / "run")
    t.set_params(convert.params_from_numpy(run["init"]))
    for it, want in enumerate(run["steps"]):
        values = {k: float(v) for k, v in t.train_one_iter(it).items()}
        assert set(values) == set(want["values"])
        assert values["VisibilityPriorLoss01"] == want["values"]["VisibilityPriorLoss01"] == 0.0
        assert values["DenseDepthMSE01"] > 0 and values["VisibilityLoss01"] > 0
        for k, v in want["values"].items():
            np.testing.assert_allclose(values[k], v, rtol=1e-3, atol=1e-6, err_msg=f"{k} step {it}")
    mu, nu = run["mu"], run["nu"]
    np.testing.assert_allclose(t.opt_state["mu"].numpy(), mu, rtol=1e-3, atol=1e-3 * np.abs(mu).max())
    np.testing.assert_allclose(t.opt_state["nu"].numpy(), nu, rtol=1e-2, atol=1e-2 * np.abs(nu).max())
    assert t.opt_state["count"] == STEPS


def test_validation_with_visibility_heads_matches_jax(prior_scene, tmp_path):
    """`run_validation` with visibility heads and the prior losses, the
    JAX Trainer's and the port's (the kernels' plain versions) from one
    initialization: the same files (loss maps of DenseDepthMSE01 among
    them) and the validation scalars at 1e-4 relative. Validation batches
    come from the ray cache, which holds no secondary-view origins, so
    neither package renders visibility2 there: VisibilityPriorLoss01 is 0
    and no predicted_visibilities are written, on both sides."""
    root, _ = prior_scene
    cfg = _prior_config()
    cfg["validation_save_loss_maps"] = True
    jpp = jpre.ScenePreprocessor(cfg, "train", jget_data_loader(cfg, root, "train").load_data(), seed=0)
    jt = jtrainer.Trainer(cfg, tmp_path / "jax", jpp)
    jt.run_validation(3)
    cfg["model"]["fused_mlp"] = "on"
    raw = get_data_loader(cfg, root, "train").load_data()
    t = trainer.Trainer(cfg, tmp_path / "port", pre.ScenePreprocessor(cfg, "train", raw, device="cpu"))
    t.set_params(convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jt.params)))
    t.run_validation(3)
    t.logger.close()

    def files(d):
        return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())

    mine, theirs = tmp_path / "port/samples", tmp_path / "jax/samples"
    assert files(mine) == files(theirs)
    assert not any("predicted_visibilities" in f for f in files(mine))
    dense = [f for f in files(theirs) if f.startswith("Losses/DenseDepthMSE01") and f.endswith(".npy")]
    assert len(dense) == 2 * 3
    for f in dense:
        # The maps are squared metric-depth errors: held as |depth - target|,
        # at the validation test's 1e-4 of the scale on metric depths.
        want = np.sqrt(np.load(theirs / f))
        np.testing.assert_allclose(np.sqrt(np.load(mine / f)), want, rtol=0,
                                   atol=1e-4 * max(1.0, want.max()), err_msg=f)

    def rows(d):
        lines = (d / "logs/scalars.jsonl").read_text().splitlines()
        return {k: v for r in map(json.loads, lines) for k, v in r.items() if k.startswith("validation/")}

    got, want = rows(tmp_path / "port"), rows(tmp_path / "jax")
    assert set(got) == set(want)
    assert got["validation/train_images/VisibilityPriorLoss01"] == \
        want["validation/train_images/VisibilityPriorLoss01"] == 0.0
    assert want["validation/train_images/DenseDepthMSE01"] > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7, err_msg=k)


# ------------------------------------------------------------------ splits


def test_splits_match_jax(tmp_path):
    for args in ((range(20), 3), (range(0, 40, 2), 4), (range(9), -1)):
        np.testing.assert_array_equal(splits.sample_sparse_train_frames(*args),
                                      jsplits.sample_sparse_train_frames(*args))
    for got, want in zip(splits.llff_split(list(range(34)), 3), jsplits.llff_split(list(range(34)), 3)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(splits.realestate_split(50, 4), jsplits.realestate_split(50, 4)):
        np.testing.assert_array_equal(got, want)
    for name, n in (("a", 17), ("b", 25)):
        d = tmp_path / f"all/database_data/{name}/rgb_down4"
        d.mkdir(parents=True)
        for f in range(n):
            (d / f"{f:04}.png").write_bytes(b"")
    for num in (1, 2, 3):
        (tmp_path / f"test/database_data/{num:05}").mkdir(parents=True)
    splits.create_llff_train_test_set(tmp_path, 2, 3)
    splits.create_realestate_train_test_set(tmp_path, 3, 2)
    jsplits.create_llff_train_test_set(tmp_path, 12, 3)
    jsplits.create_realestate_train_test_set(tmp_path, 13, 2)
    for mine, theirs in ((2, 12), (3, 13)):
        for name in ("Train", "Validation", "Test"):
            got = io.read_csv(tmp_path / f"train_test_sets/set{mine:02}/{name}VideosData.csv")
            want = io.read_csv(tmp_path / f"train_test_sets/set{theirs:02}/{name}VideosData.csv")
            assert got == want and len(got["pred_frame_num"]) > 0


# ------------------------------------------------------------ COLMAP priors


def _colmap_text_model(tmp_path):
    """The two-camera, five-point text model of tests/test_pipeline.py's
    TestColmapPriors."""
    w2c, w2c2 = np.eye(4), np.eye(4)
    w2c2[:3, 3] = [0.5, 0, 0]
    depths = [3.0, 3.5, 4.0, 4.5, 5.0]
    pts = np.array([[0.1 * i, -0.05 * i, d] for i, d in enumerate(depths)])

    def img_line(iid, pose, name, xys_ids):
        q = jcolmap.quaternion_wxyz(pose[:3, :3])
        obs = " ".join(f"{x} {y} {pid}" for (x, y), pid in xys_ids)
        return f"{iid} {' '.join(map(str, q))} {' '.join(map(str, pose[:3, 3]))} 1 {name}\n{obs}\n"

    images_txt = tmp_path / "images.txt"
    images_txt.write_text(img_line(1, w2c, "0000.png", [((10 + i, 12), i + 1) for i in range(5)])
                          + img_line(2, w2c2, "0001.png", [((11 + i, 12), i + 1) for i in range(5)]))
    points_txt = tmp_path / "points3D.txt"
    points_txt.write_text("\n".join(
        f"{pid} {p[0]} {p[1]} {p[2]} 200 200 200 {0.3 * pid} 1 {pid - 1} 2 {pid - 1}"
        for pid, p in enumerate(pts, start=1)))
    return points_txt, images_txt


def test_colmap_parsing_and_depths_match_jax(tmp_path):
    points_txt, images_txt = _colmap_text_model(tmp_path)
    points, jpoints = colmap.read_points3d_txt(points_txt), jcolmap.read_points3d_txt(points_txt)
    assert set(points) == set(jpoints) == {1, 2, 3, 4, 5}
    for pid, (xyz, err, ids) in jpoints.items():
        np.testing.assert_array_equal(points[pid][0], xyz)
        assert points[pid][1] == err
        np.testing.assert_array_equal(points[pid][2], ids)
    images, jimages = colmap.read_images_txt(images_txt), jcolmap.read_images_txt(images_txt)
    for iid, (name, w2c, xys, ids) in jimages.items():
        assert images[iid][0] == name
        np.testing.assert_allclose(images[iid][1], w2c, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(images[iid][2], xys)
        np.testing.assert_array_equal(images[iid][3], ids)
    frames, bounds = colmap.depths_and_weights(points, images)
    jframes, jbounds = jcolmap.depths_and_weights(jpoints, jimages)
    assert set(frames) == set(jframes) == {1, 2}
    for iid, df in jframes.items():
        assert list(frames[iid]) == list(df.columns)
        for col in df.columns:
            np.testing.assert_allclose(frames[iid][col], df[col].to_numpy(), rtol=0, atol=1e-12)
        assert len(df) == 3  # the percentile bounds drop the two extremes
    for col in ("near", "far"):
        np.testing.assert_allclose(bounds[col], jbounds[col].to_numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(colmap.quaternion_wxyz(images[2][1][:3, :3]),
                               jcolmap.quaternion_wxyz(jimages[2][1][:3, :3]), atol=1e-12)
    assert colmap.depths_and_weights({}, images) == (None, None)


def test_colmap_workspace_and_missing_binary(tmp_path, monkeypatch):
    images = np.random.default_rng(0).integers(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    K = np.array([[10.0, 0, 4], [0, 10.0, 4], [0, 0, 1]])
    poses = np.stack([np.eye(4), np.eye(4)])
    poses[1, :3, 3] = [0.2, 0, 0]
    ids = {"0000.png": 1, "0001.png": 2}
    for est in (colmap.ColmapSparseDepthEstimator(tmp_path / "ws"),
                jcolmap.ColmapSparseDepthEstimator(tmp_path / "jws")):
        est.prepare_workspace(images, np.stack([K, K]))
        est.write_known_poses(poses, ids)
    for rel in ("sparse/cameras.txt", "sparse/images.txt", "sparse/points3D.txt"):
        assert (tmp_path / "ws" / rel).read_text() == (tmp_path / "jws" / rel).read_text()
    np.testing.assert_array_equal(io.read_image(tmp_path / "ws/images/0001.png"), images[1])
    # Without the binary on PATH both raise before running anything.
    monkeypatch.setattr(shutil, "which", lambda name: None)
    for mod in (colmap, jcolmap):
        est = mod.ColmapSparseDepthEstimator(tmp_path / "ws")
        with pytest.raises(RuntimeError, match="colmap binary not found"):
            est.run_colmap(np.eye(4)[None], np.eye(3))
    with pytest.raises(RuntimeError, match="colmap binary not found"):
        colmap.generate_scene_priors(tmp_path / "db", "s", np.arange(2), images, poses,
                                     np.stack([K, K]), workspace=tmp_path / "ws2")


# -------------------------------------------------------------- extractors


def _write_colmap_binaries(sparse, frames, names, K, w, h):
    sparse.mkdir(parents=True)
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 0, w, h))  # SIMPLE_PINHOLE: f, cx, cy
        f.write(struct.pack("<3d", K[0, 0], K[0, 2], K[1, 2]))
    rng = np.random.default_rng(4)
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(names)))
        for iid, name in zip(frames, names):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            f.write(struct.pack("<i", int(iid)))
            f.write(struct.pack("<4d", *q))
            f.write(struct.pack("<3d", *rng.normal(size=3)))
            f.write(struct.pack("<i", 1))
            f.write(name.encode() + b"\x00")
            obs = np.concatenate([rng.uniform(0, w, (4, 2)), rng.integers(-1, 9, (4, 1))], 1)
            f.write(struct.pack("<Q", len(obs)))
            f.write(struct.pack(f"<{obs.size}d", *obs.ravel()))


def test_extractors_match_jax(tmp_path):
    h, w, n = 48, 64, 3
    rng = np.random.default_rng(2)
    K = np.array([[50.0, 0, w / 2], [0, 50.0, h / 2], [0, 0, 1]])
    names = [f"IMG_{i:02}.png" for i in (2, 0, 1)]  # ids out of name order
    for side in ("port", "jax"):
        scene = tmp_path / side
        (scene / "images").mkdir(parents=True)
        src = np.random.default_rng(9)
        for i in range(n):
            io.write_image(scene / f"images/IMG_{i:02}.png",
                           src.integers(0, 256, (h, w, 3)).astype(np.uint8))
        np.save(scene / "poses_bounds.npy", np.random.default_rng(5).uniform(1, 9, (n, 17)))
        _write_colmap_binaries(scene / "sparse/0", [5, 3, 9], names, K, w, h)
    cams, jcams = (m.read_cameras_binary(tmp_path / "port/sparse/0/cameras.bin")
                   for m in (extractors, jextractors))
    assert cams.keys() == jcams.keys()
    np.testing.assert_array_equal(cams[1]["params"], jcams[1]["params"])
    ims = extractors.read_images_binary(tmp_path / "port/sparse/0/images.bin")
    jims = jextractors.read_images_binary(tmp_path / "port/sparse/0/images.bin")
    assert ims.keys() == jims.keys() == {5, 3, 9}
    for iid, im in jims.items():
        for key, v in im.items():
            np.testing.assert_array_equal(ims[iid][key], v)
        np.testing.assert_array_equal(extractors.qvec2rotmat(im["qvec"]),
                                      jextractors.qvec2rotmat(im["qvec"]))

    extractors.extract_llff_scene(tmp_path / "port")
    jextractors.extract_llff_scene(tmp_path / "jax")
    for rel in ("CameraExtrinsics.csv", "DepthBounds.csv", "CameraIntrinsics.csv",
                "CameraIntrinsics_down4.csv", "CameraIntrinsics_down8.csv"):
        assert (tmp_path / "port" / rel).read_text() == (tmp_path / "jax" / rel).read_text(), rel
    for suffix, shape in (("", (h, w, 3)), ("_down4", (12, 16, 3)), ("_down8", (6, 8, 3))):
        for f in range(n):
            got = io.read_image(tmp_path / f"port/rgb{suffix}/{f:04}.png")
            assert got.shape == shape
            np.testing.assert_array_equal(got, io.read_image(tmp_path / f"jax/rgb{suffix}/{f:04}.png"))


def test_re10k_camera_file_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(6)
    rows = ["https://www.youtube.com/watch?v=xxxxxxxxxxx"]
    for i in range(5):
        pose = np.concatenate([np.eye(3) + 0.01 * rng.normal(size=(3, 3)), rng.normal(size=(3, 1))], 1)
        rows.append(" ".join([str(1000000 + 33366 * i), "0.9", "1.6", "0.5", "0.5", "0", "0"]
                             + [repr(float(v)) for v in pose.ravel()]))
    rows.append("short line")
    path = tmp_path / "00042.txt"
    path.write_text("\n".join(rows) + "\n")
    got, want = extractors.parse_re10k_camera_file(path), jextractors.parse_re10k_camera_file(path)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[1].shape == (5, 3, 3) and got[2].shape == (5, 4, 4)
    # Frames come from the ffmpeg binary; without it the extractor says so.
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="ffmpeg binary not found"):
        extractors.extract_re10k_scene(tmp_path / "clip.mp4", path, tmp_path / "db", 42, num_frames=2)
