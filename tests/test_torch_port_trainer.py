"""The port's Trainer, checkpoints and training driver against the JAX package.

- three deterministic float32 train steps (perturb off, no sigma noise, the
  tiny synthetic preset) from one shared initialization and the same
  sampler streams: params and Adam moments allclose to the JAX Trainer's,
  once through the unfused MLP ("auto") and once through the kernels'
  plain versions ("on", the coarse trio as an ensemble);
- checkpoints with their optimizer state, both ways: a JAX checkpoint
  resumes in the port with its Adam moments, and a port checkpoint loads
  into the JAX package's `load_checkpoint` with an `opt_state` target;
- `runner.start_training` on the CPU, then `start_testing` from its
  checkpoint.

Tolerances: both sides run the same float32 arithmetic in another order.
The importance samples move with last-bit differences of the coarse
weights (tests/test_torch_port_render.py) and the consistency losses'
patch arbitration is a discrete choice per ray, so a few gradients differ
by up to a few percent: after three Adam steps (lr 5e-3) a few hundred of
the ~47k parameters differ by up to ~4e-5. Parameters are held to 1e-4
absolute (2 % of one step), the moments to 1e-3 / 1e-2 relative with
absolute floors at the same scale.
"""

import copy

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from simplenerf_tpu.data import get_data_loader as jget_data_loader
from simplenerf_tpu.data import preprocessor as jpre
from simplenerf_tpu.data.synthetic import generate_scene
from simplenerf_tpu.drivers.presets import tiny_synthetic_config
from simplenerf_tpu.training import checkpoints as jckpt
from simplenerf_tpu.training import trainer as jtrainer
from simplenerf_torch import convert
from simplenerf_torch.data import preprocessor as pre
from simplenerf_torch.data.factory import get_data_loader
from simplenerf_torch.drivers import runner
from simplenerf_torch.training import checkpoints, trainer

STEPS = 3


def _config():
    cfg = tiny_synthetic_config(num_rays=64, sparse_depth_rays=32, consistency_start_iter=1,
                                raw_noise_std=0.0)
    cfg["model"]["perturb"] = False
    cfg["resume_training"] = False
    return cfg


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Trainer's initial params, then its state after STEPS steps and
    the checkpoint it saved there."""
    root = tmp_path_factory.mktemp("db")
    generate_scene(root, num_frames=5, h=24, w=32, num_train=3, seed=3)
    cfg = _config()
    out = tmp_path_factory.mktemp("jax_run")
    jpp = jpre.ScenePreprocessor(cfg, "train", jget_data_loader(cfg, root, "train").load_data(), seed=0)
    jt = jtrainer.Trainer(cfg, out, jpp)
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(jt.params))
    for it in range(STEPS):
        jt.train_one_iter(it)
    jt.save_checkpoint(STEPS)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jt.params))
    adam = jax.device_get(jt.opt_state)[0]
    return dict(root=root, cfg=cfg, out=out, init=init, params=params, trainer=jt,
                mu=np.asarray(adam.mu), nu=np.asarray(adam.nu), count=int(adam.count))


def _port_trainer(jax_run, out, fused="auto", cfg=None):
    cfg = copy.deepcopy(cfg or jax_run["cfg"])
    cfg["model"]["fused_mlp"] = fused
    raw = get_data_loader(cfg, jax_run["root"], "train").load_data()
    return trainer.Trainer(cfg, out, pre.ScenePreprocessor(cfg, "train", raw, device="cpu", seed=0))


def _flat(tree):
    return np.concatenate([np.asarray(leaf).reshape(-1) for leaf in jax.tree_util.tree_leaves(tree)])


def _assert_state(t, jax_run):
    got = np.concatenate([p.detach().numpy().reshape(-1) for p in t.leaves])
    np.testing.assert_allclose(got, _flat(jax_run["params"]), rtol=0, atol=1e-4)
    mu, nu = jax_run["mu"], jax_run["nu"]
    np.testing.assert_allclose(t.opt_state["mu"].numpy(), mu, rtol=1e-3, atol=1e-3 * np.abs(mu).max())
    np.testing.assert_allclose(t.opt_state["nu"].numpy(), nu, rtol=1e-2, atol=1e-2 * np.abs(nu).max())
    assert t.opt_state["count"] == jax_run["count"] == STEPS


def test_flat_leaves_follow_ravel_pytree_order(jax_run):
    import jax.flatten_util

    flat, _ = jax.flatten_util.ravel_pytree(jax_run["init"])
    tparams = convert.params_from_numpy(jax_run["init"])
    got = np.concatenate([p.numpy().reshape(-1) for p in checkpoints.flat_leaves(tparams)])
    np.testing.assert_array_equal(got, np.asarray(flat))


@pytest.mark.parametrize("fused", ["auto", "on"], ids=["unfused", "kernel-plain-versions"])
def test_three_train_steps_match_jax(jax_run, tmp_path, fused):
    t = _port_trainer(jax_run, tmp_path, fused)
    t.set_params(convert.params_from_numpy(jax_run["init"]))
    for it in range(STEPS):
        values = t.train_one_iter(it)
    assert set(values) == set(jax_run["trainer"].loss_computer.names) | {"TotalLoss"}
    _assert_state(t, jax_run)


def test_jax_checkpoint_resumes_in_the_port(jax_run):
    cfg = copy.deepcopy(jax_run["cfg"])
    cfg["resume_training"] = True
    t = _port_trainer(jax_run, jax_run["out"], cfg=cfg)
    assert t.start_iter == STEPS
    _assert_state(t, jax_run)
    # The resumed sampler draws what the JAX run draws next.
    jraw = jget_data_loader(cfg, jax_run["root"], "train").load_data()
    jpp = jpre.ScenePreprocessor(cfg, "train", jraw, seed=0)
    for it in range(STEPS + 1):
        want = jpp.next_indices(it)
    for a, b in zip(t.train_pp.next_indices(STEPS), want):
        np.testing.assert_array_equal(a, b)


def _resume_with_opt_state(jax_run, out, opt_state):
    """A port Trainer resumed from the JAX run's checkpoint with its
    optimizer state replaced by `opt_state`, written with the port's codec."""
    from simplenerf_torch.training import msgpack_codec

    raw = msgpack_codec.restore((jax_run["out"] / "saved_models/Model_Latest.msgpack").read_bytes())
    raw["opt_state"] = opt_state
    (out / "saved_models").mkdir(parents=True)
    (out / f"saved_models/Model_Iter{STEPS:06}.msgpack").write_bytes(msgpack_codec.packb(raw))
    (out / "saved_models/Model_Latest.msgpack").symlink_to(f"Model_Iter{STEPS:06}.msgpack")
    cfg = copy.deepcopy(jax_run["cfg"])
    cfg["resume_training"] = True
    return _port_trainer(jax_run, out, cfg=cfg)


def test_resume_migrates_per_leaf_adam_checkpoint(jax_run, tmp_path):
    """A checkpoint whose Adam moments are per-leaf trees (the layout before
    the flat-vector Adam) resumes with the moments ravelled in flat_leaves
    order and a warning, and then trains as the flat-state resume does."""
    cfg = copy.deepcopy(jax_run["cfg"])
    cfg["resume_training"] = True
    flat = _port_trainer(jax_run, jax_run["out"], cfg=cfg)
    count = np.asarray(STEPS, np.int32)

    def per_leaf(vec):  # the flat moments cut into a params-shaped state tree
        leaves, pos = [], 0
        for p in flat.leaves:
            leaves.append(vec[pos : pos + p.numel()].reshape(p.shape))
            pos += p.numel()
        it = iter(leaves)

        def tree(t):
            if isinstance(t, dict):
                return {str(k): tree(t[k]) for k in sorted(t)}
            if isinstance(t, (list, tuple)):
                return {str(i): tree(v) for i, v in enumerate(t)}
            return next(it)

        return tree(flat.params)

    state = {"0": {"count": count, "mu": per_leaf(jax_run["mu"]), "nu": per_leaf(jax_run["nu"])},
             "1": {"count": count.copy()}}
    with pytest.warns(UserWarning, match="migrated per-leaf Adam"):
        mig = _resume_with_opt_state(jax_run, tmp_path, state)
    assert mig.start_iter == flat.start_iter == STEPS
    for k in ("mu", "nu"):
        np.testing.assert_array_equal(mig.opt_state[k].numpy(), flat.opt_state[k].numpy())
    assert mig.opt_state["count"] == flat.opt_state["count"] == STEPS
    mig.train_one_iter(STEPS)
    flat.train_one_iter(STEPS)
    for a, b in zip(mig.leaves, flat.leaves):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())


def test_resume_with_unreadable_adam_state_starts_fresh(jax_run, tmp_path):
    """An optimizer state the port cannot read resumes the params with fresh
    Adam state and a warning, as the JAX package does."""
    count = np.asarray(STEPS, np.int32)
    state = {"0": {"count": count, "mu": np.zeros(5, np.float32), "nu": np.zeros(5, np.float32)},
             "1": {"count": count.copy()}}
    with pytest.warns(UserWarning, match="FRESH optimizer state"):
        t = _resume_with_opt_state(jax_run, tmp_path, state)
    assert t.start_iter == STEPS and t.opt_state["count"] == 0
    assert not t.opt_state["mu"].any() and not t.opt_state["nu"].any()
    got = np.concatenate([p.detach().numpy().reshape(-1) for p in t.leaves])
    np.testing.assert_array_equal(got, _flat(jax_run["params"]))


def test_port_checkpoint_loads_into_jax(jax_run, tmp_path):
    t = _port_trainer(jax_run, tmp_path)
    t.set_params(convert.params_from_numpy(jax_run["init"]))
    for it in range(STEPS):
        t.train_one_iter(it)
    t.save_checkpoint(STEPS)
    jt = jax_run["trainer"]
    it, params, opt_state = jckpt.load_checkpoint(
        tmp_path / "saved_models/Model_Latest.msgpack", jt.params, jt.opt_state
    )
    assert it == STEPS
    np.testing.assert_array_equal(_flat(params),
                                  np.concatenate([p.detach().numpy().reshape(-1) for p in t.leaves]))
    np.testing.assert_array_equal(np.asarray(opt_state[0].mu), t.opt_state["mu"].numpy())
    np.testing.assert_array_equal(np.asarray(opt_state[0].nu), t.opt_state["nu"].numpy())
    assert int(opt_state[0].count) == int(opt_state[1].count) == STEPS


def test_start_training_then_testing_on_cpu(tmp_path):
    from simplenerf_torch.data.synthetic import generate_scene as port_scene
    from simplenerf_torch.drivers import presets
    from simplenerf_torch.data import io

    port_scene(tmp_path / "db", scene_name="blobs", num_frames=6, h=24, w=32, num_train=3, seed=0)
    cfg = presets.tiny_synthetic_config(num_iterations=4, num_rays=64, sparse_depth_rays=32,
                                        consistency_start_iter=2)
    cfg["log_interval"] = 2
    cfg["model"]["fused_mlp"] = "on"
    run = runner.start_training(cfg, tmp_path / "db", tmp_path / "runs", device="cpu")
    scene = run / "blobs"
    rows = (scene / "logs/scalars.jsonl").read_text().splitlines()
    assert len(rows) == 2 and (scene / "saved_models/Model_Iter000004.msgpack").exists()
    assert (scene / "logs/step_timing.json").exists()
    # A finished scene is skipped on a second call.
    runner.start_training(cfg, tmp_path / "db", tmp_path / "runs", device="cpu")
    assert len((scene / "logs/scalars.jsonl").read_text().splitlines()) == 2
    scores = runner.start_testing({"train_num": cfg["train_num"], "test_num": 0},
                                  tmp_path / "db", tmp_path / "runs", run_qa=False, device="cpu")
    assert scores == {}
    frames = sorted((tmp_path / "runs/testing/test0000/blobs/predicted_frames").glob("*.png"))
    assert len(frames) == 3
    for f in frames:
        img = io.read_image(f)
        assert img.shape == (24, 32, 3)
