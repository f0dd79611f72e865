"""The port's ray-sharded data parallelism (simplenerf_torch.parallel)
against the JAX package's mesh and against its own one-process run.

- the mesh helpers in one process: the local rows, the shards, the no-ops
  of a world of one, `initialize_distributed` without torchrun's
  environment, and the mesh's device after a gloo job binds a card;
- the loss stack's global denominators, no processes: each loss of the
  nine, DenseDepthMSE01 and the two visibility losses on seeded outputs,
  the batch split at a row, each part reduced with the whole batch's
  counts: the parts' values and gradients add up to the unsplit loss's,
  which is the unsharded reduction's to the bit;
- the render step's draws: `renderer.step_draws` at the global ray count,
  sliced, are the draws of the one-process step;
- two gloo ranks on the CPU (tools/multiprocess_worker_torch.py, one
  process per rank, each through `runner.start_training(mesh=)`): three
  deterministic steps from the JAX Trainer's initialization (a checkpoint
  at iteration 0 in each rank's directory) against the JAX Trainer on conftest's 8-device mesh
  (`_assert_state`'s tolerances of tests/test_torch_port_trainer.py), once
  through the unfused MLP and once through the kernels' plain versions;
  with draws on (jitter, importance uniforms, sigma noise), three steps
  against the one-process Trainer
  (step 1's gradient within 1e-5 of its largest entry, every loss value
  within 1e-5 relative, the parameters at 1e-4); a resume of both ranks
  after step 2 equals the uninterrupted run to the bit, also where one
  rank lost its checkpoint.

With 64 NeRF + 32 sparse-depth rays, rank 0 holds 48 NeRF rows and rank 1
16 NeRF and 32 sparse-depth rows, so every denominator is the whole
batch's and not the rank's.
"""

import copy
import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from simplenerf_tpu.data import get_data_loader as jget_data_loader
from simplenerf_tpu.data import preprocessor as jpre
from simplenerf_tpu.data.synthetic import generate_scene
from simplenerf_tpu.drivers.presets import tiny_synthetic_config
from simplenerf_tpu.parallel import make_mesh as jmake_mesh
from simplenerf_tpu.training import trainer as jtrainer
from simplenerf_torch import convert, parallel
from simplenerf_torch.data import preprocessor as pre
from simplenerf_torch.data.factory import get_data_loader
from simplenerf_torch.drivers import runner
from simplenerf_torch.losses.computer import LossContext, build_loss
from simplenerf_torch.render import renderer
from simplenerf_torch.training import checkpoints, trainer

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tools/multiprocess_worker_torch.py"
STEPS = 3
RANKS = 2


# ---------------------------------------------------------------------------
# The mesh helpers in one process
# ---------------------------------------------------------------------------

def test_initialize_distributed_without_torchrun_environment_is_a_noop(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.initialize_distributed("cpu") is None
    assert not torch.distributed.is_initialized()


def test_make_mesh_after_a_gloo_init_on_a_card_takes_the_card(monkeypatch):
    """Two gloo ranks may share a card: the mesh takes the device the rank
    was bound to, not the CPU of the backend."""
    from simplenerf_torch.parallel import mesh as mesh_lib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda device: None)
    monkeypatch.setattr(mesh_lib, "_RANK_DEVICE", None)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    try:
        assert parallel.initialize_distributed(backend="gloo") == torch.device("cuda", 0)
        assert torch.distributed.get_backend() == "gloo"
        mesh = parallel.make_mesh()
        assert (mesh.rank, mesh.world_size, mesh.device) == (0, 1, torch.device("cuda", 0))
        assert parallel.make_mesh(device="cpu").device == torch.device("cpu")
    finally:
        torch.distributed.destroy_process_group()


def test_make_mesh_after_a_cpu_init_takes_the_cpu(monkeypatch):
    from simplenerf_torch.parallel import mesh as mesh_lib

    monkeypatch.setattr(mesh_lib, "_RANK_DEVICE", None)
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(_free_port()))):
        monkeypatch.setenv(k, v)
    try:
        assert parallel.initialize_distributed("cpu") == torch.device("cpu")
        assert parallel.make_mesh().device == torch.device("cpu")
    finally:
        torch.distributed.destroy_process_group()


def test_make_mesh_without_distributed_is_a_world_of_one():
    mesh = parallel.make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.world_size, mesh.device) == (None, 0, 1, torch.device("cpu"))
    with pytest.raises(dataclasses.FrozenInstanceError):
        mesh.rank = 1


@pytest.mark.parametrize("rank,world,want", [(0, 1, (0, 96)), (0, 2, (0, 48)), (1, 2, (48, 96)),
                                             (3, 4, (72, 96))])
def test_process_local_rows_are_contiguous_blocks(rank, world, want):
    mesh = parallel.Mesh(None, rank, world, torch.device("cpu"))
    assert parallel.process_local_rows(96, mesh) == slice(*want)
    x = np.arange(96)
    idx, draws = parallel.shard_ray_batch(mesh, (x, {"u": torch.arange(96.0), "none": None}))
    np.testing.assert_array_equal(idx, x[slice(*want)])
    assert draws["none"] is None and torch.equal(draws["u"], torch.arange(96.0)[slice(*want)])


def test_process_local_rows_refuses_an_indivisible_batch():
    assert parallel.process_local_rows(97, None) == slice(0, 97)
    with pytest.raises(ValueError):
        parallel.process_local_rows(97, parallel.Mesh(None, 0, 2, torch.device("cpu")))


def test_replicate_and_all_reduce_are_noops_in_a_world_of_one():
    mesh = parallel.make_mesh(device="cpu")
    t = torch.arange(4.0)
    tree = {"a": t, "count": 3}
    assert parallel.replicate(mesh, tree) is tree and parallel.replicate(None, tree) is tree
    assert parallel.all_reduce_sum(mesh, t) is t and parallel.all_reduce_sum(None, t) is t
    assert torch.equal(t, torch.arange(4.0))


# ---------------------------------------------------------------------------
# The loss stack's global denominators (no processes)
# ---------------------------------------------------------------------------

SPLIT_LOSSES = ("MSE01", "MSE02", "MSE03", "SparseDepthMSE01", "SparseDepthMSE02",
                "SparseDepthMSE03", "PointsAugmentationDepthLoss02", "ViewsAugmentationDepthLoss02",
                "CoarseFineConsistencyLoss02", "PointsAugmentationDepthLoss01",
                "ViewsAugmentationDepthLoss01", "CoarseFineConsistencyLoss01", "DenseDepthMSE01",
                "VisibilityLoss01", "VisibilityPriorLoss01")
NR, N_NERF = 144, 96  # 96 NeRF + 48 sparse-depth rows
SPLITS = (1, 37, N_NERF, 143)  # 96: every NeRF row on one side, every sparse-depth row on the other


@pytest.fixture(scope="module")
def loss_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("db")
    generate_scene(root, num_frames=5, h=24, w=32, num_train=3, seed=3)
    cfg = tiny_synthetic_config(num_rays=N_NERF, sparse_depth_rays=NR - N_NERF)
    pp = pre.ScenePreprocessor(cfg, "train", get_data_loader(cfg, root, "train").load_data(),
                               device="cpu", seed=0)
    idx, mn, ms = pp.next_indices(0)
    batch = pre.gather_batch(pp.cache, pp.common, pp.batch_constants(), torch.as_tensor(idx),
                             torch.as_tensor(mn), torch.as_tensor(ms), packed_layout=pp.packed_layout)
    rng = np.random.default_rng(5)
    # Depths around the scene's, so the patch arbitration selects some rays
    # and not others (tests/test_torch_port_train.py).
    depth = pp.cache["sparse_depth_values"].numpy()[idx, 0]
    base = np.where(depth > 0, depth, np.median(depth[depth > 0])).astype(np.float32)
    batch["dense_depth_values"] = torch.from_numpy(base * rng.uniform(0.9, 1.1, NR).astype(np.float32))[:, None]
    batch["visibility_prior_masks"] = torch.from_numpy(rng.uniform(0, 1, (NR, 2)) > 0.3).float()
    outputs = {}
    for level in ("coarse", "fine"):
        for prefix in ("", "points_augmentation_", "views_augmentation_"):
            outputs[f"{prefix}rgb_{level}"] = rng.uniform(0.05, 0.95, (NR, 3))
            outputs[f"{prefix}depth_{level}"] = base * rng.uniform(0.85, 1.15, NR)
        outputs[f"raw_visibility_{level}"] = rng.uniform(0, 1, (NR, 8))
        outputs[f"visibility_{level}"] = rng.uniform(0, 1, (NR, 8))
        outputs[f"visibility2_{level}"] = rng.uniform(0, 1, (NR, 2))
    outputs = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in outputs.items()}
    specs = {s["name"]: s for s in cfg["losses"]}
    ctx = LossContext(points_aug_fine=True, views_aug_fine=True)
    return batch, outputs, specs, ctx


def _loss_on(fn, batch, outputs, rows=slice(None), counts=None):
    part = {k: (v[rows] if torch.is_tensor(v) and v.shape[0] == NR else v) for k, v in batch.items()}
    if counts is not None:
        part["global_counts"] = counts
    leaves = {k: v[rows].clone().requires_grad_() for k, v in outputs.items()}
    value = fn(part, leaves)
    grads = torch.autograd.grad(value, list(leaves.values()), allow_unused=True)
    return value.detach(), {k: (torch.zeros_like(v) if g is None else g)
                            for (k, v), g in zip(leaves.items(), grads)}


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("name", SPLIT_LOSSES)
def test_split_batch_with_global_counts_adds_up_to_the_whole_loss(loss_inputs, name, split):
    batch, outputs, specs, ctx = loss_inputs
    fn = build_loss(name, specs.get(name, {"name": name}), ctx)
    counts = {"rows": NR, "indices_mask_nerf": int(batch["indices_mask_nerf"].sum()),
              "indices_mask_sparse_depth": int(batch["indices_mask_sparse_depth"].sum())}
    whole, whole_g = _loss_on(fn, batch, outputs)
    assert float(whole) > 0, name
    # The whole batch through the global-count reductions is today's loss.
    same, same_g = _loss_on(fn, batch, outputs, counts=counts)
    assert torch.equal(same, whole), name
    for k in outputs:
        assert torch.equal(same_g[k], whole_g[k]), k
    # Each part divides its sums by the whole batch's counts; the parts add up.
    a, a_g = _loss_on(fn, batch, outputs, slice(0, split), counts)
    b, b_g = _loss_on(fn, batch, outputs, slice(split, NR), counts)
    torch.testing.assert_close(a + b, whole, rtol=1e-6, atol=0)
    for k in outputs:
        torch.testing.assert_close(torch.cat([a_g[k], b_g[k]]), whole_g[k], rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# The step's draws
# ---------------------------------------------------------------------------

def test_global_draws_sliced_are_the_one_process_draws():
    """render_rays with a generator takes step_draws' numbers; drawn at the
    global count and sliced, they are the one-process step's rows, and a
    rank that drew at its own count would draw others."""
    cfg = tiny_synthetic_config()
    from simplenerf_torch import config as config_lib

    rcfg = config_lib.render_config_from_dict(cfg)
    draws = renderer.step_draws(rcfg, 96, torch.Generator().manual_seed(4), "cpu")
    assert set(draws["noise"]) == {"coarse", "fine", "points_aug_coarse", "views_aug_coarse"}
    assert draws["u_coarse"].shape == (96, 16) and draws["u_fine"].shape == (96, 32)
    assert draws["noise"]["fine"].shape == (96, 48)
    mesh = parallel.Mesh(None, 1, 2, torch.device("cpu"))
    local = parallel.shard_ray_batch(mesh, draws)
    torch.testing.assert_close(local["u_fine"], draws["u_fine"][48:], rtol=0, atol=0)
    own = renderer.step_draws(rcfg, 48, torch.Generator().manual_seed(4), "cpu")
    assert not torch.equal(own["u_fine"], local["u_fine"])
    # render_rays draws through the same helper.
    params = renderer.init(torch.Generator().manual_seed(0), rcfg)
    rays = {k: torch.rand(96, 3, generator=torch.Generator().manual_seed(1))
            for k in ("rays_o", "rays_d", "view_dirs", "rays_o_ndc", "rays_d_ndc")}
    rays.update({k: torch.full((96, 1), v) for k, v in (("near", 0.5), ("far", 2.0),
                                                        ("near_ndc", 0.0), ("far_ndc", 1.0))})
    got = renderer.render_rays(params, rcfg, rays, train=True, generator=torch.Generator().manual_seed(4))
    want = renderer.render_rays(params, rcfg, rays, train=True, **draws)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Two gloo ranks on the CPU
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(cfg: dict, db: Path, out: Path, steps: int, *extra: str) -> list:
    """Run the worker on RANKS gloo ranks; every rank must exit 0. Returns
    each rank's dump."""
    out.mkdir(parents=True, exist_ok=True)
    (out / "cfg.json").write_text(json.dumps(cfg))
    port = str(_free_port())
    procs = []
    for rank in range(RANKS):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(RANKS), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port, OMP_NUM_THREADS="2")
        env.pop("PYTHONPATH", None)
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), "--config", str(out / "cfg.json"), "--db", str(db),
             "--out", str(out), "--steps", str(steps), "--dump", str(out / "run"),
             "--device", "cpu", *extra],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK {rank} OK" in log, f"rank {rank}:\n{log[-4000:]}"
    dumps = [dict(np.load(out / f"run.rank{r}.npz")) for r in range(RANKS)]
    for d in dumps[1:]:  # the ranks stay replicas of each other
        for k in ("params", "mu", "nu", "count", "grad1", "values"):
            np.testing.assert_array_equal(d[k], dumps[0][k], err_msg=k)
    return dumps


def _config(**kw):
    cfg = tiny_synthetic_config(num_rays=64, sparse_depth_rays=32, consistency_start_iter=1,
                                raw_noise_std=kw.pop("raw_noise_std", 0.0))
    cfg["model"]["perturb"] = kw.pop("perturb", False)
    cfg["resume_training"] = kw.pop("resume_training", False)
    assert not kw
    return cfg


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("db")
    generate_scene(root, num_frames=5, h=24, w=32, num_train=3, seed=3)
    return root


@pytest.fixture(scope="module")
def jax_mesh_run(scene, tmp_path_factory):
    """The JAX Trainer on the 8-device mesh: initial params, then its state
    and loss values after STEPS steps."""
    cfg = _config()
    jpp = jpre.ScenePreprocessor(cfg, "train", jget_data_loader(cfg, scene, "train").load_data(), seed=0)
    jt = jtrainer.Trainer(cfg, tmp_path_factory.mktemp("jax_mesh"), jpp, mesh=jmake_mesh())
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(jt.params))
    for it in range(STEPS):
        values = jt.train_one_iter(it)
    adam = jax.device_get(jt.opt_state)[0]
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jt.params))
    flat = np.concatenate([np.asarray(leaf).reshape(-1) for leaf in jax.tree_util.tree_leaves(params)])
    return dict(cfg=cfg, init=convert.params_from_numpy(init), params=flat, mu=np.asarray(adam.mu),
                nu=np.asarray(adam.nu), count=int(adam.count),
                values={k: float(v) for k, v in values.items()})


@pytest.mark.parametrize("fused", ["auto", "on"], ids=["unfused", "kernel-plain-versions"])
def test_two_gloo_ranks_match_the_jax_mesh(scene, jax_mesh_run, tmp_path, fused):
    cfg = copy.deepcopy(jax_mesh_run["cfg"])
    cfg["model"]["fused_mlp"] = fused
    # Each rank resumes from the JAX Trainer's initialization, saved at
    # iteration 0 where start_training looks for its checkpoint.
    cfg["resume_training"] = True
    for rank in range(RANKS):
        scene_dir = (tmp_path / f"ranks/rank{rank}/training/train{cfg.get('train_num', 0):04}"
                     / runner.scene_key(cfg, cfg["data_loader"]["scene_id"]))
        checkpoints.save_checkpoint(scene_dir / "saved_models", 0, jax_mesh_run["init"])
    d = run_ranks(cfg, scene, tmp_path / "ranks", STEPS)[0]
    # _assert_state of tests/test_torch_port_trainer.py
    np.testing.assert_allclose(d["params"], jax_mesh_run["params"], rtol=0, atol=1e-4)
    mu, nu = jax_mesh_run["mu"], jax_mesh_run["nu"]
    np.testing.assert_allclose(d["mu"], mu, rtol=1e-3, atol=1e-3 * np.abs(mu).max())
    np.testing.assert_allclose(d["nu"], nu, rtol=1e-2, atol=1e-2 * np.abs(nu).max())
    assert int(d["count"]) == jax_mesh_run["count"] == STEPS
    # The summed loss values are the JAX job's global values.
    last = dict(zip(d["names"], d["values"][-1]))
    assert set(last) == set(jax_mesh_run["values"])
    for k, v in jax_mesh_run["values"].items():
        np.testing.assert_allclose(last[k], v, rtol=1e-3, err_msg=k)


def _draws_config():
    return _config(perturb=True, raw_noise_std=1.0, resume_training=True)


@pytest.fixture(scope="module")
def draws_runs(scene, tmp_path_factory):
    """With draws on: the one-process Trainer's step-1 gradient, loss values
    and params; two ranks through runner.start_training(mesh=)."""
    cfg = _draws_config()
    pp = pre.ScenePreprocessor(cfg, "train", get_data_loader(cfg, scene, "train").load_data(),
                               device="cpu", seed=0)
    t = trainer.Trainer(cfg, tmp_path_factory.mktemp("one_rank"), pp)
    grads = []
    gradient = t.opt.gradient
    t.opt.gradient = lambda leaves: grads.append(gradient(leaves)) or grads[-1]
    values = []
    for it in range(STEPS):
        v = t.train_one_iter(it)
        values.append({k: float(x) for k, x in v.items()})
    one = dict(grad1=grads[0].numpy(), values=values,
               params=torch.cat([p.detach().reshape(-1) for p in t.leaves]).numpy())
    two = run_ranks(cfg, scene, tmp_path_factory.mktemp("two_ranks"), STEPS)[0]
    return one, two


def test_two_ranks_with_draws_equal_one_process(draws_runs):
    one, two = draws_runs
    g1, g2 = one["grad1"], two["grad1"]
    assert np.abs(g2 - g1).max() <= 1e-5 * np.abs(g1).max()
    assert len(two["values"]) == STEPS
    for step, row in enumerate(two["values"]):
        got = dict(zip(two["names"], row))
        assert set(got) == set(one["values"][step])
        for k, v in one["values"][step].items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-12, err_msg=f"{k} step {step}")
    np.testing.assert_allclose(two["params"], one["params"], rtol=0, atol=1e-4)


def test_two_ranks_resumed_after_step_two_equal_the_uninterrupted_run(scene, draws_runs, tmp_path):
    _, want = draws_runs
    cfg = _draws_config()
    run_ranks(cfg, scene, tmp_path, STEPS - 1)
    got = run_ranks(cfg, scene, tmp_path, STEPS)[0]
    assert len(got["values"]) == STEPS  # the resumed run logged step 3 after steps 1-2
    for k in ("params", "mu", "nu", "count", "values"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_a_rank_without_a_checkpoint_resumes_from_rank_zeros(scene, draws_runs, tmp_path):
    """A rank whose directory lost its checkpoint goes on from rank 0's
    iteration, parameters and Adam state, and the job equals the
    uninterrupted run."""
    _, want = draws_runs
    cfg = _draws_config()
    run_ranks(cfg, scene, tmp_path, STEPS - 1)
    (saved,) = (tmp_path / "rank1").glob("training/*/*/saved_models")
    shutil.rmtree(saved)
    got = run_ranks(cfg, scene, tmp_path, STEPS)[0]
    for k in ("params", "mu", "nu", "count", "values"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
