"""The port's multi-step training (`Trainer.train_many`) on the CPU.

On a card, `train_many(start, k)` with k > 1 replays one CUDA graph of the
step body; the CPU has no graphs, so here the graph is `FakeGraph`, which
takes `StepGraph`'s place and runs the body eagerly at each replay. That
drives every part of the graph path but the capture itself (the warm-up
step, the staged inputs, the counts check, reuse across calls, the
invalidation); tests/test_torch_port_cuda.py holds the real graph to the
loop on the card.

- (a) the JAX Trainer's `train_many(0, 3)`, its scan, against the port's,
  through the loop and through the fake graph: the same initialization and
  sampler streams, float32, perturb off, no sigma noise, with the
  tolerances of tests/test_torch_port_trainer.py (parameters 1e-4
  absolute; moments 1e-3 / 1e-2 relative with floors at the same scale;
  the count equal; the loss values 1e-3 relative);
- (b) the step body fed staged `StepInputs` against the step as it was
  written before the stage / body split (Python-float loss weights, Adam
  out of place from a Python count), with draws on, for 3 steps across the
  consistency ramp's step from weight 0 to 0.1: equal to the bit, through
  `train_one_iter` and through the fake graph;
- (c) the host stage's Adam scalars: lr_schedule(count) and optax's bias
  corrections 1 - b**(count + 1), computed in float64 and stored as
  float32, to the bit; one update against optax.adam's own, within 1e-5
  relative (optax evaluates 1 - b**c in float32, which loses ~5 digits of
  1 - 0.999 and moves the update by up to ~7e-6);
- (d) which steps go through a graph (`graph_capable`, k > 1), that
  `steps_per_call = 1` never captures, that later calls replay the same
  graph, that `set_params` drops it and that a replay whose counts differ
  from the capture's raises;
- (e) two gloo ranks with `steps_per_call` 3 keep the loop and give the
  run with `steps_per_call` 1, to the bit;
- the step's parts rewritten so that a graph can hold them give what they
  replaced, to the bit: the transmittance's cumprod (values and gradient,
  without PyTorch's host check for zeros), the weight rows gathered by a
  host permutation (`encoding.take_rows`) and the reprojection.
"""

import copy
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from simplenerf_tpu.data import get_data_loader as jget_data_loader
from simplenerf_tpu.data import preprocessor as jpre
from simplenerf_tpu.data.synthetic import generate_scene
from simplenerf_tpu.drivers.presets import tiny_synthetic_config
from simplenerf_tpu.training import trainer as jtrainer
from simplenerf_torch import convert, parallel
from simplenerf_torch.data import preprocessor as pre
from simplenerf_torch.data.factory import get_data_loader
from simplenerf_torch.fields import encoding
from simplenerf_torch.geometry import projection
from simplenerf_torch.render import renderer, volume
from simplenerf_torch.training import trainer

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tools/multiprocess_worker_torch.py"
STEPS = 3


def _config(draws: bool = False):
    cfg = tiny_synthetic_config(num_rays=64, sparse_depth_rays=32, consistency_start_iter=1,
                                raw_noise_std=1.0 if draws else 0.0)
    cfg["model"]["perturb"] = draws
    cfg["resume_training"] = False
    return cfg


class FakeGraph:
    """StepGraph's interface without CUDA: the warm-up runs `fn`, each
    replay runs it again into `out`."""

    made = 0

    def __init__(self, fn, device):
        FakeGraph.made += 1
        self.fn = fn
        fn()

    def replay(self):
        self.out = self.fn()


@pytest.fixture
def fake_graph(monkeypatch):
    monkeypatch.setattr(trainer, "StepGraph", FakeGraph)
    monkeypatch.setattr(FakeGraph, "made", 0)
    return FakeGraph


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("db")
    generate_scene(root, num_frames=5, h=24, w=32, num_train=3, seed=3)
    return root


def _port_trainer(scene, out, cfg, graph: bool = False):
    raw = get_data_loader(cfg, scene, "train").load_data()
    t = trainer.Trainer(cfg, out, pre.ScenePreprocessor(cfg, "train", raw, device="cpu", seed=0))
    t.use_graph = graph
    return t


def _flat(leaves) -> np.ndarray:
    return np.concatenate([np.asarray(leaf.detach() if torch.is_tensor(leaf) else leaf).reshape(-1)
                           for leaf in leaves])


# ---------------------------------------------------------------------------
# (a) against the JAX Trainer's scan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_scan(scene, tmp_path_factory):
    """The JAX Trainer's initial params, then its state and last loss values
    after train_many(0, STEPS)."""
    cfg = _config()
    jpp = jpre.ScenePreprocessor(cfg, "train", jget_data_loader(cfg, scene, "train").load_data(), seed=0)
    jt = jtrainer.Trainer(cfg, tmp_path_factory.mktemp("jax_run"), jpp)
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(jt.params))
    values = jt.train_many(0, STEPS)
    adam = jax.device_get(jt.opt_state)[0]
    return dict(cfg=cfg, init=convert.params_from_numpy(init),
                params=_flat(jax.tree_util.tree_leaves(jax.device_get(jt.params))),
                mu=np.asarray(adam.mu), nu=np.asarray(adam.nu), count=int(adam.count),
                values={k: float(v) for k, v in values.items()})


@pytest.mark.parametrize("graph", [False, True], ids=["loop", "fake-graph"])
def test_train_many_matches_the_jax_scan(scene, jax_scan, tmp_path, fake_graph, graph):
    t = _port_trainer(scene, tmp_path, copy.deepcopy(jax_scan["cfg"]), graph)
    t.set_params(jax_scan["init"])
    values = t.train_many(0, STEPS)
    assert fake_graph.made == int(graph)
    np.testing.assert_allclose(_flat(t.leaves), jax_scan["params"], rtol=0, atol=1e-4)
    mu, nu = jax_scan["mu"], jax_scan["nu"]
    np.testing.assert_allclose(t.opt_state["mu"].numpy(), mu, rtol=1e-3, atol=1e-3 * np.abs(mu).max())
    np.testing.assert_allclose(t.opt_state["nu"].numpy(), nu, rtol=1e-2, atol=1e-2 * np.abs(nu).max())
    assert t.opt_state["count"] == jax_scan["count"] == STEPS
    assert set(values) == set(jax_scan["values"])
    for k, v in jax_scan["values"].items():
        np.testing.assert_allclose(float(values[k]), v, rtol=1e-3, err_msg=k)


# ---------------------------------------------------------------------------
# (b) the staged body against the step before the split
# ---------------------------------------------------------------------------

def _steps_before_the_split(t, steps: int) -> tuple:
    """`steps` steps as Trainer.step and FlatAdam.step computed them before
    the host stage / device body split: the loss weights as Python floats,
    the moments out of place, lr and the bias corrections from a Python
    count. Returns (flat params, mu, nu, count, last loss values)."""
    opt = t.opt
    mu = torch.zeros(sum(p.numel() for p in t.leaves))
    nu = torch.zeros_like(mu)
    for it in range(steps):
        indices, mask_nerf, mask_sd = t.train_pp.next_indices(it)
        for p in t.leaves:
            p.grad = None
        draws = renderer.step_draws(t.render_cfg, len(indices), t.step_generator(it), t.device)
        batch = t.batch(indices, mask_nerf, mask_sd)
        batch["global_counts"] = {"rows": len(indices), "indices_mask_nerf": int(mask_nerf.sum()),
                                  "indices_mask_sparse_depth": int(mask_sd.sum())}
        outputs = renderer.render_rays(t.params, t.render_cfg, batch, train=True, **draws)
        weights = t.loss_computer.weights_vector(it).tolist()
        total, values = t.loss_computer.compute(batch, outputs, weights)
        total.backward()
        with torch.no_grad():
            g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                           for p in t.leaves])
            mu = (1 - opt.b1) * g + opt.b1 * mu
            nu = (1 - opt.b2) * torch.square(g) + opt.b2 * nu
            count = it + 1
            mu_hat = mu / (1 - opt.b1**count)
            nu_hat = nu / (1 - opt.b2**count)
            update = -opt.lr_schedule(it) * (mu_hat / (torch.sqrt(nu_hat) + opt.eps))
            pos = 0
            for p in t.leaves:
                p.add_(update[pos : pos + p.numel()].view_as(p))
                pos += p.numel()
    return (_flat(t.leaves), mu.numpy(), nu.numpy(), steps,
            {k: float(torch.as_tensor(v).detach()) for k, v in values.items()})


@pytest.mark.parametrize("graph", [False, True], ids=["train_one_iter", "fake-graph"])
def test_staged_body_equals_the_step_before_the_split(scene, tmp_path, fake_graph, graph):
    cfg = _config(draws=True)
    weights = [trainer.LossComputer(cfg["losses"]).weights_vector(it) for it in range(STEPS)]
    assert not np.array_equal(weights[0], weights[1])  # the ramp steps inside the run
    want = _steps_before_the_split(_port_trainer(scene, tmp_path / "want", cfg), STEPS)
    t = _port_trainer(scene, tmp_path / "got", cfg, graph)
    if graph:
        values = t.train_many(0, STEPS)
        assert fake_graph.made == 1
    else:
        for it in range(STEPS):
            values = t.train_one_iter(it)
            np.testing.assert_array_equal(t._inputs.weights.numpy(), weights[it])
    got = (_flat(t.leaves), t.opt_state["mu"].numpy(), t.opt_state["nu"].numpy(),
           t.opt_state["count"], {k: float(v) for k, v in values.items()})
    for name, a, b in zip(("params", "mu", "nu"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got[3:] == want[3:]


# ---------------------------------------------------------------------------
# (c) Adam's scalars
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("count", [0, 1, 2, 9, 99, 2999])
def test_adam_scalars_are_lr_schedule_and_optax_bias_corrections(scene, tmp_path, count):
    t = _port_trainer(scene, tmp_path, _config())
    opt = t.opt
    lr, bc1, bc2 = opt.scalars(count)
    c = count + 1
    want = np.array([opt.lr_schedule(count), 1 - opt.b1**c, 1 - opt.b2**c], np.float64)
    np.testing.assert_array_equal(np.array([lr, bc1, bc2]), want.astype(np.float32))
    # The staged scalars through FlatAdam.step against optax.adam's update.
    rng = np.random.default_rng(count)
    n = 4096
    g, mu, nu = (rng.standard_normal(n).astype(np.float32) * s for s in (1e-2, 1e-3, 1e-2))
    nu = np.abs(nu) ** 2
    ref = optax.adam(opt.lr_schedule, b1=opt.b1, b2=opt.b2)
    state = ref.init(jax.numpy.zeros(n))
    state = (state[0]._replace(count=jax.numpy.int32(count), mu=mu, nu=nu),
             state[1]._replace(count=jax.numpy.int32(count)))
    updates, _ = ref.update(g, state)
    p = torch.zeros(n, requires_grad=True)
    p.grad = torch.from_numpy(g)
    opt.step([p], {"count": count, "mu": torch.from_numpy(mu.copy()),
                   "nu": torch.from_numpy(nu.copy())}, torch.from_numpy(opt.scalars(count)))
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(updates), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(updates)).max())


# ---------------------------------------------------------------------------
# (d) the graph's rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device,world,want", [("cpu", None, False), ("cuda", None, True),
                                               ("cuda", 1, True), ("cuda", 2, False)])
def test_graph_capable_on_a_card_in_a_world_of_one(device, world, want):
    mesh = None if world is None else parallel.Mesh(None, 0, world, torch.device(device))
    assert trainer.graph_capable(torch.device(device), mesh) is want


def test_graph_is_captured_once_reused_and_dropped_by_set_params(scene, tmp_path, fake_graph):
    cfg = _config()
    cfg["num_iterations"] = 2
    cfg["steps_per_call"] = 1
    t = _port_trainer(scene, tmp_path, cfg, graph=True)
    init = copy.deepcopy(t.params)
    t.train()  # chunks of one step take the loop
    assert fake_graph.made == 0 and t._graph is None and t.opt_state["count"] == 2
    t.train_many(2, 3)
    assert fake_graph.made == 1 and t._graph is not None
    t.train_many(5, 2)  # a later call replays the same graph
    assert fake_graph.made == 1 and t.opt_state["count"] == 7
    t.set_params(init)
    assert t._graph is None and t.opt_state["count"] == 0
    t.train_many(7, 2)
    assert fake_graph.made == 2


def test_replay_with_other_counts_raises(scene, tmp_path, fake_graph, monkeypatch):
    t = _port_trainer(scene, tmp_path, _config(), graph=True)
    t.train_many(0, 2)
    next_indices = t.train_pp.next_indices

    def one_sparse_row_less(iter_num):
        indices, mask_nerf, mask_sd = next_indices(iter_num)
        mask_sd[-1] = False
        return indices, mask_nerf, mask_sd

    monkeypatch.setattr(t.train_pp, "next_indices", one_sparse_row_less)
    with pytest.raises(RuntimeError, match="differ from the captured"):
        t.train_many(2, 2)


# ---------------------------------------------------------------------------
# (e) a mesh of two gloo ranks keeps the loop
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_ranks(cfg: dict, db: Path, out: Path, steps_per_call: int) -> dict:
    """Two gloo ranks of the worker for STEPS steps; rank 0's dump."""
    out.mkdir(parents=True)
    (out / "cfg.json").write_text(json.dumps(cfg))
    port = str(_free_port())
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port, OMP_NUM_THREADS="2")
        env.pop("PYTHONPATH", None)
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), "--config", str(out / "cfg.json"), "--db", str(db),
             "--out", str(out), "--steps", str(STEPS), "--dump", str(out / "run"),
             "--device", "cpu", "--steps-per-call", str(steps_per_call)],
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
    return dict(np.load(out / "run.rank0.npz"))


def test_two_gloo_ranks_in_chunks_keep_the_loop(scene, tmp_path):
    cfg = _config(draws=True)
    one = _two_ranks(cfg, scene, tmp_path / "one", 1)
    chunked = _two_ranks(cfg, scene, tmp_path / "chunked", STEPS)
    assert list(one["iters"]) == [1, 2, 3] and list(chunked["iters"]) == [STEPS]
    for k in ("params", "mu", "nu", "count", "grad1"):
        np.testing.assert_array_equal(chunked[k], one[k], err_msg=k)
    assert list(chunked["names"]) == list(one["names"])
    np.testing.assert_array_equal(chunked["values"][-1], one["values"][-1])


# ---------------------------------------------------------------------------
# The parts rewritten for the capture
# ---------------------------------------------------------------------------

def test_exclusive_cumprod_equals_torch_cumprod_and_its_gradient():
    g = torch.Generator().manual_seed(0)
    alpha = torch.rand((64, 33), generator=g)
    alpha[:, 5] = 1.0  # an opaque sample: the factor is the 1e-10 floor
    x = (1.0 - alpha + 1e-10).requires_grad_()
    y = x.detach().clone().requires_grad_()
    cot = torch.randn((64, 33), generator=g)
    got = volume.exclusive_cumprod(x)
    want = torch.cumprod(torch.cat([torch.ones_like(y[:, :1]), y], dim=-1), dim=-1)[:, :-1]
    (got * cot).sum().backward()
    (want * cot).sum().backward()
    assert torch.equal(got, want) and torch.equal(x.grad, y.grad)


@pytest.mark.parametrize("degree", [2, 4, 10])
def test_take_rows_equals_indexing_by_the_permutation(degree):
    perm = encoding.blocked_to_reference_perm(degree)
    w = torch.randn((len(perm), 16), generator=torch.Generator().manual_seed(degree), requires_grad=True)
    v = w.detach().clone().requires_grad_()
    cot = torch.randn((len(perm), 16))
    got, want = encoding.take_rows(w, perm), v[perm]
    (got * cot).sum().backward()
    (want * cot).sum().backward()
    assert torch.equal(got, want) and torch.equal(w.grad, v.grad)


def test_reproject_flips_to_the_camera_convention():
    g = torch.Generator().manual_seed(1)
    pts = torch.randn((7, 3), generator=g)
    poses = torch.randn((7, 4, 4), generator=g)
    intrinsic = torch.tensor([[30.0, 0.0, 16.0], [0.0, 30.0, 12.0], [0.0, 0.0, 1.0]])
    flip = torch.diag(torch.tensor(projection._REPROJECT_FLIP))
    cam = torch.einsum("ij,...kj,...k->...i", flip, poses[..., :3, :3], pts - poses[..., :3, 3])
    pix = cam @ intrinsic.T
    assert torch.equal(projection.reproject(pts, poses, intrinsic), pix[..., :2] / pix[..., 2:3])
