"""FreeNeRF on the port: its train step against the plain reference
(benchmark/reference_freenerf.py), the IPE operand, the frustum moments,
the frequency masks staged per step, the shared MLP's summed gradient, the
benchmark cell at a tiny size and its faults, and the forward plans at the
99-wide points operand.

- One FreeNeRF step through `Trainer.body` at a tiny size (24x32 scene,
  widths 32/16, 8 + 8 intervals, 64 rays, steps numbered from 10,000 so
  that the masks cut the encoding), in float32 with fused "on" and "auto"
  (mip-NeRF's field takes the kernels' plain versions on the CPU under
  either setting: `render.mip` has no unfused forward), against the
  reference: the total and each loss, each leaf's gradient and its change
  after the step's Adam update, as ||got - want|| over the larger of the
  leaf's norm and the median leaf's. Both sides are float32 on the CPU and
  differ by summation order only: the losses read 9.7e-8 (relative), the
  gradients 2.0e-6, the change after the first update 3.3e-5 (both "on"
  and "auto"). The tolerances are 20-30x those readings, and the same step
  in bf16 against the float32 reference reads 5.3e-5, 1.8e-2 and 0.22,
  which `test_bf16_step_fails_the_float32_tolerances` holds.
"""

import copy
import json
import math

import numpy as np
import pytest
import torch

from benchmark import counts, counts_freenerf, faults_freenerf, reference_freenerf, scene
from benchmark.kinds import free_train
from simplenerf_torch.data.preprocessor import ScenePreprocessor
from simplenerf_torch.drivers import llff, presets
from simplenerf_torch.fields import mlp
from simplenerf_torch.ops import fused_mlp
from simplenerf_torch.render import mip, renderer
from simplenerf_torch.training import trainer as trainer_lib
from simplenerf_torch.training.trainer import Trainer

SEED = 2**31 + 4321
CPU = torch.device("cpu")
ASSUMED = {"height": 24, "width": 32, "train_frames": 3, "focal": 26.0, "camera_baseline": 0.25,
           "camera_tilt_deg": 2.0, "plane_depth": 4.0, "texture_max_freq": 3.0,
           "sparse_points_per_frame": 60}
TOL = {"loss": 2e-6, "grad": 4e-5, "delta": 1e-3}  # float32 both sides: summation order
START = 10000


def tiny_config(dtype: str = "float32", fused: str = "on") -> dict:
    cfg, _ = llff.build_configs(views=3, scenes=None, iters=69768, compute_dtype=dtype, seed=0,
                                model="freenerf")
    cfg["data_loader"]["num_rays"] = 64
    m = cfg["model"]["mlp"]
    m["points_net_width"], m["views_net_width"], m["num_samples"] = 32, 16, 8
    cfg["model"]["fused_mlp"] = fused
    cfg["seed"] = SEED % 2**31
    return cfg


def make_trainer(cfg: dict, tmp_path):
    raw = scene.make_llff_scene(SEED, ASSUMED, CPU)
    pp = ScenePreprocessor(cfg, "train", raw, device=CPU, seed=cfg["seed"])
    tr = Trainer(cfg, tmp_path / "run", pp)
    params0 = free_train.make_weights(SEED, cfg, CPU)
    tr.set_params(params0)
    return tr, raw, params0


def one_step(cfg: dict, tmp_path) -> dict:
    """One step through Trainer.stage and Trainer.body from the benchmark's
    weights: the loss values, each leaf's gradient and change, by path."""
    tr, raw, params0 = make_trainer(cfg, tmp_path)
    values = tr.body(tr.stage(START))
    p0 = dict(scene.tree_items(params0))
    leaves = scene.tree_items(tr.params)
    return {"raw": raw, "params0": params0,
            "values": {k: float(v) for k, v in values.items()},
            "grad": {k: p.grad.detach().clone() for k, p in leaves},
            "delta": {k: (p.detach() - p0[k]).clone() for k, p in leaves}}


def gaps(got: dict, cfg: dict) -> dict:
    """The step's largest relative gaps to the float32 reference."""
    ref = reference_freenerf.train_steps(got["raw"], cfg, got["params0"], cfg["seed"], START, 1,
                                         "float32", CPU)
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    loss = max([rel(got["values"]["TotalLoss"], ref["loss"][0])]
               + [rel(got["values"][n], v) for n, v in ref["values"][0].items()])

    def leaf(key):
        norms = {p: float(r.norm()) for p, r in ref[key].items()}
        floor = float(np.median(list(norms.values())))
        return max(float((got[key][p] - r).norm()) / max(norms[p], floor, 1e-30)
                   for p, r in ref[key].items())

    return {"loss": loss, "grad": leaf("grad"), "delta": leaf("delta")}


@pytest.mark.parametrize("fused", ["on", "auto"])
def test_freenerf_step_matches_the_reference(tmp_path, fused):
    cfg = tiny_config(fused=fused)
    got = one_step(cfg, tmp_path)
    g = gaps(got, cfg)
    print(f"freenerf step ({fused}): {g}")
    assert got["values"]["OcclusionLoss01"] > 0
    for key, tol in TOL.items():
        assert g[key] <= tol, (key, g[key])


def test_bf16_step_fails_the_float32_tolerances(tmp_path):
    """The tolerances are tighter than bf16 products: the bf16 step against
    the float32 reference exceeds each."""
    cfg = tiny_config("bfloat16")
    g = gaps(one_step(cfg, tmp_path), tiny_config())
    print(f"freenerf step (bf16 against float32): {g}")
    for key, tol in TOL.items():
        assert g[key] > tol, (key, g[key])


def _frustums(n_rays=5, ns=7, dtype=torch.float32):
    g = torch.Generator().manual_seed(7)
    o = torch.randn((n_rays, 3), generator=g, dtype=dtype)
    d = torch.randn((n_rays, 3), generator=g, dtype=dtype)
    r = 0.002 + 0.01 * torch.rand((n_rays, 1), generator=g, dtype=dtype)
    t = torch.sort(torch.rand((n_rays, ns + 1), generator=g, dtype=dtype), dim=-1).values
    return o, d, r, t


@pytest.mark.parametrize("masked", [False, True], ids=["ones", "mask"])
@pytest.mark.parametrize("cdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ipe_operand_follows_the_equations(masked, cdtype):
    """lo = [mean | sin(2^l mean) e^(-4^l var / 2) | cos ...] at 16 octaves,
    blocked frequency-major, times the mask, from the reference's own
    frustum Gaussians (mip-NeRF's formulas as written there); at zero
    variance the encoding of the means is the PE block."""
    o, d, r, t = _frustums()
    deg = 16
    mask = torch.rand(3 + 6 * deg, generator=torch.Generator().manual_seed(3)) if masked else None
    got = fused_mlp.ipe_operands(o, d, r, t, deg, mask, cdtype)
    mean, var = reference_freenerf.cast(t, o, d, r)
    mean, var = mean.reshape(-1, 3), var.reshape(-1, 3)
    sins = [torch.sin(mean * 2.0**i) * torch.exp(-0.5 * var * 4.0**i) for i in range(deg)]
    coss = [torch.cos(mean * 2.0**i) * torch.exp(-0.5 * var * 4.0**i) for i in range(deg)]
    want = torch.cat([mean] + sins + coss, -1) * (mask if masked else 1.0)
    assert got.shape == (t.shape[0] * (t.shape[1] - 1), 99) and got.dtype == cdtype
    tol = 1e-5 if cdtype == torch.float32 else 8e-3
    torch.testing.assert_close(got.float(), want.to(cdtype).float(), atol=tol, rtol=tol)
    zero = fused_mlp.ipe_operands(o, d, torch.zeros_like(r), t[:, [0, 0]], deg, None, cdtype)
    pe, _ = fused_mlp.pe_operands_reference((o + d * t[:, :1]).contiguous(), deg, deg, cdtype)
    torch.testing.assert_close(zero, pe, atol=0, rtol=0)


def test_frustum_moments_integrate_the_frustum():
    """mean and diagonal variance of a conical frustum (density of t
    proportional to t^2 between the edges; a disc of radius r t across the
    axis, whose per-axis variance is (r t)^2 / 4) by quadrature, in
    float64: `frustum_gaussians` equals them."""
    o, d, r, t = _frustums(dtype=torch.float64)
    mean, var = fused_mlp.frustum_gaussians(o, d, r, t)
    s = torch.linspace(0.0, 1.0, 20001, dtype=torch.float64)
    tt = t[:, :-1, None] + (t[:, 1:] - t[:, :-1])[..., None] * s  # (nr, ns, q)
    w = tt**2
    moment = lambda f: torch.trapezoid(w * f, tt, dim=-1) / torch.trapezoid(w, tt, dim=-1)  # noqa: E731
    t_mean, t_sq = moment(tt), moment(tt**2)
    t_var = t_sq - t_mean**2
    r_var = r**2 * t_sq / 4
    dd = d**2
    want_mean = o[:, None] + d[:, None] * t_mean[..., None]
    want_var = (t_var[..., None] * dd[:, None]
                + r_var[..., None] * (1 - dd / dd.sum(-1, keepdim=True))[:, None])
    torch.testing.assert_close(mean, want_mean, atol=1e-9, rtol=1e-9)
    torch.testing.assert_close(var, want_var, atol=1e-12, rtol=1e-6)


@pytest.mark.parametrize("length", [99, 27])
def test_freq_mask_is_freenerfs(length):
    """At t = 0, T/2, T and after T, against FreeNeRF's formula written by
    hand and as the reference writes it."""
    end = 62791
    n3 = length // 3
    half = n3 * 0.5 + 1
    want = {0: [1.0] * 3 + [0.0] * (length - 3),
            end // 2: None, end: [1.0] * length, end + 1000: [1.0] * length}
    for step, w in want.items():
        got = mip.freq_mask(length, step, end)
        np.testing.assert_allclose(got, reference_freenerf.freq_reg_mask(length, step, end).numpy())
        if w is not None:
            np.testing.assert_array_equal(got, np.asarray(w, np.float32))
    got = mip.freq_mask(length, end // 2, end)
    p = n3 * (end // 2) / end + 1
    k = int(p)
    assert abs(p - half) < 1e-3 and got[: 3 * k].min() == 1.0 and got[3 * k + 3 :].max() == 0.0
    np.testing.assert_allclose(got[3 * k : 3 * k + 3], p - k, rtol=1e-6)


def test_staged_masks_are_each_steps(tmp_path, monkeypatch):
    """Through `train_many`'s graph path (a stand-in graph that replays the
    captured body eagerly), each of 50 steps renders with the masks its
    host stage wrote, FreeNeRF's at its own step."""
    class FakeGraph:
        def __init__(self, fn, device):
            self.fn = fn
            fn()

        def replay(self):
            self.out = self.fn()

    seen = []
    render = mip.render_rays

    def spy(*a, **k):
        seen.append(a[8].clone())  # freq_mask
        return render(*a, **k)

    cfg = tiny_config()
    cfg["data_loader"]["num_rays"] = 16
    cfg["model"]["mlp"]["points_net_width"], cfg["model"]["mlp"]["num_samples"] = 16, 4
    monkeypatch.setattr(trainer_lib, "StepGraph", FakeGraph)
    monkeypatch.setattr(renderer.mip, "render_rays", spy)
    tr, _, _ = make_trainer(cfg, tmp_path)
    tr.use_graph = True
    start = 30000
    tr.train_many(start, 50)
    assert len(seen) == 50  # the first step is the capture's warm-up, then 49 replays
    end = cfg["model"]["freq_reg_end"]
    for i, got in enumerate(seen):
        want = mip.step_masks(tr.render_cfg.shared_mlp, start + i, end)
        np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(seen[0].numpy(), seen[-1].numpy())


def test_shared_leaf_gradient_sums_both_levels():
    """Both levels read the same leaves: a leaf's gradient of the whole
    photometric loss is the coarse level's (weight 0.1) plus the fine
    level's."""
    cfg = tiny_config()
    rc = renderer.RenderConfig(coarse_mlp=None, shared_mlp=mlp.MLPConfig(
        points_net_width=32, views_net_width=16, points_pe_degree=16, num_samples=8),
        fused_mlp="on")
    params = renderer.init(torch.Generator().manual_seed(1), rc)
    leaves = [p.requires_grad_() for _, p in scene.tree_items(params)]
    g = torch.Generator().manual_seed(2)
    nr = 16
    o, d = torch.randn((nr, 3), generator=g) * 0.1, torch.randn((nr, 3), generator=g)
    d[:, 2] = -d[:, 2].abs() - 1.0
    rays = {"rays_o": o, "rays_d": d, "view_dirs": d / d.norm(dim=-1, keepdim=True),
            "rays_o_ndc": o, "rays_d_ndc": d, "radii_ndc": torch.full((nr, 1), 0.01),
            "near_ndc": torch.zeros((nr, 1)), "far_ndc": torch.ones((nr, 1))}
    draws = mip.step_draws(rc.shared_mlp, 1.0, nr, g, CPU)
    mask = torch.as_tensor(mip.step_masks(rc.shared_mlp, 20000, cfg["model"]["freq_reg_end"]))
    target = torch.rand((nr, 3), generator=g)

    def grads(weights):
        out = renderer.render_rays(params, rc, rays, train=True, freq_mask=mask, **draws)
        loss = sum(w * ((out[f"rgb_{lv}"] - target) ** 2).mean() for lv, w in weights.items())
        return torch.autograd.grad(loss, leaves)

    both = grads({"coarse": 0.1, "fine": 1.0})
    parts = zip(grads({"coarse": 0.1}), grads({"fine": 1.0}))
    for a, (c, f) in zip(both, parts):
        torch.testing.assert_close(a, c + f, atol=1e-7, rtol=1e-5)
    assert all(float(c.abs().sum()) > 0 for c in grads({"coarse": 0.1}))


def tiny_cell(dtype: str = "float32"):
    """The FreeNeRF cell at the tiny size of `tiny_config`, a short window."""
    from benchmark import harness

    cell = harness.Cell("freenerf_bf16.free_train")
    cell.config["train_configs"] = tiny_config(dtype)
    cell.config["assumed"].update(ASSUMED)
    cell.dtype = dtype
    cell.traffic.update(steps_per_call=2, trace_steps=4, label_steps=4, op_steps=1)
    return cell


def test_free_cell_runs_correct_on_the_cpu():
    """A whole run of the cell (set-up, window, check) through the harness;
    in float32 every number reads far under its card limit (rounding only)."""
    import time

    from benchmark import harness

    res = harness.run(tiny_cell(), SEED, 0.3, False, CPU, time.perf_counter(), forbid=False)
    assert res["attempted"] > 0 and res["correct"] is True, res["checks"]
    for name in ("density_gap", "ipe_gap", "grad_gap", "delta_gap_median"):
        assert res["checks"][name]["value"] <= 0.1 * res["checks"][name]["limit"], name


@pytest.mark.parametrize("fault", faults_freenerf.FREE_FAULTS + faults_freenerf.TRAIN_FAULTS)
def test_free_faults_fail_the_check(tmp_path, fault):
    """Each planted fault fails the cell's limits."""
    from benchmark import harness

    cell = tiny_cell()
    with faults_freenerf.planted(fault, cell):
        st = free_train.setup(cell, SEED, CPU, tmp_path)
    free_train.release(st)
    numbers = free_train.check(st, cell, SEED, CPU)["numbers"]
    ok, checks = harness.judge(numbers, cell.limits)
    print(f"fault {fault}: {numbers}")
    assert not ok, checks


def test_config_file_is_the_drivers_freenerf_recipe():
    cfg = json.load(open("benchmark/configs/freenerf_bf16.json"))
    want, _ = llff.build_configs(views=3, scenes=None, iters=69768, compute_dtype="bfloat16", seed=0,
                                 model="freenerf")
    assert cfg["train_configs"] == json.loads(json.dumps(want))
    assert cfg["reduced"] == [] and cfg["assumed"]["width"] == 504 and cfg["assumed"]["height"] == 378


def test_freenerf_preset_is_the_published_widths():
    cfg = presets.freenerf_config()
    m = cfg["model"]["mlp"]
    assert (m["points_net_depth"], m["points_net_width"], m["views_net_depth"], m["views_net_width"]) \
        == (8, 256, 1, 128)
    assert (m["points_positional_encoding_degree"], m["views_positional_encoding_degree"]) == (16, 4)
    assert m["num_samples"] == 128 and cfg["data_loader"]["num_rays"] == 4096
    assert cfg["model"]["freq_reg_end"] == 62791 and cfg["model"]["raw_noise_std"] == 1.0
    assert "sparse_depth" not in cfg["data_loader"] and "mip_nerf" in cfg["data_loader"]
    assert [(s["name"], s["weight"]) for s in cfg["losses"]] == [("MipNeRFMSE01", 1),
                                                                ("OcclusionLoss01", 0.01)]
    opt = cfg["optimizer"]
    assert (opt["lr_initial"], opt["lr_final"], opt["max_steps"], opt["lr_delay_steps"],
            opt["lr_delay_mult"]) == (2e-3, 2e-5, 69768, 512, 0.01)
    assert copy.deepcopy(cfg) == presets.freenerf_config(num_iterations=69768)
    spec = fused_mlp.make_spec(mlp.MLPConfig(points_pe_degree=16, num_samples=128), 128, torch.bfloat16)
    assert spec.in_lo == 99 and not spec.has_extra and spec.has_hvx


def test_free_counts_by_hand():
    m = presets.freenerf_config()["model"]["mlp"]
    assert counts.fwd_macs(m) == 99 * 256 * 2 + 7 * 256 * 256 + 256 + 256 * 256 + 256 * 128 + 3 * 128
    assert counts_freenerf.ipe_bytes(m, 4096, "bfloat16") == (
        4096 * 128 * 99 * 2 + 4096 * (3 + 3 + 1 + 129) * 4 + 99 * 4)
    cell = type("C", (), {"config": {"train_configs": presets.freenerf_config()}, "dtype": "bfloat16"})
    c = counts_freenerf.step_counts(cell)
    per_point = 3 * counts.fwd_macs(m) - 2 * 99 * 256
    assert c["step_flops"] == 2 * 2 * (4096 * 128 * per_point + 2 * 4096 * 27 * 128)
    assert math.isclose(c["ipe_bound_s"], 2 * counts_freenerf.ipe_bytes(m, 4096, "bfloat16") / 3.35e12)


def _plan(dtype, degree=16):
    return fused_mlp.sm90_plan(fused_mlp.make_spec(mlp.MLPConfig(points_pe_degree=degree), 128, dtype))


def test_bf16_plan_hands_the_wide_join_on_within_the_ring():
    """At the 99-wide points operand the skip join is 4 + 2 slabs; two lo K
    blocks a consumer leave room for a ring of 5: the plan hands the turn
    on after 5 slabs (`hand`, header word 13) and fits shared memory;
    today's degree-10 plan keeps a ring of 6 that holds every layer, hand 0."""
    plan = _plan(torch.bfloat16)
    hdr = plan.words[: fused_mlp._SM90_HEADER_WORDS]
    ops = plan.words[fused_mlp._SM90_HEADER_WORDS:].reshape(-1, fused_mlp._SM90_OP_WORDS)
    slabs = ops[:, 8:11].sum(1)
    assert hdr[3] == 99 and hdr[5] == 2 and max(slabs) == 6
    assert hdr[9] == 5 and hdr[13] == 5 and plan.smem <= fused_mlp._SMEM_LIMIT
    old = _plan(torch.bfloat16, 10)
    assert old.words[9] == 6 and old.words[13] == 0


@pytest.mark.parametrize("degree", [10, 16])
def test_secondary_views_stay_off_the_split_forward(degree):
    """The forward has no kPre instance with kSplit (the launch refuses
    one), so on the card secondary views take the kernels only where the
    plan hands nothing on: at degree 10, not at the 99-wide join."""
    cfg = mlp.MLPConfig(predict_visibility=True, points_pe_degree=degree)
    spec = fused_mlp.make_spec(cfg, 128, torch.bfloat16)
    assert fused_mlp.secondary_supported(spec, "cpu")
    assert fused_mlp.secondary_supported(spec, "cuda") == (degree == 10)


@pytest.mark.parametrize("degree", [10, 16])
def test_f32_plan_fits_or_raises(degree):
    """The float32 forward's plan fits shared memory, or raises naming both
    numbers: at 16 octaves its shallowest ring needs 234,056 B."""
    try:
        plan = _plan(torch.float32, degree)
    except ValueError as e:
        assert degree == 16 and "234056" in str(e) and str(fused_mlp._SMEM_LIMIT) in str(e)
        return
    assert plan.smem <= fused_mlp._SMEM_LIMIT


def _turns(layers, stages, hand):
    """The bf16 forward's ring and turns (csrc/fused_mlp_sm90.cuh), stepped
    one event at a time: the producer fills slots in order as both
    consumers free them; consumer 0 takes the first turn; a consumer on its
    turn issues a layer's slabs and hands the turn on after `hand` of them
    (all with hand 0), and releases a slab once it has issued the next.
    True if every slab of every layer is issued by both, False on a
    deadlock."""
    order = [(li, k) for li, n in enumerate(layers) for k in range(n)]
    filled, freed = 0, [0, 0]  # slabs the producer copied; slabs each consumer released
    pos, turn_of, got_turn = [0, 0], [0, 1], [False, False]  # next slab; whose turn
    turn = 0
    while pos != [len(order)] * 2:
        moved = False
        while filled < len(order) and filled - min(freed) < stages:
            filled += 1
            moved = True
        for c in (0, 1):
            if pos[c] == len(order):
                continue
            li, k = order[pos[c]]
            if k == 0 and not got_turn[c]:
                if turn != c:
                    continue
                got_turn[c] = True
            if pos[c] >= filled:
                continue
            pos[c] += 1
            freed[c] = pos[c] - 1 if pos[c] < len(order) and order[pos[c]][1] else pos[c]
            n = layers[li]
            if k + 1 == (min(n, hand) if hand else n):
                turn, got_turn[c] = 1 - c, False
            moved = True
        if not moved:
            return False
    return True


def test_split_turns_never_deadlock_the_ring():
    """A model of the ring and the turns: FreeNeRF's program (first layer 2
    slabs, four of 4, the join of 6, two of 4, the feature layer 4, the
    views layer 4) deadlocks a ring of 5 with turns of whole layers, and
    runs with turns handed on after 5 slabs; today's programs run on 6."""
    free = [2, 4, 4, 4, 4, 6, 4, 4, 4, 4]
    assert not _turns(free, 5, 0)
    assert _turns(free, 5, 5)
    assert _turns([1, 4, 4, 4, 4, 5, 4, 4, 4, 4], 6, 0)
    assert all(_turns(free, s, s) for s in (2, 3, 4))
