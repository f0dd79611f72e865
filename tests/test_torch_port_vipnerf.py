"""ViP-NeRF on the port: its train step against the plain reference
(benchmark/reference_vipnerf.py), the secondary-view path's plain version
against the concat-form field, and what the model key changes.

- One ViP-NeRF step through `Trainer.body` at a tiny size (24x32 scene,
  widths 32/16, 8 + 16 samples, 64 + 32 rays, k = 2 secondary views), in
  float32 with the kernels' plain versions (fused "on") and with the
  unfused MLP ("auto"), against the reference: the total and each loss,
  each leaf's gradient and its change after the step's Adam update, as
  ||got - want|| over the larger of the leaf's norm and the median leaf's.
  Both sides are float32 on the CPU and differ by summation order only:
  the losses read 1.6e-7 (relative), the gradients 7.9e-6; the change after
  the first Adam update, lr * g / (|g| + eps), reads 4.8e-4, as an element
  whose gradient is within rounding of 0 takes either sign there. The
  tolerances are 4-30x those readings, and the same step in bf16 against
  the float32 reference reads 8.8e-5, 4.9e-2 and 0.39, which
  `test_bf16_step_fails_the_float32_tolerances` holds.
- `fused_apply` with secondary views in its plain version against
  `apply_reference` with view_dirs2, k = 1, 2, 3: visibility2 and every
  parameter's gradient (float32 reads ~6e-8 and ~2e-7; bf16, whose
  backward rounds its cotangents, reads > 1e-3).
- With `train_secondary_views` off (with_visibility_priors), the step
  renders no secondary views and VisibilityPriorLoss01 stays 0, as in the
  JAX package whose parity tests cover that configuration.
"""

import copy
import json
import math

import numpy as np
import pytest
import torch

from benchmark import counts, counts_vipnerf, reference_vipnerf, scene
from benchmark.kinds import vip_train
from simplenerf_torch.data.preprocessor import ScenePreprocessor
from simplenerf_torch.drivers import llff, presets
from simplenerf_torch.fields import mlp
from simplenerf_torch.render import renderer
from simplenerf_torch.training.trainer import Trainer

SEED = 2**31 + 12345
CPU = torch.device("cpu")
ASSUMED = {"height": 24, "width": 32, "train_frames": 3, "focal": 26.0, "camera_baseline": 0.25,
           "camera_tilt_deg": 2.0, "plane_depth": 4.0, "texture_max_freq": 3.0,
           "sparse_points_per_frame": 60}
TOL = {"loss": 5e-6, "grad": 5e-5, "delta": 2e-3}  # float32 both sides: summation order
START = 10000


def tiny_config(dtype: str = "float32", fused: str = "on") -> dict:
    cfg, _ = llff.build_configs(views=3, scenes=None, iters=100000, compute_dtype=dtype, seed=0,
                                model="vipnerf")
    dl = cfg["data_loader"]
    dl["num_rays"], dl["sparse_depth"]["num_rays"] = 64, 32
    for m in (cfg["model"]["coarse_mlp"], cfg["model"]["fine_mlp"]):
        m["points_net_width"], m["views_net_width"] = 32, 16
        m["num_samples"] = 8
    cfg["model"]["fine_mlp"]["num_samples"] = 16
    cfg["model"]["fused_mlp"] = fused
    cfg["seed"] = SEED % 2**31
    return cfg


def one_step(cfg: dict, tmp_path) -> dict:
    """One step through Trainer.stage and Trainer.body from the benchmark's
    weights: the loss values, each leaf's gradient and change, by path."""
    raw = vip_train.make_scene(SEED, ASSUMED, CPU)
    pp = ScenePreprocessor(cfg, "train", raw, device=CPU, seed=cfg["seed"])
    trainer = Trainer(cfg, tmp_path / "run", pp)
    params0 = scene.make_weights(SEED, cfg, CPU)
    trainer.set_params(params0)
    values = trainer.body(trainer.stage(START))
    p0 = dict(scene.tree_items(params0))
    leaves = scene.tree_items(trainer.params)
    return {"raw": raw, "params0": params0,
            "values": {k: float(v) for k, v in values.items()},
            "grad": {k: p.grad.detach().clone() for k, p in leaves},
            "delta": {k: (p.detach() - p0[k]).clone() for k, p in leaves}}


def gaps(got: dict, cfg: dict) -> dict:
    """The step's largest relative gaps to the float32 reference."""
    ref = reference_vipnerf.train_steps(got["raw"], cfg, got["params0"], cfg["seed"], START, 1,
                                        "float32", CPU)
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    loss = max([rel(got["values"]["TotalLoss"], ref["loss"][0])]
               + [rel(got["values"][n], v) for n, v in ref["values"][0].items()])

    def leaf(key):
        """The worst leaf's ||got - want|| over the larger of its norm and
        the median leaf's (a leaf of near-zero values reads against the
        median, as `reference.leaf_gap` reads them)."""
        norms = {p: float(r.norm()) for p, r in ref[key].items()}
        floor = float(np.median(list(norms.values())))
        return max(float((got[key][p] - r).norm()) / max(norms[p], floor, 1e-30)
                   for p, r in ref[key].items())

    return {"loss": loss, "grad": leaf("grad"), "delta": leaf("delta"),
            "prior": ref["values"][0]["VisibilityPriorLoss01"]}


@pytest.mark.parametrize("fused", ["on", "auto"], ids=["fused_plain", "unfused"])
def test_vipnerf_step_matches_the_reference(tmp_path, fused):
    cfg = tiny_config(fused=fused)
    got = one_step(cfg, tmp_path)
    g = gaps(got, cfg)
    print(f"vipnerf step ({fused}): {g}")
    assert got["values"]["VisibilityPriorLoss01"] > 0 and g["prior"] > 0
    for key, tol in TOL.items():
        assert g[key] <= tol, (key, g[key])


def test_bf16_step_fails_the_float32_tolerances(tmp_path):
    """The tolerances are tighter than bf16 products: the bf16 step against
    the float32 reference exceeds each."""
    cfg = tiny_config("bfloat16")
    g = gaps(one_step(cfg, tmp_path), tiny_config())
    print(f"vipnerf step (bf16 against float32): {g}")
    for key, tol in TOL.items():
        assert g[key] > tol, (key, g[key])


def test_key_off_renders_no_secondary_views(tmp_path, monkeypatch):
    """with_visibility_priors leaves `train_secondary_views` off: no
    secondary origins in the cache, no secondary views in the step's render,
    VisibilityPriorLoss01 0."""
    cfg = tiny_config()
    cfg["model"]["train_secondary_views"] = False
    seen = []
    render = renderer.render_rays
    monkeypatch.setattr(renderer, "render_rays",
                        lambda *a, **k: seen.append(k.get("sec_views_vis")) or render(*a, **k))
    raw = vip_train.make_scene(SEED, ASSUMED, CPU)
    pp = ScenePreprocessor(cfg, "train", raw, device=CPU, seed=cfg["seed"])
    trainer = Trainer(cfg, tmp_path / "run", pp)
    values = trainer.body(trainer.stage(START))
    assert "rays_o2" not in pp.cache and seen == [False]
    assert float(values["VisibilityPriorLoss01"]) == 0.0
    assert float(values["VisibilityLoss01"]) > 0
    assert presets.with_visibility_priors(presets.tiny_synthetic_config())["model"].get(
        "train_secondary_views", False) is False


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_secondary_plain_version_matches_apply_reference(k, dtype):
    cfg = mlp.MLPConfig(points_net_depth=3, points_net_width=32, views_net_width=16,
                        points_pe_degree=3, views_pe_degree=2, predict_visibility=True,
                        skip_layers=(1,))
    params = mlp.init(torch.Generator().manual_seed(k), cfg)
    leaves = {"views0": params["views"][0]["w"], "feature": params["feature"]["w"],
              "pts0": params["pts"][0]["w"], "pts1": params["pts"][1]["w"],
              "views_out_w": params["views_out"]["w"], "views_out_b": params["views_out"]["b"]}
    for p in leaves.values():
        p.requires_grad_(True)
    g = torch.Generator().manual_seed(10 + k)
    nr, ns = 5, 7
    pts = torch.randn((nr * ns, 3), generator=g)
    dirs = torch.nn.functional.normalize(torch.randn((nr, 3), generator=g), dim=-1)
    dirs2 = torch.nn.functional.normalize(torch.randn((nr * ns, k, 3), generator=g), dim=-1)
    weights = torch.randn((nr, ns, k), generator=g)
    want = mlp.apply_reference(params, cfg, pts, view_dirs=dirs.repeat_interleave(ns, 0),
                               view_dirs2=dirs2, dtype=dtype)
    got = mlp.apply_fused(params, cfg, pts, view_dirs=dirs, dtype=dtype, view_dirs_tile=ns,
                          sec=mlp.secondary_operands(params, cfg, dirs2, dtype))
    v_want = want["visibility2"].reshape(nr, ns, k)
    assert got["visibility2"].shape == (nr, ns, k)
    vis_err = float((got["visibility2"] - v_want).detach().abs().max())
    g_want = torch.autograd.grad((v_want * weights).sum(), list(leaves.values()))
    g_got = torch.autograd.grad((got["visibility2"] * weights).sum(), list(leaves.values()))
    grad_err = max(float((a - b).norm() / b.norm()) for a, b in zip(g_got, g_want))
    print(f"secondary plain k={k} {dtype}: visibility2 {vis_err:.2e}, gradients {grad_err:.2e}")
    if dtype == torch.float32:  # the same function: order of sums only
        assert vis_err <= 1e-6 and grad_err <= 1e-5
    else:  # the kernels' roundings (rounded cotangents) against autograd's
        assert vis_err <= 1e-3 and 1e-5 < grad_err <= 2e-2


def test_gathered_secondary_origins_follow_the_prior_masks_columns():
    """Column j of a ray's rays_o2 is its frame's j-th other frame's camera
    centre, the column order of its prior masks."""
    cfg = tiny_config()
    raw = vip_train.make_scene(SEED, ASSUMED, CPU)
    pp = ScenePreprocessor(cfg, "train", raw, device=CPU, seed=cfg["seed"])
    h, w = pp.resolution
    idx = torch.tensor([0, h * w + 5, 2 * h * w + 7], dtype=torch.int32)
    from simplenerf_torch.data.preprocessor import gather_batch

    mask = torch.ones(3, dtype=torch.bool)
    batch = gather_batch(pp.cache, pp.common, pp.batch_constants(), idx, mask, ~mask,
                         packed_layout=pp.packed_layout)
    centres = pp.common["poses"][:, :3, 3]
    assert batch["rays_o2"].shape == (3, 2, 3)
    for r, f in enumerate((0, 1, 2)):
        others = [o for o in range(3) if o != f]
        assert torch.equal(batch["rays_o2"][r], centres[others])
        want = np.asarray(raw["visibility_prior_data"]["masks"], np.float32)[f, :, 0, [0, 5, 7][r]]
        assert np.array_equal(batch["visibility_prior_masks"][r].numpy(), want)


def test_prior_masks_mark_pixels_seen_by_the_other_frame():
    masks = vip_train.prior_masks(SEED, ASSUMED, CPU)
    assert masks.shape == (3, 2, 24, 32) and masks.dtype == bool
    assert 0.5 < masks.mean() < 1.0  # most pixels, not all: the frames' edges


def test_config_file_is_the_drivers_vipnerf_recipe():
    cfg = json.load(open("benchmark/configs/vipnerf_bf16.json"))
    want, _ = llff.build_configs(views=3, scenes=None, iters=100000, compute_dtype="bfloat16", seed=0,
                                 model="vipnerf")
    assert cfg["train_configs"] == json.loads(json.dumps(want))
    assert [s["name"] for s in want["losses"]] == ["MSE01", "SparseDepthMSE01", "VisibilityLoss01",
                                                   "VisibilityPriorLoss01"]
    assert "points_augmentation" not in want["model"] and want["model"]["train_secondary_views"]


def test_secondary_counts_by_hand():
    mlp_dict = {"points_net_depth": 8, "views_net_depth": 1, "points_net_width": 4,
                "views_net_width": 2, "points_positional_encoding_degree": 1,
                "views_positional_encoding_degree": 1, "use_view_dirs": True,
                "view_dependent_rgb": True, "predict_visibility": True, "num_samples": 2}
    assert counts_vipnerf.pair_macs(mlp_dict) == 9 * 2 + 2
    nr, ns, k = 5, 2, 3
    n = nr * ns
    f = counts_vipnerf.fwd_op(mlp_dict, nr, ns, k, "bfloat16")
    base = counts.fwd_op([mlp_dict], nr, ns, "bfloat16")
    assert f["flops"] == base["flops"] + 2 * n * k * 20
    assert f["bytes"] == base["bytes"] + n * k * (9 * 2 + 4)
    b = counts_vipnerf.bwd_op(mlp_dict, nr, ns, k, "bfloat16")
    assert b["flops"] == counts.bwd_op([mlp_dict], nr, ns, "bfloat16")["flops"] + 2 * n * k * (3 * 20 - 18)
    mlps = {"coarse": mlp_dict, "fine": dict(mlp_dict, num_samples=3)}
    assert counts_vipnerf.train_step_flops(mlps, nr, k) == (
        counts.train_step_flops(mlps, nr) + 2 * nr * (2 + 5) * k * (3 * 20 - 18))
    published = tiny_config()["model"]["fine_mlp"] | {"points_net_width": 256, "views_net_width": 128}
    assert counts_vipnerf.pair_macs(published) == 27 * 128 + 128
    assert math.isclose(counts.fwd_macs(published), 590080)


def test_vipnerf_preset_is_the_published_widths():
    cfg = presets.vipnerf_config()
    m = cfg["model"]
    assert [m[k]["points_net_width"] for k in ("coarse_mlp", "fine_mlp")] == [256, 256]
    assert (m["coarse_mlp"]["num_samples"], m["fine_mlp"]["num_samples"]) == (64, 128)
    assert m["coarse_mlp"]["predict_visibility"] and m["fine_mlp"]["predict_visibility"]
    assert cfg["data_loader"]["visibility_prior"]["masks_dirname"] == "VW02"
    assert copy.deepcopy(cfg) == presets.with_vip_prior(presets.simplenerf_config(with_augmentations=False))


def tiny_cell(dtype: str = "float32"):
    """The ViP-NeRF cell at the tiny size of `tiny_config`, a short window."""
    from benchmark import harness

    cell = harness.Cell("vipnerf_bf16.vip_train")
    cell.config["train_configs"] = tiny_config(dtype)
    cell.config["assumed"].update(ASSUMED)
    cell.dtype = dtype
    cell.traffic.update(steps_per_call=2, trace_steps=4, label_steps=4, op_steps=1)
    return cell


def test_vip_cell_runs_correct_on_the_cpu():
    """A whole run of the cell (set-up with the secondary-view probe, window,
    check) through the harness; in float32 every number reads far under its
    card limit (rounding only)."""
    import time

    from benchmark import harness

    res = harness.run(tiny_cell(), SEED, 0.3, False, CPU, time.perf_counter(), forbid=False)
    assert res["attempted"] > 0 and res["correct"] is True, res["checks"]
    for name in ("vis2_gap", "grad_gap", "delta_gap"):
        assert res["checks"][name]["value"] <= 0.1 * res["checks"][name]["limit"], name


@pytest.mark.parametrize("fault", ["no_prior", "primary_dir"])
def test_vip_faults_fail_the_check(tmp_path, fault):
    """The secondary views' two planted faults fail the cell's limits: no
    prior loss (the gradient, grad_gap, as on the card), secondary
    visibility at the primary direction (vis2_gap, read from the compared
    steps)."""
    from benchmark import faults_vipnerf, harness

    cell = tiny_cell()
    with faults_vipnerf.planted(fault, cell):
        st = vip_train.setup(cell, SEED, CPU, tmp_path)
    vip_train.release(st)
    numbers = vip_train.check(st, cell, SEED, CPU)["numbers"]
    ok, checks = harness.judge(numbers, cell.limits)
    failed = {k for k, c in checks.items() if not c["value"] <= c["limit"]}
    print(f"fault {fault}: {numbers}")
    assert not ok and {"no_prior": "grad_gap", "primary_dir": "vis2_gap"}[fault] in failed, checks
