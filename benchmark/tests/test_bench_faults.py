"""The check fails a broken timed path: each fault a cell can have, planted
in the program underneath a whole run (the harness's look for a card
skipped), and the control (the reference in the next precision below, in
the program's place) both come out not correct. The faults are planted in
the tiny cells run in float32, whose sound runs are correct under the
cells' limits (tested first), so that a fault is what fails them."""

import pytest

from benchmark import faults, harness, reference
from benchmark.kinds import render, train
from benchmark.tests.conftest import SEED

CASES = [(n, f) for n in ("simplenerf_f32.train", "simplenerf_bf16.train") for f in faults.TRAIN_FAULTS]
CASES += [("simplenerf_bf16.render", f) for f in faults.RENDER_FAULTS]


def float32(cell):
    cell.config["train_configs"]["model"]["compute_dtype"] = cell.dtype = "float32"
    return cell


@pytest.mark.parametrize("name", sorted({n for n, _ in CASES}))
def test_sound_run_is_correct(name, tiny_cell, run_tiny):
    res = run_tiny(float32(tiny_cell(name)))
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("name,fault", CASES)
def test_planted_fault_is_not_correct(name, fault, tiny_cell, run_tiny):
    cell = float32(tiny_cell(name))
    with faults.planted(fault, cell):
        res = run_tiny(cell)
    assert res["correct"] is False, res["checks"]
    assert res["failed"] > 0


@pytest.mark.parametrize("name", ["simplenerf_f32.train", "simplenerf_bf16.train"])
def test_training_control_is_not_correct(name, tiny_cell, monkeypatch):
    import torch

    cell = tiny_cell(name)
    dev = torch.device("cpu")
    seed = SEED % 2**31
    raw = train.scene.make_llff_scene(SEED, cell.config["assumed"], dev)
    cfg = dict(cell.config["train_configs"], seed=seed)
    st = {"raw": raw, "cfg": cfg, "params0": train.scene.make_weights(SEED, cfg, dev), "seed": seed}
    ref = train.reference_steps(st, cell, dev)
    ctl = train.reference_steps(st, cell, dev, reference.CONTROL[cell.dtype])
    ok, checks = harness.judge(train.compare(train.as_got(ctl), ref)["numbers"], cell.limits)
    assert not ok, checks


def test_render_control_is_not_correct(tiny_cell):
    import torch

    cell = tiny_cell("simplenerf_bf16.render")
    dev = torch.device("cpu")
    raw = render.scene.make_llff_scene(SEED, cell.config["assumed"], dev)
    cfg = cell.config["train_configs"]
    params = render.scene.make_weights(SEED, cfg, dev, cell.config["assumed"]["render_sigma_bias"])
    poses = render.scene.spiral_poses(SEED, raw, 4, cell.traffic["radius_scale"])
    st = {"raw": raw, "cfg": cfg, "params": params, "poses": poses, "frames": [(0, None), (1, None)]}

    def control(pose, pixels):
        return reference.render_frame(raw, cfg, params, pose, reference.CONTROL[cell.dtype], dev,
                                      pixels=pixels)

    cmp = render.check(st, cell, SEED, dev, answer=control)
    ok, checks = harness.judge(cmp["numbers"], cell.limits)
    assert not ok, checks
