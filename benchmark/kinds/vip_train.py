"""ViP-NeRF training traffic: calls of `Trainer.train_many(it, steps_per_call)`
on the ViP-NeRF configuration, whose step renders every ray at its frame's
other train cameras (the secondary views) and trains the visibility prior.

As the "train" kind (`kinds/train.py`, whose capture, tapped replays,
window and comparison it reuses), with the scene's visibility-prior masks
made from the seed, the plain reference `reference_vipnerf.py`, and two
numbers more, `prior_gap` and `vis2_gap` (`compare`), both read from the
compared steps as the captured graph replays them. The masks: a pixel's
mask for another frame is 1 where the point of the scene's plane that it
sees projects inside that frame, else 0, in the loader's layout (n, n-1,
h, w), column j of a frame its j-th other frame.

Set-up raises where the program's train step renders no secondary views
(no `train_sec_views`, or no `visibility2_fine` among the step's
secondary visibility after the capture): such a program cannot run this
cell.
"""

from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import torch

from benchmark import counts_vipnerf, harness, reference_vipnerf, scene
from benchmark import trace as trace_lib
from benchmark.kinds import train as base

CAPTURE_STEPS, COMPARED_STEPS = base.CAPTURE_STEPS, base.COMPARED_STEPS
PRIOR = "VisibilityPriorLoss01"
LEVELS = ("coarse", "fine")
NO_SECONDARY = ("the program's train step renders no secondary views (no visibility2_fine): "
                "ViP-NeRF's prior is not trained")
window, release = base.window, base.release


def prior_masks(seed: int, assumed: dict, device) -> np.ndarray:
    """(n, n-1, h, w) bool: where each frame's plane point lies inside each
    other frame's image, in front of its camera."""
    s = scene.scene_scalars(seed, assumed)
    h, w, n, f = assumed["height"], assumed["width"], assumed["train_frames"], assumed["focal"]
    K = np.array([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]])
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float64),
                            torch.arange(w, device=device, dtype=torch.float64), indexing="ij")
    out = np.zeros((n, n - 1, h, w), bool)
    for a in range(n):
        pts, _ = scene._plane_hits(s["c2ws"][a], K, s["plane"], xs, ys, device)
        for j, b in enumerate(i for i in range(n) if i != a):
            R = torch.as_tensor(s["c2ws"][b][:3, :3], device=device)
            c = torch.as_tensor(s["c2ws"][b][:3, 3], device=device)
            cam = (pts - c) @ R  # camera b's frame: x right, y down, z forward
            u = f * cam[..., 0] / cam[..., 2] + w / 2.0
            v = f * cam[..., 1] / cam[..., 2] + h / 2.0
            inside = (cam[..., 2] > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
            out[a, j] = inside.cpu().numpy()
    return out


def make_scene(seed: int, assumed: dict, device) -> dict:
    """The loader's output for the train scene with its prior masks."""
    raw = scene.make_llff_scene(seed, assumed, device)
    raw["visibility_prior_data"] = {"masks": prior_masks(seed, assumed, device)}
    return raw


def tapped_call(trainer, start: int, params0) -> dict:
    """`kinds/train.py`'s tapped call, with each compared step's
    VisibilityPriorLoss01 (`prior`) and each level's secondary visibility
    of every row of its batch (`vis2`, (rows, k)) copied as the step is
    enqueued too."""
    kept = []

    def keep(values):
        kept.append((values[PRIOR].detach().clone(),
                     {lv: trainer.step_visibility2[f"visibility2_{lv}"].clone() for lv in LEVELS}))
        return values

    graph = trainer._graph
    if graph is not None:  # base.tapped_call wraps this, then deletes the attribute
        replay = graph.replay
        graph.replay = lambda: (replay(), keep(graph.out))
    else:
        body = trainer.body
        trainer.body = lambda inputs: keep(body(inputs))
    got = base.tapped_call(trainer, start, params0)
    got["prior"] = {s + 1: float(p) for s, (p, _) in enumerate(kept)}
    got["vis2"] = {s + 1: {lv: v.float().cpu() for lv, v in vis2.items()}
                   for s, (_, vis2) in enumerate(kept)}
    return got


def compare(got: dict, ref: dict) -> dict:
    """`kinds/train.py`'s numbers and the secondary views' own: `prior_gap`,
    the worst compared step's relative gap of VisibilityPriorLoss01 (a
    calibration reading: the lower-precision control hardly moves it, so
    the cell's limits leave it out), and `vis2_gap`, the largest gap of a
    ray's secondary visibility at either level over every row of the
    compared steps (the cameras' directions to a sample differ by a few
    degrees, so a mean over the batch hides a wrong direction)."""
    out = base.compare(got, ref)
    want = [v[PRIOR] for v in ref["values"]]
    out["numbers"]["prior_gap"] = max(abs(got["prior"][s] - w) / max(abs(w), 1e-30)
                                      for s, w in enumerate(want, 1))
    out["numbers"]["vis2_gap"] = max(float((got["vis2"][s][lv] - v).abs().max())
                                     for s, step in enumerate(ref["vis2"], 1)
                                     for lv, v in step.items())
    out["ref_prior"], out["got_prior"] = want, got["prior"]
    return out


def as_got(ref: dict) -> dict:
    """A reference run in the program's place (the control)."""
    return dict(base.as_got(ref), prior={s + 1: v[PRIOR] for s, v in enumerate(ref["values"])},
                vis2={s + 1: v for s, v in enumerate(ref["vis2"])})


def setup(cell, seed: int, device, workdir: Path) -> dict:
    """Scene with prior masks, the Trainer with the benchmark's weights, its
    graph captured, the compared steps replayed; raises where the step
    renders no secondary views."""
    from simplenerf_torch.data.preprocessor import ScenePreprocessor
    from simplenerf_torch.training.trainer import Trainer

    cfg = copy.deepcopy(cell.config["train_configs"])
    s31 = seed % 2**31
    cfg["seed"] = s31
    raw = make_scene(seed, cell.config["assumed"], device)
    pp = ScenePreprocessor(cfg, "train", raw, device=device, seed=s31)
    trainer = Trainer(cfg, workdir / "run", pp)
    params0 = scene.make_weights(seed, cfg, device)
    trainer.set_params(params0)
    start = cell.traffic["start_iter"]
    if not getattr(trainer, "train_sec_views", False):
        raise RuntimeError(NO_SECONDARY)
    trainer.train_many(start, CAPTURE_STEPS)
    if set(trainer.step_visibility2) != {f"visibility2_{lv}" for lv in LEVELS}:
        raise RuntimeError(NO_SECONDARY)
    base.restore(trainer, params0)
    got = tapped_call(trainer, start + CAPTURE_STEPS, params0)
    harness.sync(device)
    return {"cfg": cfg, "raw": raw, "seed": s31, "trainer": trainer, "params0": params0,
            "got": got, "next_iter": start + CAPTURE_STEPS + COMPARED_STEPS}


def traced(st: dict, cell, device, workdir: Path) -> dict:
    """As the train kind's traced run, with this configuration's counts."""
    tr = cell.traffic
    k = tr["steps_per_call"]
    ctx: dict = {}
    events, seconds = harness.profiled(device, lambda: base.run_steps(st, tr["trace_steps"], k),
                                       "bench::window", workdir, host=False)
    ctx["window"] = harness.window_summary(events, seconds)
    ctx["window"]["steps"] = ctx["attempted"] = tr["trace_steps"] // k * k
    events, _ = harness.profiled(device, lambda: base.run_steps(st, tr["label_steps"], k),
                                 "bench::labels", workdir)
    ctx["window"]["idle_gaps"] = harness.gap_labels(events, "bench::labels")
    events, _ = harness.profiled(device, lambda: base.run_steps(st, tr["op_steps"], 1), "bench::ops",
                                 workdir)
    ctx["ops"] = {"us": trace_lib.op_scoped_us(events), "units": tr["op_steps"]}
    ctx["counts"] = counts_vipnerf.step_counts(cell)
    return ctx


def reference_steps(st: dict, cell, device, precision=None) -> dict:
    """The ViP-NeRF reference's run of the compared steps, in `precision`
    (the configuration's own by default)."""
    return reference_vipnerf.train_steps(st["raw"], st["cfg"], st["params0"], st["seed"],
                                         cell.traffic["start_iter"] + CAPTURE_STEPS, COMPARED_STEPS,
                                         precision or cell.dtype, device, skip=CAPTURE_STEPS)


def check(st: dict, cell, seed: int, device) -> dict:
    return compare(st["got"], reference_steps(st, cell, device))
