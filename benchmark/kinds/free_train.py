"""FreeNeRF training traffic: calls of `Trainer.train_many(it, steps_per_call)`
on the FreeNeRF configuration, mip-NeRF's step (one MLP at both levels fed
the integrated PE of its frustums) with FreeNeRF's frequency masks, which
the host stage writes for each step, and its occlusion loss.

As the "train" kind (`kinds/train.py`, whose weights restore, tapped
replays, step loop and comparison it reuses), with this configuration's
weights (one MLP, `params["mlp"]`), scene (no sparse depth), counts
(`counts_freenerf.py`), plain reference (`reference_freenerf.py`) and two
numbers more, read from the compared steps as the captured graph replays
them (`Trainer.step_mip`): `density_gap`, the mean absolute gap of the
per-interval densities of both levels over every row, over the
reference's mean density; and `ipe_gap`, the largest gap of a points
operand channel's mean square over a level's rows (the IPE kernel's
output against the reference's encoding at the configuration's
precision), over the larger of the reference's and a hundredth of its
largest channel's. The traced run adds the IPE kernel's device time in
its eager steps (`ipe`, kernels named `field_ipe_kernel`).

Set-up raises where the program has no FreeNeRF step (no mip-NeRF render
config, or no densities and IPE operands of both levels after the
capture).
"""

from __future__ import annotations

import copy
import math
import time
from pathlib import Path

import torch

from benchmark import counts_freenerf, harness, reference_freenerf, scene
from benchmark import trace as trace_lib
from benchmark.kinds import train as base

CAPTURE_STEPS, COMPARED_STEPS = base.CAPTURE_STEPS, base.COMPARED_STEPS
LEVELS = ("coarse", "fine")
IPE_KERNEL = "field_ipe_kernel"
NO_FREENERF = "the program has no FreeNeRF step (mip-NeRF's one MLP at both levels)"
release, run_steps = base.release, base.run_steps


def make_weights(seed: int, train_configs: dict, device) -> dict:
    """The MLP's parameters from one uniform draw on the device, as
    `scene.make_weights` draws every MLP's: {"mlp": {"pts": [...], ...}}."""
    layers = scene._layer_list(scene.mlp_shapes(train_configs["model"]["mlp"]))
    total = sum(fi * fo + fo for _, (fi, fo) in layers)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32) * 2 - 1
    node, pos = {}, 0
    for path, (fi, fo) in layers:
        bound = 1.0 / math.sqrt(fi)
        layer = {"w": u[pos : pos + fi * fo].view(fi, fo) * bound,
                 "b": u[pos + fi * fo : pos + fi * fo + fo] * bound}
        pos += fi * fo + fo
        if len(path) == 2:
            node.setdefault(path[0], []).append(layer)
        else:
            node[path[0]] = layer
    return {"mlp": node}


def tapped_call(trainer, start: int, params0) -> dict:
    """`kinds/train.py`'s tapped call, with each compared step's densities
    of both levels (`density`, (rows, intervals)) and its IPE operands'
    channel mean squares (`ipe`, (channels,)) taken as it is enqueued."""
    kept = []

    def keep(values):
        mip = trainer.step_mip
        kept.append(({lv: mip[f"density_{lv}"].clone() for lv in LEVELS},
                     {lv: mip[f"ipe_{lv}"].float().square().mean(0) for lv in LEVELS}))
        return values

    graph = trainer._graph
    if graph is not None:  # base.tapped_call wraps this, then deletes the attribute
        replay = graph.replay
        graph.replay = lambda: (replay(), keep(graph.out))
    else:
        body = trainer.body
        trainer.body = lambda inputs: keep(body(inputs))
    got = base.tapped_call(trainer, start, params0)
    got["density"] = {s + 1: {lv: v.float().cpu() for lv, v in d.items()} for s, (d, _) in enumerate(kept)}
    got["ipe"] = {s + 1: {lv: v.cpu() for lv, v in m.items()} for s, (_, m) in enumerate(kept)}
    return got


def setup(cell, seed: int, device, workdir: Path) -> dict:
    """Scene, the Trainer with the benchmark's weights, its graph captured,
    the compared steps replayed; raises where the program has no FreeNeRF
    step."""
    from simplenerf_torch import config as config_lib
    from simplenerf_torch.data.preprocessor import ScenePreprocessor
    from simplenerf_torch.training.trainer import Trainer

    cfg = copy.deepcopy(cell.config["train_configs"])
    if getattr(config_lib.render_config_from_dict(cfg), "shared_mlp", None) is None:
        raise RuntimeError(NO_FREENERF)
    s31 = seed % 2**31
    cfg["seed"] = s31
    raw = scene.make_llff_scene(seed, cell.config["assumed"], device)
    pp = ScenePreprocessor(cfg, "train", raw, device=device, seed=s31)
    trainer = Trainer(cfg, workdir / "run", pp)
    params0 = make_weights(seed, cfg, device)
    trainer.set_params(params0)
    start = cell.traffic["start_iter"]
    trainer.train_many(start, CAPTURE_STEPS)
    if set(getattr(trainer, "step_mip", {})) != {f"{k}_{lv}" for k in ("density", "ipe") for lv in LEVELS}:
        raise RuntimeError(NO_FREENERF)
    base.restore(trainer, params0)
    got = tapped_call(trainer, start + CAPTURE_STEPS, params0)
    harness.sync(device)
    return {"cfg": cfg, "raw": raw, "seed": s31, "trainer": trainer, "params0": params0,
            "got": got, "next_iter": start + CAPTURE_STEPS + COMPARED_STEPS}


def window(st: dict, cell, seconds: float, device) -> tuple:
    """Calls of the cell's `steps_per_call` until `seconds` have passed,
    closed on a device synchronisation: rays a second over all of them."""
    k, steps, marks = cell.traffic["steps_per_call"], 0, []
    t0 = time.perf_counter()
    while True:
        run_steps(st, k, k)
        steps += k
        t = time.perf_counter() - t0
        if t >= len(marks) + 1:
            marks.append(steps)
        if t >= seconds:
            break
    harness.sync(device)
    took = time.perf_counter() - t0
    rate = steps * counts_freenerf.step_counts(cell)["rays_per_step"] / took
    return steps, rate, [f"window: {steps} steps in {took:.4f} s; steps enqueued by second: {marks}"]


def traced(st: dict, cell, device, workdir: Path) -> dict:
    """As the train kind's traced run, with this configuration's counts and
    the IPE kernel's device time a step in the eager steps."""
    tr = cell.traffic
    k = tr["steps_per_call"]
    ctx: dict = {}
    events, seconds = harness.profiled(device, lambda: run_steps(st, tr["trace_steps"], k),
                                       "bench::window", workdir, host=False)
    ctx["window"] = harness.window_summary(events, seconds)
    ctx["window"]["steps"] = ctx["attempted"] = tr["trace_steps"] // k * k
    events, _ = harness.profiled(device, lambda: run_steps(st, tr["label_steps"], k),
                                 "bench::labels", workdir)
    ctx["window"]["idle_gaps"] = harness.gap_labels(events, "bench::labels")
    events, _ = harness.profiled(device, lambda: run_steps(st, tr["op_steps"], 1), "bench::ops",
                                 workdir)
    ctx["ops"] = {"us": trace_lib.op_scoped_us(events), "units": tr["op_steps"]}
    ipe = [float(e["dur"]) for e in events if e.get("cat") == "kernel" and IPE_KERNEL in e["name"]]
    ctx["ipe"] = {"us": sum(ipe), "launches": len(ipe), "units": tr["op_steps"]}
    ctx["counts"] = counts_freenerf.step_counts(cell)
    return ctx


def reference_steps(st: dict, cell, device, precision=None) -> dict:
    """The FreeNeRF reference's run of the compared steps, in `precision`
    (the configuration's own by default)."""
    return reference_freenerf.train_steps(st["raw"], st["cfg"], st["params0"], st["seed"],
                                          cell.traffic["start_iter"] + CAPTURE_STEPS, COMPARED_STEPS,
                                          precision or cell.dtype, device, skip=CAPTURE_STEPS)


def compare(got: dict, ref: dict) -> dict:
    """`kinds/train.py`'s numbers, `density_gap` and `ipe_gap` (module
    docstring)."""
    out = base.compare(got, ref)
    gap = sum(float((got["density"][s][lv] - v).abs().sum())
              for s, step in enumerate(ref["density"], 1) for lv, v in step.items())
    size = sum(float(v.abs().sum()) for step in ref["density"] for v in step.values())
    out["numbers"]["density_gap"] = gap / max(size, 1e-30)
    out["numbers"]["ipe_gap"] = max(
        float(((got["ipe"][s][lv] - v).abs() / torch.maximum(v, 0.01 * v.max())).max())
        for s, step in enumerate(ref["ipe"], 1) for lv, v in step.items())
    return out


def as_got(ref: dict) -> dict:
    """A reference run in the program's place (the control)."""
    return dict(base.as_got(ref), density={s + 1: d for s, d in enumerate(ref["density"])},
                ipe={s + 1: m for s, m in enumerate(ref["ipe"])})


def check(st: dict, cell, seed: int, device) -> dict:
    return compare(st["got"], reference_steps(st, cell, device))
