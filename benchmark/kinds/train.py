"""Training traffic: calls of `Trainer.train_many(it, steps_per_call)`, which
on a card replay one CUDA graph of the step body, step by step.

Set-up builds one Trainer with the benchmark's weights and hands that same
object to the window. Its first call (two steps) captures the graph; the
capture's first step runs eagerly as its warm-up. The benchmark's weights
and a fresh Adam state are then written back into the Trainer's own
tensors, which the graph holds, and a call of three steps replays the steps
that the check compares: the first step's gradient, each step's total
loss, and each leaf's change after the three (`tapped_call`). The
reference follows those three steps from the same weights, with its batch
sampler past the two capture steps' draws.
"""

from __future__ import annotations

import copy
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import counts, harness, reference, scene
from benchmark import trace as trace_lib

CAPTURE_STEPS = 2  # the first call: the capture's eager warm-up, then a replay
COMPARED_STEPS = 3


def _prog_leaves(trainer) -> list:
    """[(path, leaf)] of the trainer's parameters in its flat order."""
    items = scene.tree_items(trainer.params)
    if [id(p) for _, p in items] != [id(p) for p in trainer.leaves]:
        raise RuntimeError("the trainer's flat order is not the sorted tree order")
    return items


@torch.no_grad()
def restore(trainer, params0):
    """Write `params0` and a fresh Adam state into the trainer's own tensors
    (those its captured graph reads and updates)."""
    p0 = dict(scene.tree_items(params0))
    for path, p in _prog_leaves(trainer):
        p.copy_(p0[path])
    trainer.opt_state["mu"].zero_()
    trainer.opt_state["nu"].zero_()
    trainer.opt_state["count"] = 0


def tapped_call(trainer, start: int, params0) -> dict:
    """`train_many(start, COMPARED_STEPS)` with each step's loss values and,
    after the first, Adam's first moment copied as the step is enqueued
    (after its replay on a card, after its body on the CPU), in stream
    order. Returns the steps' total losses, the first step's gradient as
    Adam holds it (mu / (1 - b1) after one step from a fresh state), and
    each leaf's change after the steps."""
    snaps: list = []

    def tap(values):
        snaps.append({"loss": values["TotalLoss"].detach().clone(),
                      "mu": trainer.opt_state["mu"].clone() if not snaps else None})
        return values

    graph = trainer._graph
    if graph is not None:
        replay = graph.replay
        graph.replay = lambda: (replay(), tap(graph.out))
    else:
        body = trainer.body
        trainer.body = lambda inputs: tap(body(inputs))
    try:
        trainer.train_many(start, COMPARED_STEPS)
    finally:
        if graph is not None:
            del graph.replay
        else:
            del trainer.body
    if len(snaps) != COMPARED_STEPS:
        raise RuntimeError(f"tapped {len(snaps)} steps of {COMPARED_STEPS}")
    mu, grad, pos = snaps[0]["mu"], {}, 0
    p0 = dict(scene.tree_items(params0))
    delta = {}
    for path, p in _prog_leaves(trainer):
        grad[path] = (mu[pos : pos + p.numel()].view_as(p) / (1 - trainer.opt.b1)).clone()
        delta[path] = (p.detach() - p0[path]).clone()
        pos += p.numel()
    return {"loss": {s + 1: float(x["loss"]) for s, x in enumerate(snaps)}, "grad": grad,
            "delta": delta, "replayed": graph is not None}


def setup(cell, seed: int, device, workdir: Path) -> dict:
    """Scene, preprocessor, the Trainer with the benchmark's weights, its
    graph captured, and the compared steps replayed (module docstring)."""
    from simplenerf_torch.data.preprocessor import ScenePreprocessor
    from simplenerf_torch.training.trainer import Trainer

    cfg = copy.deepcopy(cell.config["train_configs"])
    s31 = seed % 2**31
    cfg["seed"] = s31
    raw = scene.make_llff_scene(seed, cell.config["assumed"], device)
    pp = ScenePreprocessor(cfg, "train", raw, device=device, seed=s31)
    trainer = Trainer(cfg, workdir / "run", pp)
    params0 = scene.make_weights(seed, cfg, device)
    trainer.set_params(params0)
    start = cell.traffic["start_iter"]
    trainer.train_many(start, CAPTURE_STEPS)
    restore(trainer, params0)
    got = tapped_call(trainer, start + CAPTURE_STEPS, params0)
    harness.sync(device)
    return {"cfg": cfg, "raw": raw, "seed": s31, "trainer": trainer, "params0": params0,
            "got": got, "next_iter": start + CAPTURE_STEPS + COMPARED_STEPS}


def run_steps(st: dict, n_steps: int, k: int):
    """`n_steps` steps from the next iteration, in `train_many` calls of k."""
    it = st["next_iter"]
    for _ in range(n_steps // k):
        st["trainer"].train_many(it, k)
        it += k
    st["next_iter"] = it


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
    rate = steps * step_counts(cell)["rays_per_step"] / took
    return steps, rate, [f"window: {steps} steps in {took:.4f} s; steps enqueued by second: {marks}"]


def traced(st: dict, cell, device, workdir: Path) -> dict:
    """A window of the cell's own calls profiled on the device alone, a
    shorter one with the host's ops to label the idle gaps, and eager steps
    under the profiler for op-scoped kernel time."""
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
    ctx["counts"] = step_counts(cell)
    return ctx


def step_counts(cell) -> dict:
    cfg = cell.config["train_configs"]
    mlps = scene.model_mlps(cfg)
    dl = cfg["data_loader"]
    nr = dl["num_rays"] + dl["sparse_depth"]["num_rays"]
    ns_c = mlps["coarse"]["num_samples"]
    ns_f = ns_c + mlps["fine"]["num_samples"]
    trio = [mlps[n] for n, _ in reference.COARSE_MEMBERS if n in mlps]
    dt = cell.dtype
    return {
        "rays_per_step": nr,
        "step_flops": counts.train_step_flops(mlps, nr),
        "fwd_bound_s": counts.bound_s(counts.fwd_op([mlps["fine"]], nr, ns_f, dt), dt)
        + counts.bound_s(counts.fwd_op(trio, nr, ns_c, dt), dt),
        "bwd_bound_s": counts.bound_s(counts.bwd_op([mlps["fine"]], nr, ns_f, dt), dt)
        + counts.bound_s(counts.bwd_op(trio, nr, ns_c, dt), dt),
    }


def release(st: dict):
    st.pop("trainer")


def reference_steps(st: dict, cell, device, precision=None) -> dict:
    """The reference's run of the compared steps, in `precision` (the
    configuration's own by default)."""
    return reference.train_steps(st["raw"], st["cfg"], st["params0"], st["seed"],
                                 cell.traffic["start_iter"] + CAPTURE_STEPS, COMPARED_STEPS,
                                 precision or cell.dtype, device, skip=CAPTURE_STEPS)


def check(st: dict, cell, seed: int, device) -> dict:
    return compare(st["got"], reference_steps(st, cell, device))


def as_got(ref: dict) -> dict:
    """A reference run in the program's place (the control, a witness)."""
    return {"loss": {s + 1: x for s, x in enumerate(ref["loss"])}, "grad": ref["grad"],
            "delta": ref["delta"]}


def compare(got: dict, ref: dict) -> dict:
    """The numbers a training cell's limits may name: the total loss's
    relative gap (the worst compared step, and step 1 alone), and the gap
    of each leaf's norm, first gradient and change after the steps (the
    worst leaf and the median leaf; the change only of leaves the
    reference's gradient moves)."""
    def rel(s):
        return abs(got["loss"][s] - ref["loss"][s - 1]) / max(abs(ref["loss"][s - 1]), 1e-30)

    gnorm = {k: float(v.norm()) for k, v in ref["grad"].items()}
    med = float(np.median(list(gnorm.values())))
    moved = lambda path: gnorm[path] >= 1e-3 * med  # noqa: E731
    grad_gap, grad_leaf, grad_med = reference.leaf_gap(got["grad"], ref["grad"])
    delta_gap, delta_leaf, delta_med = reference.leaf_gap(got["delta"], ref["delta"], moved)
    numbers = {"loss_gap": max(rel(s) for s in got["loss"]), "loss1_gap": rel(1),
               "grad_gap": grad_gap, "grad_gap_median": grad_med,
               "delta_gap": delta_gap, "delta_gap_median": delta_med}
    return {"numbers": numbers,
            "where": {"grad_gap": grad_leaf, "delta_gap": delta_leaf,
                      "excluded": sorted(p for p in gnorm if not moved(p))},
            "replayed": got.get("replayed"), "ref_loss": ref["loss"], "got_loss": got["loss"],
            "ref_values": ref["values"]}
