"""Faults planted in the program under test, to show that the check fails
them: the fault tests (tests/test_bench_faults.py) and calibrate.py's
--faults. Each is a context manager that patches the program and restores it.

Training: "unchanged" (the optimizer step returns the state unchanged),
"half" (half of each part of the batch left out, the mean taken over the
rest: its second half gathers the first half's rays), "alter" (the fine
MLP's colour altered by 0.01 where the field produces it), "stale" (every
step reads the inputs staged for the first: its rays, draws, loss weights
and Adam scalars, as a replay would that the host stage no longer feeds).
Render: "stale" (each frame returns the first frame's answer), "half" (the
second half of each chunk's rays answered with the first half's outputs),
"alter" (the first chunk's colour altered by 0.02 where it is produced).
"""

from __future__ import annotations

import contextlib

import torch

TRAIN_FAULTS = ("unchanged", "half", "alter", "stale")
RENDER_FAULTS = ("stale", "half", "alter")


@contextlib.contextmanager
def _patched(owner, name, new):
    old = getattr(owner, name)
    setattr(owner, name, new(old))
    try:
        yield
    finally:
        setattr(owner, name, old)


def _dup_halves(x: torch.Tensor, parts: int) -> torch.Tensor:
    """x with the second half of each of `parts` equal blocks replaced by its first half."""
    x = x.clone()
    n = x.shape[0] // parts
    for p in range(parts):
        a, q = p * n, n // 2
        x[a + q : a + 2 * q] = x[a : a + q]
    return x


@contextlib.contextmanager
def planted(name: str, cell):
    from simplenerf_torch.render import renderer
    from simplenerf_torch.training import tester, trainer

    kind = cell.traffic["kind"]
    if kind == "train" and name == "unchanged":
        ctx = _patched(trainer.FlatAdam, "step", lambda old: lambda self, *a, **k: None)
    elif kind == "train" and name == "half":
        def new(old):
            def batch(self, indices, mask_nerf, mask_sd):
                return old(self, _dup_halves(torch.as_tensor(indices, device=self.device), 2),
                           mask_nerf, mask_sd)
            return batch
        ctx = _patched(trainer.Trainer, "batch", new)
    elif kind == "train" and name == "alter":
        ns_coarse = cell.config["train_configs"]["model"]["coarse_mlp"]["num_samples"]

        def new(old):
            def eval_mlp(params, mcfg, pts, *a, **k):
                out = old(params, mcfg, pts, *a, **k)
                if pts.shape[1] > ns_coarse:  # the fine level
                    out["rgb"] = out["rgb"] + 0.01
                return out
            return eval_mlp
        ctx = _patched(renderer, "_eval_mlp", new)
    elif kind == "train" and name == "stale":
        def new(old):
            def write(self, *a, **k):
                if not getattr(self, "_written", False):
                    old(self, *a, **k)
                    self._written = True
            return write
        ctx = _patched(trainer.StepInputs, "write", new)
    elif kind == "render" and name == "stale":
        def new(old):
            first = {}

            def predict_frame(self, *a, **k):
                if "out" not in first:
                    first["out"] = old(self, *a, **k)
                return first["out"]
            return predict_frame
        ctx = _patched(tester.Tester, "predict_frame", new)
    elif kind == "render" and name in ("half", "alter"):
        def new(old):
            def render_in_chunks(eval_step, params, batch, chunk):
                def step(p, rays):
                    out = eval_step(p, rays)
                    if name == "half":
                        return {k: _dup_halves(v, 1) for k, v in out.items()}
                    if not step.done:
                        step.done = True
                        out = dict(out, rgb_fine=out["rgb_fine"] + 0.02)
                    return out
                step.done = False
                return old(step, params, batch, chunk)
            return render_in_chunks
        ctx = _patched(tester, "render_in_chunks", new)
    else:
        raise ValueError(f"no fault {name!r} for {kind} traffic")
    with ctx:
        yield
