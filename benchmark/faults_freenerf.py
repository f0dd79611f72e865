"""Faults of FreeNeRF's step, planted in the program under test to show
that the FreeNeRF cell's check fails them (calibrate_freenerf.py --faults,
tests/test_torch_port_freenerf.py), and the training faults of `faults.py`
that apply to it ("unchanged", "half", "stale").

"no_variance": the IPE without its variance term (the frustums' means
through the plain PE); "no_mask": the frequency masks all ones; "merged":
the fine level on the coarse and fine edges merged (every second edge of
their sorted union, so that the level keeps its intervals); "coarse_weight_1":
the coarse level's MSE at weight 1 in place of 0.1.
"""

from __future__ import annotations

import contextlib
import types

import torch

from benchmark import faults

FREE_FAULTS = ("no_variance", "no_mask", "merged", "coarse_weight_1")
TRAIN_FAULTS = ("unchanged", "half", "stale")


@contextlib.contextmanager
def planted(name: str, cell):
    from simplenerf_torch.losses import freenerf
    from simplenerf_torch.ops import fused_mlp
    from simplenerf_torch.render import mip

    if name == "no_variance":
        def new(old):
            def ipe_operands(rays_o, rays_d, radii, t, deg, mask, cdtype):
                mean, _ = fused_mlp.frustum_gaussians(rays_o, rays_d, radii, t)
                lo, _ = fused_mlp.pe_operands_reference(mean.reshape(-1, 3).contiguous(), deg, deg,
                                                        torch.float32)
                return (lo * mask if mask is not None else lo).to(cdtype).contiguous()
            return ipe_operands
        ctx = faults._patched(fused_mlp, "ipe_operands", new)
    elif name == "no_mask":
        ctx = faults._patched(mip, "step_masks",
                              lambda old: lambda mcfg, step, end: old(mcfg, end, end))
    elif name == "merged":
        def new(old):
            def resample(t, weights, u):
                both = torch.cat([t, old(t, weights, u)], dim=-1)
                return torch.sort(both, dim=-1).values[:, ::2].contiguous()
            return resample
        ctx = faults._patched(mip, "resample", new)
    elif name == "coarse_weight_1":
        ctx = faults._patched(freenerf, "make_mip_mse", lambda old: lambda coarse_weight=0.1: old(1.0))
    elif name in TRAIN_FAULTS:
        ctx = faults.planted(name, types.SimpleNamespace(traffic={"kind": "train"}, config=cell.config))
    else:
        raise ValueError(f"no FreeNeRF fault {name!r}")
    with ctx:
        yield
