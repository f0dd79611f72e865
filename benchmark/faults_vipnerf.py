"""Faults of ViP-NeRF's secondary views, planted in the program under test
to show that the ViP-NeRF cell's check fails them (calibrate_vipnerf.py
--faults), and the training faults of `faults.py` on the same cell.

"no_prior": VisibilityPriorLoss01 gives 0 (the step of a program that
trains no secondary views, as the JAX package's); "primary_dir": the
secondary visibility evaluated at the ray's own view direction in place of
each other camera's direction to the sample.
"""

from __future__ import annotations

import contextlib
import types

import torch

from benchmark import faults

VIP_FAULTS = ("no_prior", "primary_dir")


@contextlib.contextmanager
def planted(name: str, cell):
    from simplenerf_torch.losses import visibility
    from simplenerf_torch.render import renderer

    if name == "no_prior":
        def new(old):
            def make():
                fn = old()

                def loss_fn(batch, outputs, return_maps=False):
                    out = fn(batch, outputs, return_maps)
                    total, maps = out if return_maps else (out, {})
                    zero = 0.0 * total
                    return (zero, maps) if return_maps else zero
                return loss_fn
            return make
        ctx = faults._patched(visibility, "make_visibility_prior_loss", new)
    elif name == "primary_dir":
        def new(old):
            def other_view_dirs(cfg, z_vals, rays_o, rays_d, rays_o2):
                d = torch.nn.functional.normalize(rays_d, dim=-1)
                return d[:, None, None, :].expand(*z_vals.shape, rays_o2.shape[1], 3)
            return other_view_dirs
        ctx = faults._patched(renderer, "_other_view_dirs", new)
    else:
        train_cell = types.SimpleNamespace(traffic={"kind": "train"}, config=cell.config)
        ctx = faults.planted(name, train_cell)
    with ctx:
        yield
