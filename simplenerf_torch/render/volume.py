"""Alpha-compositing volume rendering.

Matches SimpleNeRF01.volume_rendering as ported in
simplenerf_tpu/render/volume.py, including its epsilons: 1e-10 inside the
transmittance cumprod, 1e-6 in the depth normalization, and a last bin of
1e10 (metric) or 1.0 (NDC).
"""

from __future__ import annotations

from typing import Optional

import torch

from simplenerf_torch.geometry import projection


def exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    """[1, x0, x0*x1, ...] along the last axis."""
    ones = torch.ones_like(x[..., :1])
    return torch.cumprod(torch.cat([ones, x], dim=-1), dim=-1)[..., :-1]


def composite(
    sigma: torch.Tensor,
    rgb: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    *,
    ndc: bool = False,
    rays_o_world: Optional[torch.Tensor] = None,
    rays_d_world: Optional[torch.Tensor] = None,
    white_bkgd: bool = False,
    vis2: Optional[torch.Tensor] = None,
) -> dict:
    """Composite per-sample sigma/rgb into per-ray outputs.

    sigma: (nr, ns); rgb: (3, nr, ns) channel planes; z_vals: (nr, ns) in
    the sampling space (NDC when ndc=True); rays_d: (nr, 3) in the same
    space (its norm scales the z deltas). For NDC runs rays_o_world /
    rays_d_world convert NDC z to metric depth.

    Returns rgb (nr, 3), acc, alpha, visibility (transmittance), weights,
    depth, depth_var (+ depth_ndc/depth_var_ndc for NDC runs, + visibility2
    when `vis2` (nr, ns, k) is given).
    """
    inf_depth = 1.0 if ndc else 1e10
    z_ext = torch.cat([z_vals, torch.full_like(z_vals[..., :1], inf_depth)], dim=-1)
    deltas = (z_ext[..., 1:] - z_ext[..., :-1]) * torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    alpha = 1.0 - torch.exp(-sigma * deltas)
    transmittance = exclusive_cumprod(1.0 - alpha + 1e-10)
    weights = alpha * transmittance

    rgb_map = torch.sum(weights[None, :, :] * rgb, dim=-1).T
    acc = torch.sum(weights, dim=-1)

    def expected_depth(z):
        d = torch.sum(weights * z, dim=-1) / (acc + 1e-6)
        var = torch.sum(weights * torch.square(z - d[..., None]), dim=-1)
        return d, var

    out: dict = {}
    if ndc:
        depth_ndc, depth_var_ndc = expected_depth(z_vals)
        z_metric = projection.depth_from_ndc(z_vals, rays_o_world, rays_d_world)
        depth, depth_var = expected_depth(z_metric)
        out["depth_ndc"] = depth_ndc
        out["depth_var_ndc"] = depth_var_ndc
    else:
        depth, depth_var = expected_depth(z_vals)

    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc[..., None])

    out.update(
        rgb=rgb_map,
        acc=acc,
        alpha=alpha,
        visibility=transmittance,
        weights=weights,
        depth=depth,
        depth_var=depth_var,
    )

    if vis2 is not None:
        # Expected secondary-view visibility per ray: weighted mean of the
        # per-sample MLP visibility predictions.
        out["visibility2"] = torch.sum(weights[..., None] * vis2, dim=-2) / (acc[..., None] + 1e-6)
    return out
