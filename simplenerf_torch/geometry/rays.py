"""Ray generation and NDC projection.

Conventions of the reference (DataPreprocessor01.get_rays / get_ndc_rays),
as ported in simplenerf_tpu/geometry/rays.py: integer-cornered pixel grid
(x right, y down; +0.5 offsets only for mip-NeRF), camera dirs flip y and z
after the K^-1 backprojection, NDC after sliding origins to the near plane.
"""

from __future__ import annotations

import math

import torch


def pixel_grid(h: int, w: int, half_pixel: bool = False, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel coordinate grids, shape (h, w) each, xy-indexed."""
    off = 0.5 if half_pixel else 0.0
    x = torch.arange(w, dtype=torch.float32, device=device) + off
    y = torch.arange(h, dtype=torch.float32, device=device) + off
    return torch.meshgrid(x, y, indexing="xy")


def get_rays(
    h: int, w: int, intrinsic: torch.Tensor, c2w: torch.Tensor, half_pixel: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """World-space ray origins/directions for every pixel of one camera.

    intrinsic: (3, 3); c2w: (4, 4) camera-to-world (normalized frame).
    Returns rays_o, rays_d, each (h, w, 3); rays_d is unnormalized.
    """
    x, y = pixel_grid(h, w, half_pixel, device=intrinsic.device)
    pix = torch.stack([x, y, torch.ones_like(x)], dim=-1)  # (h, w, 3)
    cam_dirs = pix @ torch.linalg.inv(intrinsic).T
    flip = torch.tensor([1.0, -1.0, -1.0], dtype=cam_dirs.dtype, device=cam_dirs.device)
    cam_dirs = cam_dirs * flip
    rays_d = cam_dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def get_view_dirs(rays_d: torch.Tensor) -> torch.Tensor:
    return rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)


def ndc_rays(rays_o, rays_d, h: int, w: int, focal_x, focal_y, near: float):
    """Project rays into NDC space for forward-facing scenes: (..., 3) -> (..., 3)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox, oy, oz = rays_o[..., 0], rays_o[..., 1], rays_o[..., 2]
    dx, dy, dz = rays_d[..., 0], rays_d[..., 1], rays_d[..., 2]

    o0 = -1.0 / (w / (2.0 * focal_x)) * ox / oz
    o1 = -1.0 / (h / (2.0 * focal_y)) * oy / oz
    o2 = 1.0 + 2.0 * near / oz
    d0 = -1.0 / (w / (2.0 * focal_x)) * (dx / dz - ox / oz)
    d1 = -1.0 / (h / (2.0 * focal_y)) * (dy / dz - oy / oz)
    d2 = -2.0 * near / oz

    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)


def get_radii(rays_d: torch.Tensor) -> torch.Tensor:
    """Mip-NeRF pixel cone radii from x-neighbor direction deltas:
    rays_d (n, h, w, 3) -> radii (n, h, w, 1)."""
    dx = torch.sqrt(torch.sum((rays_d[:, :-1] - rays_d[:, 1:]) ** 2, -1))
    dx = torch.cat([dx, dx[:, -2:-1]], dim=1)
    return dx[..., None] * 2.0 / math.sqrt(12.0)


def get_radii_ndc(rays_o_ndc: torch.Tensor) -> torch.Tensor:
    """NDC-space cone radii from origin deltas."""
    dx = torch.sqrt(torch.sum((rays_o_ndc[:, :-1] - rays_o_ndc[:, 1:]) ** 2, -1))
    dx = torch.cat([dx, dx[:, -2:-1]], dim=1)
    dy = torch.sqrt(torch.sum((rays_o_ndc[:, :, :-1] - rays_o_ndc[:, :, 1:]) ** 2, -1))
    dy = torch.cat([dy, dy[:, :, -2:-1]], dim=2)
    return (0.5 * (dx + dy))[..., None] * 2.0 / math.sqrt(12.0)
