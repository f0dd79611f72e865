"""Reprojection and NDC <-> metric depth conversions.

Shape-polymorphic over leading ray dimensions; ports of
simplenerf_tpu/geometry/projection.py.
"""

from __future__ import annotations

import torch

# Flips NeRF world axes back to the OpenCV camera convention before applying
# the intrinsic matrix.
_REPROJECT_FLIP = (1.0, -1.0, -1.0)


def reproject(points: torch.Tensor, w2c_poses: torch.Tensor, intrinsic: torch.Tensor) -> torch.Tensor:
    """Project world points into other cameras' pixel coordinates.

    points: (..., 3); w2c_poses: (..., 4, 4) per-point target poses (stored
    as recentred transforms whose [:3,:3] is R_c2w and [:3,3] the camera
    origin); intrinsic: (3, 3). Returns (..., 2) pixel positions (x, y).
    """
    origins = w2c_poses[..., :3, 3]
    rotations = w2c_poses[..., :3, :3]
    dirs = points - origins
    signs = torch.empty(3, dtype=points.dtype, device=points.device)
    for i, sign in enumerate(_REPROJECT_FLIP):  # fill_ launches with the value: no host copy
        signs[i].fill_(sign)
    flip = torch.diag(signs)
    cam = torch.einsum("ij,...kj,...k->...i", flip, rotations, dirs)
    pix = cam @ intrinsic.T
    return pix[..., :2] / pix[..., 2:3]


def depth_from_ndc(z_ndc: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor, near: float = 1.0) -> torch.Tensor:
    """NDC z values -> metric depth along the original (world) ray.

    z_ndc: (..., s); rays_o/rays_d: (..., 3) un-projected rays. Keeps the
    reference's 1e-3 guard at z == 1.
    """
    oz = rays_o[..., 2:3]
    dz = rays_d[..., 2:3]
    tn = -(near + oz) / dz
    guard = torch.where(z_ndc == 1.0, torch.full_like(z_ndc, 1e-3), torch.zeros_like(z_ndc))
    return (oz + tn * dz) / dz * (1.0 / (1.0 - z_ndc + guard) - 1.0) + tn


def depth_to_ndc(depths: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor, near: float = 1.0) -> torch.Tensor:
    """Metric depth (along-ray t in the normalized frame) -> NDC z; inverse of
    depth_from_ndc. depths: (..., 1); rays_o/rays_d: (..., 3)."""
    oz = rays_o[..., 2:]
    dz = rays_d[..., 2:]
    tn = -(near + oz) / dz
    oz_shifted = oz + tn * dz
    return 1.0 - oz_shifted / (oz_shifted + (depths - tn) * dz)
