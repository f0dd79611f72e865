"""Depth-consistency losses between model pairs.

Port of simplenerf_tpu/losses/consistency.py. The plain variants
(...Loss01, CoarseFineConsistencyLoss01) are unmasked depth MSEs. The
reliable variants (...Loss02) decide per ray which model's depth is
trustworthy by reprojecting the backprojected point into the closest other
training view and comparing 5x5 image patches: the model whose patch
matches the source view better (RMSE below threshold) becomes the detached
teacher of the other. CoarseFineConsistencyLoss02 adds the sparse-depth
branch where the detached fine depth teaches coarse.

The reference's boolean-index filtering is multiply-by-mask with the
NeRF-ray count as denominator. `depth_clip`, `depth_huber` and
`depth_arb_clip` are the JAX package's optional bounds on the NDC->metric
pole (off by default, reference-exact).
"""

from __future__ import annotations

import torch

from simplenerf_torch.geometry import projection
from simplenerf_torch.losses.common import (
    closest_other_frame,
    gather_patches,
    global_count,
    mean_over_mask_count,
    patch_rmse,
    row_mean,
)

_PLAIN_MAP_NAMES = {
    "points_augmentation_": "PointsAugmentationDepthLoss01",
    "views_augmentation_": "ViewsAugmentationDepthLoss01",
}
_RELIABLE_MAP_NAMES = {
    "points_augmentation_": "PointsAugmentationDepthLoss02",
    "views_augmentation_": "ViewsAugmentationDepthLoss02",
}


def _zero(outputs: dict):
    return torch.zeros((), device=next(iter(outputs.values())).device)


def make_plain_depth_consistency(prefix: str, aug_fine_present: bool = False):
    """Unmasked depth MSE main <-> augmented over the whole batch (...Loss01).
    Loss map: the per-ray squared error, keyed `{Stem}_{level}`."""
    map_name = _PLAIN_MAP_NAMES[prefix]

    def loss_fn(batch: dict, outputs: dict, return_maps: bool = False):
        total = 0.0
        maps = {}
        for level in ("coarse", "fine") if aug_fine_present else ("coarse",):
            main_key, aug_key = f"depth_{level}", f"{prefix}depth_{level}"
            if main_key in outputs and aug_key in outputs:
                sq = torch.square(outputs[main_key] - outputs[aug_key])
                total = total + row_mean(sq, global_count(batch, "rows"))
                maps[f"{map_name}_{level}"] = sq
        return (total, maps) if return_maps else total

    return loss_fn


def make_plain_coarse_fine_consistency():
    """Unmasked coarse <-> fine depth MSE; one unsuffixed map for the pair."""

    def loss_fn(batch: dict, outputs: dict, return_maps: bool = False):
        if "depth_coarse" not in outputs or "depth_fine" not in outputs:
            return (_zero(outputs), {}) if return_maps else _zero(outputs)
        sq = torch.square(outputs["depth_coarse"] - outputs["depth_fine"])
        value = row_mean(sq, global_count(batch, "rows"))
        return (value, {"CoarseFineConsistencyLoss01": sq}) if return_maps else value

    return loss_fn


def _clip_depth(depth, batch: dict, depth_clip):
    """Clamp metric depth at depth_clip x the scene far plane (identity for None)."""
    if depth_clip is None:
        return depth
    return torch.minimum(depth, depth_clip * batch["far"][:, 0])


def _teaching_sq(diff, batch: dict, depth_huber):
    """Per-ray teaching error: squared, or Huberized at depth_huber x far
    (linear beyond, so its gradient is bounded but never zero)."""
    sq = torch.square(diff)
    if depth_huber is None:
        return sq
    delta = depth_huber * batch["far"][:, 0]
    a = diff.abs()
    return torch.where(a <= delta, sq, delta * (2.0 * a - delta))


def reliable_depth_consistency(depth1, depth2, batch: dict, patch_size, rmse_threshold: float,
                               depth_clip=None, depth_huber=None, depth_arb_clip=None):
    """Patch-reprojection-arbitrated bidirectional depth consistency.

    depth1/depth2: (nr,) metric depths of the two models, on NeRF rays.
    Returns (loss, map1, map2): the sum of both teaching directions, and the
    per-ray squared errors ON depth1 (zeroed where model 2 is not the
    reliable teacher) and ON depth2.
    """
    rays_o, rays_d = batch["rays_o"], batch["rays_d"]
    depth1 = _clip_depth(depth1, batch, depth_clip)
    depth2 = _clip_depth(depth2, batch, depth_clip)
    depth1_arb = _clip_depth(depth1, batch, depth_arb_clip)
    depth2_arb = _clip_depth(depth2, batch, depth_arb_clip)
    nerf_mask = batch["indices_mask_nerf"]
    pixel_ids = batch["pixel_id"]
    scene = batch["common"]
    images, poses, intrinsics = scene["images"], scene["poses"], scene["intrinsics"]
    _, h, w, _ = images.shape
    py, px = patch_size
    hpy, hpx = py // 2, px // 2

    image_ids = pixel_ids[:, 0].long()
    x_a, y_a = pixel_ids[:, 1].long(), pixel_ids[:, 2].long()
    image_ids_b = closest_other_frame(poses)[image_ids]
    poses_b = poses[image_ids_b]

    # Backproject at each model's detached depth and reproject into view b.
    pts1 = rays_o + rays_d * depth1_arb.detach()[..., None]
    pts2 = rays_o + rays_d * depth2_arb.detach()[..., None]
    pos1 = torch.round(projection.reproject(pts1, poses_b, intrinsics[0])).to(torch.int32).long()
    pos2 = torch.round(projection.reproject(pts2, poses_b, intrinsics[0])).to(torch.int32).long()
    x1b, y1b = pos1[:, 0], pos1[:, 1]
    x2b, y2b = pos2[:, 0], pos2[:, 1]

    def in_bounds(x, y):
        return (x >= hpx) & (x < w - hpx) & (y >= hpy) & (y < h - hpy)

    valid_a, valid_1b, valid_2b = in_bounds(x_a, y_a), in_bounds(x1b, y1b), in_bounds(x2b, y2b)
    patches_a = gather_patches(images, image_ids, x_a, y_a, py, px)
    rmse1 = patch_rmse(patches_a, gather_patches(images, image_ids_b, x1b, y1b, py, px))
    rmse2 = patch_rmse(patches_a, gather_patches(images, image_ids_b, x2b, y2b, py, px))

    # maskK: model K is the more reliable one.
    mask1 = ((rmse1 < rmse2) | ~valid_2b) & (rmse1 < rmse_threshold) & valid_1b & valid_a
    mask2 = ((rmse2 < rmse1) | ~valid_1b) & (rmse2 < rmse_threshold) & valid_2b & valid_a

    sq12 = _teaching_sq(depth1 - depth2.detach(), batch, depth_huber)
    sq21 = _teaching_sq(depth2 - depth1.detach(), batch, depth_huber)
    sel1, sel2 = mask2 & nerf_mask, mask1 & nerf_mask
    count = global_count(batch, "indices_mask_nerf")
    loss1 = mean_over_mask_count(sq12, sel1, nerf_mask, count)
    loss2 = mean_over_mask_count(sq21, sel2, nerf_mask, count)
    return loss1 + loss2, sq12 * sel1.to(sq12.dtype), sq21 * sel2.to(sq21.dtype)


def make_reliable_depth_consistency(prefix: str, patch_size=(5, 5), rmse_threshold: float = 0.1,
                                    aug_fine_present: bool = False, depth_clip=None,
                                    depth_huber=None, depth_arb_clip=None):
    """...AugmentationDepthLoss02 for prefix 'points_augmentation_' or
    'views_augmentation_'; maps keyed `{Stem}_{level}_{main,augmented}`."""
    map_name = _RELIABLE_MAP_NAMES[prefix]

    def loss_fn(batch: dict, outputs: dict, return_maps: bool = False):
        total = 0.0
        maps = {}
        for level in ("coarse", "fine") if aug_fine_present else ("coarse",):
            main_key, aug_key = f"depth_{level}", f"{prefix}depth_{level}"
            if main_key in outputs and aug_key in outputs:
                value, map_main, map_aug = reliable_depth_consistency(
                    outputs[main_key], outputs[aug_key], batch, patch_size, rmse_threshold,
                    depth_clip, depth_huber, depth_arb_clip,
                )
                total = total + value
                maps[f"{map_name}_{level}_main"] = map_main
                maps[f"{map_name}_{level}_augmented"] = map_aug
        return (total, maps) if return_maps else total

    return loss_fn


def make_reliable_coarse_fine_consistency(patch_size=(5, 5), rmse_threshold: float = 0.1,
                                          sparse_depth_enabled: bool = True, depth_clip=None,
                                          depth_huber=None, depth_arb_clip=None):
    """CoarseFineConsistencyLoss02: arbitrated coarse <-> fine, plus the
    sparse-depth branch where the detached fine depth teaches coarse. Maps
    keyed `CoarseFineConsistencyLoss02_{coarse,fine}`; the sparse-depth
    branch's map is added to the coarse map."""

    def loss_fn(batch: dict, outputs: dict, return_maps: bool = False):
        if "depth_coarse" not in outputs or "depth_fine" not in outputs:
            return (_zero(outputs), {}) if return_maps else _zero(outputs)
        dc = _clip_depth(outputs["depth_coarse"], batch, depth_clip)
        df = _clip_depth(outputs["depth_fine"], batch, depth_clip)
        total, map_coarse, map_fine = reliable_depth_consistency(
            dc, df, batch, patch_size, rmse_threshold,
            depth_huber=depth_huber, depth_arb_clip=depth_arb_clip,
        )
        if sparse_depth_enabled and "indices_mask_sparse_depth" in batch:
            sd_mask = batch["indices_mask_sparse_depth"]
            sq = _teaching_sq(dc - df.detach(), batch, depth_huber)
            total = total + mean_over_mask_count(
                sq, sd_mask, sd_mask, global_count(batch, "indices_mask_sparse_depth"))
            map_coarse = map_coarse + sq * sd_mask.to(sq.dtype)
        if return_maps:
            return total, {
                "CoarseFineConsistencyLoss02_coarse": map_coarse,
                "CoarseFineConsistencyLoss02_fine": map_fine,
            }
        return total

    return loss_fn
