"""Shared masked-reduction and patch-gather primitives for the loss stack.

Port of simplenerf_tpu/losses/common.py. Every loss runs on fixed-shape ray
batches in which the NeRF rays and the sparse-depth rays are told apart by
boolean masks (the reference's `indices_mask_nerf` /
`indices_mask_sparse_depth`), never by dynamic slicing.
"""

from __future__ import annotations

import torch


def global_count(batch: dict, key: str):
    """The whole batch's count for `key` (a mask's name, or "rows") when
    `batch` holds one rank's rows of a ray-sharded batch: the Trainer puts
    the counts, known on the host before the step, in
    `batch["global_counts"]`. None for a whole batch."""
    counts = batch.get("global_counts")
    return None if counts is None else counts[key]


def masked_mean(values: torch.Tensor, mask: torch.Tensor, count=None) -> torch.Tensor:
    """Mean of `values` where mask is True; 0 if the mask is empty (the
    reference's `x[mask].mean()` with its empty-selection guard).

    With `count`, the mask's count over the whole batch (`global_count`),
    `values` are one rank's rows: the rank's share sum(values * mask) /
    count, 0 where the whole batch's mask is empty."""
    return mean_over_mask_count(values, mask, mask, count)


def mean_over_mask_count(values: torch.Tensor, zero_mask: torch.Tensor,
                         count_mask: torch.Tensor, count=None) -> torch.Tensor:
    """sum(values * zero_mask) / count(count_mask): the arbitrated depth
    losses zero the unselected rays but normalize by the NeRF-ray count.
    `count` as in `masked_mean`."""
    total = (values * zero_mask.to(values.dtype)).sum()
    if count is None:
        count = count_mask.to(values.dtype).sum()
        return torch.where(count > 0, total / count.clamp(min=1.0), 0.0)
    return total / count if count > 0 else torch.zeros_like(total)


def row_mean(values: torch.Tensor, count=None) -> torch.Tensor:
    """Mean of per-ray `values` (nr,); with `count`, the whole batch's row
    count, the rank's share sum(values) / count."""
    return values.mean() if count is None else values.sum() / count


def gather_patches(images: torch.Tensor, image_ids: torch.Tensor, x: torch.Tensor,
                   y: torch.Tensor, patch_y: int, patch_x: int) -> torch.Tensor:
    """(py, px) image patches centred at integer pixel coords.

    images: (n, h, w, c); image_ids/x/y: (nr,) int. Returns (nr, py, px, c).
    Coordinates are clamped to the image, so border rays get edge-padded
    patches; the callers' validity masks exclude those rays.
    """
    n, h, w, c = images.shape
    flat = images.reshape(n * h * w, c)
    hy, hx = patch_y // 2, patch_x // 2
    dy = torch.arange(-hy, hy + 1, device=x.device)
    dx = torch.arange(-hx, hx + 1, device=x.device)
    yy = (y.long()[:, None] + dy).clamp(0, h - 1)  # (nr, py)
    xx = (x.long()[:, None] + dx).clamp(0, w - 1)  # (nr, px)
    idx = image_ids.long()[:, None, None] * (h * w) + yy[:, :, None] * w + xx[:, None, :]
    return flat.index_select(0, idx.reshape(-1)).reshape(*idx.shape, c)


def patch_rmse(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """(nr, py, px, c) x2 -> (nr,) root-mean-square error per patch."""
    return torch.sqrt(torch.mean(torch.square(p1 - p2), dim=(1, 2, 3)))


def closest_other_frame(poses: torch.Tensor) -> torch.Tensor:
    """Index of the nearest other camera of each frame (the reference's
    second-smallest distance, `kthvalue(distances, 2)`); ties don't matter.
    A single frame (a one-frame validation set) is its own match, as the
    JAX package's clamped index gives."""
    origins = poses[:, :3, 3]
    d2 = torch.square(origins[:, None, :] - origins[None, :, :]).sum(-1)
    return torch.argsort(d2, dim=1, stable=True)[:, min(1, poses.shape[0] - 1)]
