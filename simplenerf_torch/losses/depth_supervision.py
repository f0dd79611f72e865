"""Depth-prior supervision losses (COLMAP sparse depth, dense depth).

Port of simplenerf_tpu/losses/depth_supervision.py (reference
SparseDepthMSE01/02/03 and DenseDepthMSE01). Depth targets are metric
(scaled into the normalized frame by the preprocessor); the prediction is
the compositor's metric expected depth. The sparse-depth losses emit no
loss maps; DenseDepthMSE01 emits the per-ray squared error keyed
`DenseDepthMSE01_{coarse,fine}`, full length with masked-out lanes zeroed.
"""

from __future__ import annotations

import torch

from simplenerf_torch.losses.common import global_count, masked_mean


def _zero(outputs: dict):
    return torch.zeros((), device=next(iter(outputs.values())).device)


def make_sparse_depth_loss(prefix: str = "", aug_fine_present: bool = False):
    """Sparse-depth MSE on the model the reference's fallback selects.

    Main model (prefix ''): fine depth if a fine MLP exists, else coarse.
    Augmented models: their coarse depth when no augmented fine MLP exists;
    when one exists, the reference falls back to the MAIN fine depth, a
    quirk kept here (SparseDepthMSE02/03).
    """

    def loss_fn(batch: dict, outputs: dict, return_maps: bool = False):
        if "indices_mask_sparse_depth" not in batch:
            return (_zero(outputs), {}) if return_maps else _zero(outputs)
        target = batch["sparse_depth_values"][:, 0]
        if prefix == "":
            pred = outputs["depth_fine"] if "depth_fine" in outputs else outputs["depth_coarse"]
        else:
            pred = outputs["depth_fine"] if aug_fine_present else outputs[f"{prefix}depth_coarse"]
        value = masked_mean(torch.square(pred - target), batch["indices_mask_sparse_depth"],
                            global_count(batch, "indices_mask_sparse_depth"))
        return (value, {}) if return_maps else value

    return loss_fn


def make_dense_depth_loss():
    """Dense-depth MSE on the NeRF rays, coarse + fine (DenseDepthMSE01)."""

    def loss_fn(batch: dict, outputs: dict, return_maps: bool = False):
        if "dense_depth_values" not in batch:
            return (_zero(outputs), {}) if return_maps else _zero(outputs)
        mask = batch["indices_mask_nerf"]
        count = global_count(batch, "indices_mask_nerf")
        target = batch["dense_depth_values"][:, 0]
        total = 0.0
        maps = {}
        for level in ("coarse", "fine"):
            key = f"depth_{level}"
            if key in outputs:
                sq = torch.square(outputs[key] - target)
                total = total + masked_mean(sq, mask, count)
                maps[f"DenseDepthMSE01_{level}"] = sq * mask.to(sq.dtype)
        return (total, maps) if return_maps else total

    return loss_fn
