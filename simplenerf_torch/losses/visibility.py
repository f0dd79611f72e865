"""Visibility-head losses (off in the published SimpleNeRF configs; on in ViP-NeRF).

Port of simplenerf_tpu/losses/visibility.py.

VisibilityLoss01: ties the MLP's predicted per-sample visibility to the
compositing transmittance through a bidirectional detached MAE (reference
VisibilityLoss01). Loss map: the per-ray sample-mean MAE, both directions
summed, keyed `VisibilityLoss01_{level}`.

VisibilityPriorLoss01: ViP-NeRF-style prior; penalizes low predicted
secondary-view visibility where the prior masks say the pixel is visible in
the other views (reference VisibilityPriorLoss01). Loss map: the per-ray
view-sum penalty, keyed `VisibilityPriorLoss01_{level}`, full length with
masked-out lanes zeroed. The training step renders secondary views only
where the model's `train_secondary_views` key is on (ViP-NeRF,
`presets.with_vip_prior`): there the loss trains at both levels; with the
key off (`presets.with_visibility_priors`, the JAX package) it is 0 in
training and counts only in validation.
"""

from __future__ import annotations

import torch

from simplenerf_torch.losses.common import global_count, masked_mean, row_mean


def make_visibility_loss():
    def loss_fn(batch: dict, outputs: dict, return_maps: bool = False):
        total = 0.0
        maps = {}
        rows = global_count(batch, "rows")
        for level in ("coarse", "fine"):
            pred_key, target_key = f"raw_visibility_{level}", f"visibility_{level}"
            if pred_key in outputs and target_key in outputs:
                pred = outputs[pred_key]  # (nr, ns) plane
                target = outputs[target_key]  # (nr, ns) transmittance
                map1 = torch.mean(torch.abs(pred - target.detach()), dim=1)
                map2 = torch.mean(torch.abs(pred.detach() - target), dim=1)
                total = total + row_mean(map1, rows) + row_mean(map2, rows)
                maps[f"VisibilityLoss01_{level}"] = map1 + map2
        return (total, maps) if return_maps else total

    return loss_fn


def make_visibility_prior_loss():
    def loss_fn(batch: dict, outputs: dict, return_maps: bool = False):
        total = 0.0
        maps = {}
        mask = batch["indices_mask_nerf"]
        for level in ("coarse", "fine"):
            key = f"visibility2_{level}"
            if key not in outputs:
                continue
            vis2 = outputs[key]  # (nr, nf-1)
            if "visibility_prior_masks" in batch:
                prior = batch["visibility_prior_masks"]
            elif "visibility_prior_weights" in batch:
                prior = batch["visibility_prior_weights"]
            else:
                prior = torch.ones_like(vis2)
            per_ray = torch.sum(prior * (1.0 - vis2), dim=-1)
            total = total + masked_mean(per_ray, mask, global_count(batch, "indices_mask_nerf"))
            maps[f"VisibilityPriorLoss01_{level}"] = per_ray * mask.to(per_ray.dtype)
        return (total, maps) if return_maps else total

    return loss_fn
