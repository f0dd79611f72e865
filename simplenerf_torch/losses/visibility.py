"""Visibility-head losses (off in the published configs).

Port of simplenerf_tpu/losses/visibility.py.

VisibilityLoss01: ties the MLP's predicted per-sample visibility to the
compositing transmittance through a bidirectional detached MAE (reference
VisibilityLoss01). Loss map: the per-ray sample-mean MAE, both directions
summed, keyed `VisibilityLoss01_{level}`.

VisibilityPriorLoss01: ViP-NeRF-style prior; penalizes low predicted
secondary-view visibility where the prior masks say the pixel is visible in
the other views (reference VisibilityPriorLoss01). Loss map: the per-ray
view-sum penalty, keyed `VisibilityPriorLoss01_{level}`, full length with
masked-out lanes zeroed. The training step renders without secondary views,
so this loss is 0 there and counts only in validation.
"""

from __future__ import annotations

import torch

from simplenerf_torch.losses.common import masked_mean


def make_visibility_loss():
    def loss_fn(batch: dict, outputs: dict, return_maps: bool = False):
        total = 0.0
        maps = {}
        for level in ("coarse", "fine"):
            pred_key, target_key = f"raw_visibility_{level}", f"visibility_{level}"
            if pred_key in outputs and target_key in outputs:
                pred = outputs[pred_key]  # (nr, ns) plane
                target = outputs[target_key]  # (nr, ns) transmittance
                map1 = torch.mean(torch.abs(pred - target.detach()), dim=1)
                map2 = torch.mean(torch.abs(pred.detach() - target), dim=1)
                total = total + map1.mean() + map2.mean()
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
            total = total + masked_mean(per_ray, mask)
            maps[f"VisibilityPriorLoss01_{level}"] = per_ray * mask.to(per_ray.dtype)
        return (total, maps) if return_maps else total

    return loss_fn
