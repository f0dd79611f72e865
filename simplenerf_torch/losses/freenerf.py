"""FreeNeRF's losses on mip-NeRF's two levels (`render.mip`).

- MipNeRFMSE01: mip-NeRF's photometric loss, the fine level's RGB MSE plus
  `coarse_weight` (0.1, mip-NeRF's coarse_loss_mult) times the coarse
  level's, over the NeRF rays. Loss maps: the per-ray channel-mean squared
  error keyed `MipNeRFMSE01_{coarse,fine}`.
- OcclusionLoss01: FreeNeRF's occlusion regulariser (Eq. 4), the mean over
  rays of (1/K) sum_{k < M} sigma_k, the densities of a ray's first M =
  `reg_range` (10) of its K intervals, summed over both levels (which
  levels it reads is the configuration's assumption); maps
  `OcclusionLoss01_{coarse,fine}`.
"""

from __future__ import annotations

import torch

from simplenerf_torch.losses.common import global_count, masked_mean, row_mean

LEVELS = ("coarse", "fine")


def make_mip_mse(coarse_weight: float = 0.1):
    def loss_fn(batch: dict, outputs: dict, return_maps: bool = False):
        total, maps = 0.0, {}
        mask, count = batch["indices_mask_nerf"], global_count(batch, "indices_mask_nerf")
        for level in LEVELS:
            per_ray = torch.mean(torch.square(outputs[f"rgb_{level}"] - batch["target_rgb"]), dim=-1)
            w = coarse_weight if level == "coarse" else 1.0
            total = total + w * masked_mean(per_ray, mask, count)
            maps[f"MipNeRFMSE01_{level}"] = per_ray * mask.to(per_ray.dtype)
        return (total, maps) if return_maps else total

    return loss_fn


def make_occlusion_loss(reg_range: int = 10):
    def loss_fn(batch: dict, outputs: dict, return_maps: bool = False):
        total, maps = 0.0, {}
        for level in LEVELS:
            density = outputs[f"density_{level}"]
            per_ray = density[:, :reg_range].sum(-1) / density.shape[-1]
            total = total + row_mean(per_ray, global_count(batch, "rows"))
            maps[f"OcclusionLoss01_{level}"] = per_ray
        return (total, maps) if return_maps else total

    return loss_fn
