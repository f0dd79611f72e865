"""Photometric (RGB MSE) losses for the main and augmented models.

Port of simplenerf_tpu/losses/photometric.py (reference MSE01/02/03):
per-ray RGB MSE on the NeRF rays. Loss maps: the per-ray channel-mean
squared error keyed `MSE0X_{coarse,fine}`, full-length with the masked-out
rays zeroed.
"""

from __future__ import annotations

import torch

from simplenerf_torch.losses.common import global_count, masked_mean

_MAP_NAMES = {"": "MSE01", "points_augmentation_": "MSE02", "views_augmentation_": "MSE03"}


def _rgb_mse(pred, target, mask, count):
    per_ray = torch.mean(torch.square(pred - target), dim=-1)
    return masked_mean(per_ray, mask, count), per_ray * mask.to(per_ray.dtype)


def make_photometric_loss(prefix: str = ""):
    """RGB MSE over `{prefix}rgb_{coarse,fine}`: prefix '' -> MSE01,
    'points_augmentation_' -> MSE02, 'views_augmentation_' -> MSE03."""
    map_name = _MAP_NAMES[prefix]

    def loss_fn(batch: dict, outputs: dict, return_maps: bool = False):
        total = 0.0
        maps = {}
        for level in ("coarse", "fine"):
            key = f"{prefix}rgb_{level}"
            if key in outputs:
                value, per_ray = _rgb_mse(outputs[key], batch["target_rgb"],
                                          batch["indices_mask_nerf"],
                                          global_count(batch, "indices_mask_nerf"))
                total = total + value
                maps[f"{map_name}_{level}"] = per_ray
        return (total, maps) if return_maps else total

    return loss_fn
