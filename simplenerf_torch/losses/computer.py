"""Loss dispatch with per-iteration weight schedules.

Port of simplenerf_tpu/losses/computer.py (reference LossComputer01): a
static registry of loss builders; per-iteration weights (constant or
stepwise `iter_weights` schedules) are computed on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from simplenerf_torch.losses import consistency, depth_supervision, freenerf, photometric, visibility

LossFn = Callable[[dict, dict], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LossContext:
    """Static structural flags the loss builders need."""

    points_aug_fine: bool = False
    views_aug_fine: bool = False
    sparse_depth_enabled: bool = True


def build_loss(name: str, loss_cfg: dict, ctx: LossContext) -> LossFn:
    patch = tuple(loss_cfg.get("patch_size", (5, 5)))
    thr = float(loss_cfg.get("rmse_threshold", 0.1))
    opt = {k: (float(loss_cfg[k]) if loss_cfg.get(k) is not None else None)
           for k in ("depth_clip", "depth_huber", "depth_arb_clip")}
    clip, hub, arb = opt["depth_clip"], opt["depth_huber"], opt["depth_arb_clip"]
    builders = {
        "MSE01": lambda: photometric.make_photometric_loss(""),
        "MSE02": lambda: photometric.make_photometric_loss("points_augmentation_"),
        "MSE03": lambda: photometric.make_photometric_loss("views_augmentation_"),
        "SparseDepthMSE01": lambda: depth_supervision.make_sparse_depth_loss(""),
        "SparseDepthMSE02": lambda: depth_supervision.make_sparse_depth_loss(
            "points_augmentation_", ctx.points_aug_fine
        ),
        "SparseDepthMSE03": lambda: depth_supervision.make_sparse_depth_loss(
            "views_augmentation_", ctx.views_aug_fine
        ),
        "DenseDepthMSE01": depth_supervision.make_dense_depth_loss,
        "PointsAugmentationDepthLoss01": lambda: consistency.make_plain_depth_consistency(
            "points_augmentation_", ctx.points_aug_fine
        ),
        "PointsAugmentationDepthLoss02": lambda: consistency.make_reliable_depth_consistency(
            "points_augmentation_", patch, thr, ctx.points_aug_fine, clip, hub, arb
        ),
        "ViewsAugmentationDepthLoss01": lambda: consistency.make_plain_depth_consistency(
            "views_augmentation_", ctx.views_aug_fine
        ),
        "ViewsAugmentationDepthLoss02": lambda: consistency.make_reliable_depth_consistency(
            "views_augmentation_", patch, thr, ctx.views_aug_fine, clip, hub, arb
        ),
        "CoarseFineConsistencyLoss01": consistency.make_plain_coarse_fine_consistency,
        "CoarseFineConsistencyLoss02": lambda: consistency.make_reliable_coarse_fine_consistency(
            patch, thr, ctx.sparse_depth_enabled, clip, hub, arb
        ),
        "VisibilityLoss01": visibility.make_visibility_loss,
        "VisibilityPriorLoss01": visibility.make_visibility_prior_loss,
        "MipNeRFMSE01": lambda: freenerf.make_mip_mse(float(loss_cfg.get("coarse_weight", 0.1))),
        "OcclusionLoss01": lambda: freenerf.make_occlusion_loss(int(loss_cfg.get("reg_range", 10))),
    }
    if name not in builders:
        raise ValueError(f"Unknown loss function: {name}")
    return builders[name]()


class LossComputer:
    """Holds the configured loss set; `compute` is differentiable."""

    def __init__(self, loss_specs: Sequence[dict], ctx: LossContext = LossContext()):
        self.specs = list(loss_specs)
        self.names = [spec["name"] for spec in self.specs]
        self.fns = [build_loss(spec["name"], spec, ctx) for spec in self.specs]

    def weight(self, spec: dict, iter_num: int) -> float:
        if "weight" in spec:
            return float(spec["weight"])
        if "iter_weights" in spec:
            w = None
            for t in sorted(int(k) for k in spec["iter_weights"]):
                if iter_num >= t:
                    w = spec["iter_weights"][str(t)]
            if w is None:
                raise RuntimeError(f"no weight for {spec['name']} at iter {iter_num}")
            return float(w)
        raise RuntimeError(f"loss spec {spec['name']} has no weight")

    def weights_vector(self, iter_num: int) -> np.ndarray:
        """Host-side: the per-loss weights at this iteration."""
        return np.array([self.weight(s, iter_num) for s in self.specs], dtype=np.float32)

    def compute(self, batch: dict, outputs: dict, weights, return_loss_maps: bool = False):
        """Weighted total + per-loss raw values (+ the flat {map_name: (nr,)}
        loss maps with `return_loss_maps`, `{LossFileStem}_{level}` keys)."""
        values, maps = {}, {}
        total = 0.0
        for i, (name, fn) in enumerate(zip(self.names, self.fns)):
            if return_loss_maps:
                v, loss_maps = fn(batch, outputs, return_maps=True)
                maps.update(loss_maps)
            else:
                v = fn(batch, outputs)
            values[name] = v
            total = total + weights[i] * v
        values["TotalLoss"] = total
        return (total, values, maps) if return_loss_maps else (total, values)
