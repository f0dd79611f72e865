"""Canonical config presets (reference-schema dicts).

`simplenerf_config` reproduces the published full-SimpleNeRF recipe
(reference src/NerfLlffTrainerTester01.py:236-447: 2048+2048 rays, 64/128
samples, 8x256 points net, PE degrees 10/4, points-aug sigma PE degree 3,
Lambertian views-aug, the 9-loss stack with 10k-iteration consistency
ramp-up, Adam 5e-4 with 250k exponential decay), parameterized so tests and
benches can shrink it. `vipnerf_config` is ViP-NeRF (Somraj &
Soundararajan, SIGGRAPH 2023): the plain coarse/fine NeRF at the same
widths with visibility heads, sparse depth and the visibility prior,
trained through secondary views (`train_secondary_views`).
"""

from __future__ import annotations

import copy


def mlp_dict(num_samples: int, depth: int = 8, width: int = 256, views_depth: int = 1,
             views_width: int = 128, pe_points: int = 10, pe_views: int = 4,
             sigma_pe: int | None = None, use_view_dirs: bool = True,
             view_dependent_rgb: bool = True, predict_visibility: bool = False) -> dict:
    d = {
        "num_samples": num_samples,
        "points_net_depth": depth,
        "views_net_depth": views_depth,
        "points_net_width": width,
        "views_net_width": views_width,
        "points_positional_encoding_degree": pe_points,
        "views_positional_encoding_degree": pe_views,
        "use_view_dirs": use_view_dirs,
        "view_dependent_rgb": view_dependent_rgb,
        "predict_visibility": predict_visibility,
    }
    if sigma_pe is not None:
        d["points_sigma_positional_encoding_degree"] = sigma_pe
    return d


def simplenerf_config(
    scene_id: str = "fern",
    database: str = "NeRF_LLFF",
    data_loader_name: str = "NerfLlffDataLoader01",
    train_set_num: int = 2,
    resolution_suffix: str = "_down4",
    num_rays: int = 2048,
    sparse_depth_rays: int = 2048,
    num_samples_coarse: int = 64,
    num_samples_fine: int = 128,
    mlp_depth: int = 8,
    mlp_width: int = 256,
    views_width: int = 128,
    num_iterations: int = 100000,
    consistency_start_iter: int = 10000,
    lr_initial: float = 5e-4,
    lr_decay: int = 250,
    seed: int = 0,
    ndc: bool = True,
    raw_noise_std: float = 1.0,
    compute_dtype: str = "float32",
    with_augmentations: bool = True,
    with_sparse_depth: bool = True,
    consistency_depth_clip: float | None = None,
    consistency_depth_huber: float | None = None,
    consistency_depth_arb_clip: float | None = None,
) -> dict:
    cfg: dict = {
        "train_num": 1,
        "database": database,
        "data_loader": {
            "data_loader_name": data_loader_name,
            "data_preprocessor_name": "ScenePreprocessor",
            "train_set_num": train_set_num,
            "scene_id": scene_id,
            "resolution_suffix": resolution_suffix,
            "recenter_camera_poses": True,
            "bd_factor": 0.75,
            "spherify": False,
            "ndc": ndc,
            "batching": True,
            "downsampling_factor": 1,
            "num_rays": num_rays,
            "precrop_fraction": 1,
            "precrop_iterations": -1,
        },
        "model": {
            "name": "SimpleNeRF",
            "coarse_mlp": mlp_dict(num_samples_coarse, mlp_depth, mlp_width,
                                   views_width=views_width),
            "fine_mlp": mlp_dict(num_samples_fine, mlp_depth, mlp_width,
                                 views_width=views_width),
            "chunk": 4 * 1024,
            "lindisp": False,
            "netchunk": 16 * 1024,
            "perturb": True,
            "raw_noise_std": raw_noise_std,
            "white_bkgd": False,
            "compute_dtype": compute_dtype,
        },
        "losses": [
            {"name": "MSE01", "weight": 1},
        ],
        "optimizer": {
            "lr_decayer_name": "NeRFLearningRateDecayer01",
            "lr_initial": lr_initial,
            "lr_decay": lr_decay,
            "beta1": 0.9,
            "beta2": 0.999,
        },
        "resume_training": True,
        "sub_batch_size": num_rays,
        "num_iterations": num_iterations,
        "validation_interval": 0,
        "validation_chunk_size": 64 * 1024,
        "validation_save_loss_maps": False,
        "model_save_interval": 10000,
        "mixed_precision_training": compute_dtype == "bfloat16",
        "seed": seed,
    }
    if with_sparse_depth:
        cfg["data_loader"]["sparse_depth"] = {"dirname": "DE02", "num_rays": sparse_depth_rays}
        cfg["losses"].append({"name": "SparseDepthMSE01", "weight": 0.1})
    if with_augmentations:
        cfg["model"]["points_augmentation"] = {
            "coarse_mlp": mlp_dict(num_samples_coarse, mlp_depth, mlp_width,
                                   views_width=views_width, sigma_pe=3),
        }
        cfg["model"]["views_augmentation"] = {
            "coarse_mlp": mlp_dict(num_samples_coarse, mlp_depth, mlp_width,
                                   views_width=views_width, use_view_dirs=False,
                                   view_dependent_rgb=False),
        }
        ramp = {"0": 0, str(consistency_start_iter): 0.1}
        cfg["losses"] += [
            {"name": "MSE02", "weight": 1},
            {"name": "MSE03", "weight": 1},
        ]
        if with_sparse_depth:
            cfg["losses"] += [
                {"name": "SparseDepthMSE02", "weight": 0.1},
                {"name": "SparseDepthMSE03", "weight": 0.1},
            ]
        consistency = [
            {"name": "PointsAugmentationDepthLoss02", "iter_weights": dict(ramp),
             "rmse_threshold": 0.1, "patch_size": [5, 5]},
            {"name": "ViewsAugmentationDepthLoss02", "iter_weights": dict(ramp),
             "rmse_threshold": 0.1, "patch_size": [5, 5]},
            {"name": "CoarseFineConsistencyLoss02", "iter_weights": dict(ramp),
             "rmse_threshold": 0.1, "patch_size": [5, 5]},
        ]
        if consistency_depth_clip is not None:
            # bf16 recipe: bound the NDC->metric pole at the consistency
            # inputs (losses/consistency.py) so bf16 trunk noise cannot blow
            # up the late-training losses. None = reference-exact f32 recipe.
            for spec in consistency:
                spec["depth_clip"] = consistency_depth_clip
        if consistency_depth_huber is not None:
            # Bounded-GRADIENT alternative to the hard clamp: Huberized
            # teaching error at huber x far (losses/consistency._teaching_sq)
            # keeps a restoring force on runaway rays instead of zeroing it.
            for spec in consistency:
                spec["depth_huber"] = consistency_depth_huber
        if consistency_depth_arb_clip is not None:
            # Arbitration-only clamp: bound the pole where depth enters the
            # reprojection/reliability masks, leave the teaching error (and
            # its restoring gradient) on the raw depths
            # (losses/consistency.reliable_depth_consistency).
            for spec in consistency:
                spec["depth_arb_clip"] = consistency_depth_arb_clip
        cfg["losses"] += consistency
    return copy.deepcopy(cfg)


def tiny_synthetic_config(**overrides) -> dict:
    """Small config for the synthetic blob scene (CPU-runnable tests)."""
    base = dict(
        scene_id="blobs",
        num_rays=128,
        sparse_depth_rays=64,
        num_samples_coarse=16,
        num_samples_fine=32,
        mlp_depth=2,
        mlp_width=64,
        views_width=32,
        num_iterations=300,
        consistency_start_iter=100,
        lr_initial=5e-3,
        raw_noise_std=0.2,
    )
    base.update(overrides)
    cfg = simplenerf_config(**base)
    cfg["model_save_interval"] = 300
    cfg["log_interval"] = 50
    # Tiny scenes: shrink the PE degrees for speed.
    for m in (cfg["model"]["coarse_mlp"], cfg["model"]["fine_mlp"]):
        m["points_positional_encoding_degree"] = 6
        m["views_positional_encoding_degree"] = 2
    if "points_augmentation" in cfg["model"]:
        cfg["model"]["points_augmentation"]["coarse_mlp"]["points_positional_encoding_degree"] = 6
        cfg["model"]["points_augmentation"]["coarse_mlp"]["views_positional_encoding_degree"] = 2
        cfg["model"]["views_augmentation"]["coarse_mlp"]["points_positional_encoding_degree"] = 6
    return cfg


def with_visibility_priors(cfg: dict, dense_dirname: str = "DE_GT",
                           masks_dirname: str = "VP_GT") -> dict:
    """`cfg` with the visibility heads and the prior losses on: a visibility
    head on the coarse and fine main MLPs, the DenseDepthMSE01,
    VisibilityLoss01 and VisibilityPriorLoss01 losses, and the dense-depth,
    visibility-prior masks and mip-NeRF radii data (the priors
    `synthetic.write_scene_priors` writes). Its training step renders no
    secondary views (the model key `train_secondary_views` is left off), so
    VisibilityPriorLoss01 is 0 there and counts only in validation, as in
    the JAX package; `vipnerf_config` trains the prior."""
    cfg = copy.deepcopy(cfg)
    for level in ("coarse_mlp", "fine_mlp"):
        cfg["model"][level]["predict_visibility"] = True
    dl = cfg["data_loader"]
    dl["dense_depth"] = {"dirname": dense_dirname}
    dl["visibility_prior"] = {"load_masks": True, "masks_dirname": masks_dirname}
    dl["mip_nerf"] = {}
    cfg["losses"] += [
        {"name": "DenseDepthMSE01", "weight": 0.1},
        {"name": "VisibilityLoss01", "weight": 0.1},
        {"name": "VisibilityPriorLoss01", "weight": 0.001},
    ]
    return cfg


VIP_LOSSES = (
    {"name": "VisibilityLoss01", "weight": 0.1},
    {"name": "VisibilityPriorLoss01", "weight": 0.001},
)


def with_vip_prior(cfg: dict, masks_dirname: str = "VW02") -> dict:
    """`cfg` with ViP-NeRF's visibility prior trained: visibility heads on
    the coarse and fine MLPs, the prior masks' data, VisibilityLoss01 and
    VisibilityPriorLoss01 (the weights of `with_visibility_priors`), and
    `train_secondary_views`, which makes the train step render each ray's
    visibility from its frame's other train cameras."""
    cfg = copy.deepcopy(cfg)
    for level in ("coarse_mlp", "fine_mlp"):
        cfg["model"][level]["predict_visibility"] = True
    cfg["model"]["name"] = "ViPNeRF"
    cfg["model"]["train_secondary_views"] = True
    cfg["data_loader"]["visibility_prior"] = {"load_masks": True, "masks_dirname": masks_dirname}
    cfg["losses"] += [dict(spec) for spec in VIP_LOSSES]
    return cfg


def vipnerf_config(masks_dirname: str = "VW02", **kwargs) -> dict:
    """ViP-NeRF: `simplenerf_config` without the augmentations (a coarse and
    a fine 8x256 MLP, views 1x128, PE 10/4, 64 + 128 samples, 2048 NeRF +
    2048 sparse-depth rays, NDC, noise std 1, Adam 5e-4 with the 250k
    decay) and `with_vip_prior`: MSE01, SparseDepthMSE01 0.1,
    VisibilityLoss01 0.1, VisibilityPriorLoss01 0.001."""
    return with_vip_prior(simplenerf_config(with_augmentations=False, **kwargs), masks_dirname)
