"""The SimpleNeRF render step: coarse stratified sampling, coarse MLP,
importance sampling, fine MLP, compositing.

Port of simplenerf_tpu/render/renderer.py for the serving path. The output
dict follows the reference key grammar `{prefix}{quantity}_{coarse|fine}`,
with `raw_*` per-sample outputs when `retraw`.

`train=True` (stratified jitter, sigma noise, the augmented models) comes
with the training slice, which also brings the ensemble and backward
kernels; here it raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from simplenerf_torch.fields import mlp as mlp_lib
from simplenerf_torch.render import sampling, volume

Params = Any


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration."""

    coarse_mlp: Optional[mlp_lib.MLPConfig]
    fine_mlp: Optional[mlp_lib.MLPConfig] = None
    points_aug_coarse_mlp: Optional[mlp_lib.MLPConfig] = None
    points_aug_fine_mlp: Optional[mlp_lib.MLPConfig] = None
    views_aug_coarse_mlp: Optional[mlp_lib.MLPConfig] = None
    views_aug_fine_mlp: Optional[mlp_lib.MLPConfig] = None
    ndc: bool = True
    lindisp: bool = False
    perturb: bool = True
    raw_noise_std: float = 1.0
    white_bkgd: bool = False
    # Matmul input precision for the MLPs ("float32" | "bfloat16").
    compute_dtype: str = "float32"
    # Fused MLP kernel: always on for CUDA tensors ("off" raises there); on
    # CPU "on" takes its plain version, "auto"/"off" the unfused MLP. The
    # visibility2 path always uses the unfused MLP.
    fused_mlp: str = "auto"

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    @property
    def predict_visibility(self) -> bool:
        return bool(
            (self.coarse_mlp and self.coarse_mlp.predict_visibility)
            or (self.fine_mlp and self.fine_mlp.predict_visibility)
        )

    def mlp_items(self) -> list[tuple[str, mlp_lib.MLPConfig]]:
        """(param_key, cfg) for every MLP present."""
        items = []
        for name in (
            "coarse_mlp",
            "fine_mlp",
            "points_aug_coarse_mlp",
            "points_aug_fine_mlp",
            "views_aug_coarse_mlp",
            "views_aug_fine_mlp",
        ):
            cfg = getattr(self, name)
            if cfg is not None:
                items.append((name.replace("_mlp", ""), cfg))
        return items


def init(generator: torch.Generator, cfg: RenderConfig, device="cpu") -> Params:
    """Parameters for every MLP in the ensemble, keyed by MLP name."""
    return {name: mlp_lib.init(generator, c, device) for name, c in cfg.mlp_items()}


def _eval_mlp(
    params,
    mcfg: mlp_lib.MLPConfig,
    pts: torch.Tensor,
    view_dirs: Optional[torch.Tensor],
    view_dirs2: Optional[torch.Tensor],
    dtype,
    use_fused: bool,
) -> dict:
    """Flatten (nr, ns, 3) points into one batch, evaluate, return planes:
    sigma (nr, ns), rgb (3, nr, ns), visibility (nr, ns), visibility2
    (nr, ns, k). View directions stay per ray except on the visibility2
    path, which needs per-sample directions."""
    nr, ns = pts.shape[:2]
    flat_pts = pts.reshape(nr * ns, 3)
    if view_dirs2 is not None:
        k = view_dirs2.shape[-2]
        flat_dirs = None
        if mcfg.use_view_dirs:
            flat_dirs = view_dirs[:, None, :].expand(pts.shape).reshape(nr * ns, 3)
        raw = mlp_lib.apply(
            params, mcfg, flat_pts,
            view_dirs=flat_dirs, view_dirs2=view_dirs2.reshape(nr * ns, k, 3), dtype=dtype,
        )
        return mlp_lib.to_planes(raw, nr, ns)
    dirs = view_dirs if mcfg.use_view_dirs else None
    if use_fused:
        return mlp_lib.apply_fused(params, mcfg, flat_pts, view_dirs=dirs, dtype=dtype,
                                   view_dirs_tile=ns)
    raw = mlp_lib.apply(params, mcfg, flat_pts, view_dirs=dirs, dtype=dtype, view_dirs_tile=ns)
    return mlp_lib.to_planes(raw, nr, ns)


def _other_view_dirs(cfg: RenderConfig, z_vals, rays_o, rays_d, rays_o2) -> torch.Tensor:
    """Unit vectors from secondary camera origins to each sample point; NDC
    z values are first mapped back to metric along-ray distances."""
    if cfg.ndc:
        near = 1.0
        tn = -(near + rays_o[..., 2]) / rays_d[..., 2]
        z_vals = (
            (rays_o[..., None, 2] + tn[..., None] * rays_d[..., None, 2]) / (1.0 - z_vals + 1e-6)
            - rays_o[..., None, 2]
        ) / rays_d[..., None, 2]
    pts = rays_o[..., None, :] + z_vals[..., None] * rays_d[..., None, :]
    d = pts[:, :, None] - rays_o2[..., None, :, :]  # (nr, ns, k, 3)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def _use_fused(cfg: RenderConfig, device: torch.device) -> bool:
    """On the card the field always goes through the kernel; on the CPU
    "on" takes the kernel's plain version and "auto"/"off" the unfused MLP."""
    if device.type == "cuda":
        if cfg.fused_mlp == "off":
            raise ValueError("fused_mlp='off' has no CUDA path: on the card the field runs the kernel")
        return True
    return cfg.fused_mlp == "on"


def _composite_level(cfg: RenderConfig, net_out: dict, z_vals, rays: dict) -> dict:
    d_key = "rays_d_ndc" if cfg.ndc else "rays_d"
    return volume.composite(
        net_out["sigma"],
        net_out["rgb"],
        z_vals,
        rays[d_key],
        ndc=cfg.ndc,
        rays_o_world=rays["rays_o"] if cfg.ndc else None,
        rays_d_world=rays["rays_d"] if cfg.ndc else None,
        white_bkgd=cfg.white_bkgd,
        vis2=net_out.get("visibility2"),
    )


def _run_level(
    cfg: RenderConfig,
    params: Params,
    model_name: str,
    mcfg: mlp_lib.MLPConfig,
    z_vals: torch.Tensor,
    rays: dict,
    sec_views_vis: bool,
) -> tuple[dict, dict]:
    """Evaluate one MLP at the given z values and composite."""
    o_key = "rays_o_ndc" if cfg.ndc else "rays_o"
    d_key = "rays_d_ndc" if cfg.ndc else "rays_d"
    pts = rays[o_key][..., None, :] + rays[d_key][..., None, :] * z_vals[..., :, None]

    view_dirs2 = None
    if mcfg.predict_visibility and sec_views_vis and "rays_o2" in rays:
        view_dirs2 = _other_view_dirs(cfg, z_vals, rays["rays_o"], rays["rays_d"], rays["rays_o2"])

    net_out = _eval_mlp(
        params[model_name],
        mcfg,
        pts,
        rays.get("view_dirs"),
        view_dirs2,
        cfg.dtype,
        use_fused=_use_fused(cfg, pts.device),
    )
    return _composite_level(cfg, net_out, z_vals, rays), net_out


def render_rays(
    params: Params,
    cfg: RenderConfig,
    rays: dict,
    train: bool = False,
    sec_views_vis: bool = False,
    retraw: Optional[bool] = None,
    keep_per_sample: bool = True,
) -> dict:
    """Render a batch of rays through the coarse/fine hierarchy (eval mode).

    rays: dict with 'rays_o', 'rays_d', 'view_dirs', 'near', 'far' (nr, 1)
    (+ '_ndc' variants when cfg.ndc, + optional 'rays_o2' (nr, k, 3)).
    Returns the reference-keyed output dict. With keep_per_sample=False,
    per-sample tensors (alpha/weights/visibility/z_vals/raw) are dropped to
    keep full-image renders lean.
    """
    if train:
        raise NotImplementedError(
            "train=True (jitter, sigma noise, augmented models) comes with the training slice"
        )
    if retraw is None:
        retraw = train
    out: dict = {}

    near = rays["near_ndc"] if cfg.ndc else rays["near"]
    far = rays["far_ndc"] if cfg.ndc else rays["far"]

    def emit(level: str, composited: dict, net_out: dict):
        for k, v in composited.items():
            out[f"{k}_{level}"] = v
        if retraw:
            for k, v in net_out.items():
                out[f"raw_{k}_{level}"] = v.permute(1, 2, 0) if k == "rgb" else v

    weights_coarse = None
    z_coarse = None
    if cfg.coarse_mlp is not None:
        z_coarse = sampling.stratified_z_vals(near, far, cfg.coarse_mlp.num_samples, cfg.lindisp)
        out["z_vals_coarse"] = z_coarse
        comp, net = _run_level(cfg, params, "coarse", cfg.coarse_mlp, z_coarse, rays, sec_views_vis)
        weights_coarse = comp["weights"]
        emit("coarse", comp, net)

    if cfg.fine_mlp is not None:
        z_fine = sampling.fine_z_vals(z_coarse, weights_coarse, cfg.fine_mlp.num_samples)
        out["z_vals_fine"] = z_fine
        comp, net = _run_level(cfg, params, "fine", cfg.fine_mlp, z_fine, rays, sec_views_vis)
        emit("fine", comp, net)

    if not keep_per_sample:
        drop = [
            k
            for k in out
            if k.startswith("z_vals")
            or "alpha" in k
            or "weights" in k
            or k.startswith("raw_")
            or ("visibility_" in k)
        ]
        for k in drop:
            del out[k]
    return out
