"""The SimpleNeRF render step: coarse stratified sampling, the coarse MLPs,
importance sampling, the fine MLPs, compositing.

Port of simplenerf_tpu/render/renderer.py. The output dict follows the
reference key grammar `{prefix}{quantity}_{coarse|fine}` with the prefixes
'', 'points_augmentation_' and 'views_augmentation_', and `raw_*`
per-sample outputs when `retraw`. `train=True` adds stratified jitter,
sigma noise and the augmented models; a level with several members and no
secondary-view visibility runs them as one ensemble (`_run_level_ensemble`,
the coarse trio of the published recipe).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from simplenerf_torch.fields import mlp as mlp_lib
from simplenerf_torch.render import sampling, volume
from simplenerf_torch.utils import profiling

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
    # visibility2 path takes the kernels where they have secondary views
    # (`fused_mlp.secondary_supported`: bf16 on the card), else the
    # unfused MLP.
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
    noise_std: float = 0.0,
    noise: Optional[torch.Tensor] = None,
    sec: Optional[tuple] = None,
) -> dict:
    """Flatten (nr, ns, 3) points into one batch, evaluate, return planes:
    sigma (nr, ns), rgb (3, nr, ns), visibility (nr, ns), visibility2
    (nr, ns, k). View directions stay per ray except on the unfused
    visibility2 path, which needs per-sample directions; `sec` (the
    secondary operands of view_dirs2) takes the kernel path."""
    nr, ns = pts.shape[:2]
    flat_pts = pts.reshape(nr * ns, 3)
    kw = dict(noise_std=noise_std, noise=noise, dtype=dtype)
    if view_dirs2 is not None and sec is None:
        k = view_dirs2.shape[-2]
        flat_dirs = None
        if mcfg.use_view_dirs:
            flat_dirs = view_dirs[:, None, :].expand(pts.shape).reshape(nr * ns, 3)
        raw = mlp_lib.apply(
            params, mcfg, flat_pts,
            view_dirs=flat_dirs, view_dirs2=view_dirs2.reshape(nr * ns, k, 3), **kw,
        )
        return mlp_lib.to_planes(raw, nr, ns)
    dirs = view_dirs if mcfg.use_view_dirs else None
    if use_fused:
        return mlp_lib.apply_fused(params, mcfg, flat_pts, view_dirs=dirs, view_dirs_tile=ns,
                                   sec=sec, **kw)
    raw = mlp_lib.apply(params, mcfg, flat_pts, view_dirs=dirs, view_dirs_tile=ns, **kw)
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


def _points(cfg: RenderConfig, rays: dict, z_vals):
    o_key = "rays_o_ndc" if cfg.ndc else "rays_o"
    d_key = "rays_d_ndc" if cfg.ndc else "rays_d"
    return rays[o_key][..., None, :] + rays[d_key][..., None, :] * z_vals[..., :, None]


def _run_level_ensemble(
    cfg: RenderConfig, params: Params, members: list, z_vals, rays: dict, train: bool
) -> list:
    """Evaluate all of a level's MLPs at shared z values in one ensemble
    kernel (mlp.apply_fused_ensemble); composite each member."""
    pts = _points(cfg, rays, z_vals)
    nr, ns = pts.shape[:2]
    nets = mlp_lib.apply_fused_ensemble(
        [(params[name], mcfg) for name, _, mcfg, _ in members],
        pts.reshape(nr * ns, 3),
        view_dirs=rays.get("view_dirs"),
        noise_std=cfg.raw_noise_std if train else 0.0,
        noises=[noise for _, _, _, noise in members],
        dtype=cfg.dtype,
        view_dirs_tile=ns,
    )
    return [(_composite_level(cfg, net, z_vals, rays), net) for net in nets]


def _run_level(
    cfg: RenderConfig,
    params: Params,
    model_name: str,
    mcfg: mlp_lib.MLPConfig,
    z_vals: torch.Tensor,
    rays: dict,
    sec_views_vis: bool,
    train: bool = False,
    noise: Optional[torch.Tensor] = None,
) -> tuple[dict, dict]:
    """Evaluate one MLP at the given z values and composite."""
    pts = _points(cfg, rays, z_vals)
    use_fused = _use_fused(cfg, pts.device)

    view_dirs2 = sec = None
    if mcfg.predict_visibility and sec_views_vis and "rays_o2" in rays:
        # The secondary views' directions and, on the kernel path, their operands.
        with profiling.span("field.secondary", device=pts.device):
            view_dirs2 = _other_view_dirs(cfg, z_vals, rays["rays_o"], rays["rays_d"],
                                          rays["rays_o2"])
            if use_fused and _fused_secondary(cfg, mcfg, pts.shape[1], pts.device):
                sec = mlp_lib.secondary_operands(params[model_name], mcfg, view_dirs2, cfg.dtype)

    net_out = _eval_mlp(
        params[model_name],
        mcfg,
        pts,
        rays.get("view_dirs"),
        view_dirs2,
        cfg.dtype,
        use_fused=use_fused,
        noise_std=cfg.raw_noise_std if train else 0.0,
        noise=noise,
        sec=sec,
    )
    return _composite_level(cfg, net_out, z_vals, rays), net_out


def _fused_secondary(cfg: RenderConfig, mcfg: mlp_lib.MLPConfig, ns: int, device) -> bool:
    """Whether the kernels take this MLP's secondary views (`fused_mlp.secondary_supported`)."""
    from simplenerf_torch.ops import fused_mlp

    return fused_mlp.secondary_supported(fused_mlp.make_spec(mcfg, ns, cfg.dtype), device)


_LEVEL_MEMBERS = {
    "coarse": (("coarse", ""), ("points_aug_coarse", "points_augmentation_"),
               ("views_aug_coarse", "views_augmentation_")),
    "fine": (("fine", ""), ("points_aug_fine", "points_augmentation_"),
             ("views_aug_fine", "views_augmentation_")),
}


def step_draws(cfg: RenderConfig, nr: int, generator: torch.Generator, device,
               u_coarse: Optional[torch.Tensor] = None, u_fine: Optional[torch.Tensor] = None,
               noise: Optional[dict] = None) -> dict:
    """A train step's random draws for `nr` rays from `generator`, in
    render_rays' order: coarse jitter, each coarse member's sigma noise,
    fine uniforms, each fine member's sigma noise. Draws already given are
    kept and take nothing from the generator. Returns render_rays' keywords
    {u_coarse, u_fine, noise}: with a ray-sharded batch, each rank draws at
    the global ray count and keeps its rows, so the job draws the numbers
    of the one-process step."""
    noise = dict(noise or {})
    ns = 0

    def members_noise(level: str):
        for name, _ in _LEVEL_MEMBERS[level]:
            if getattr(cfg, f"{name}_mlp") is not None and name not in noise and cfg.raw_noise_std > 0.0:
                noise[name] = torch.randn((nr, ns), generator=generator, device=device)

    if cfg.coarse_mlp is not None:
        ns = cfg.coarse_mlp.num_samples
        if cfg.perturb and u_coarse is None:
            u_coarse = torch.rand((nr, ns), generator=generator, dtype=torch.float32, device=device)
        members_noise("coarse")
    if cfg.fine_mlp is not None:
        if cfg.perturb and u_fine is None:
            u_fine = torch.rand((nr, cfg.fine_mlp.num_samples), generator=generator,
                                dtype=torch.float32, device=device)
        ns += cfg.fine_mlp.num_samples
        members_noise("fine")
    return {"u_coarse": u_coarse, "u_fine": u_fine, "noise": noise}


def render_rays(
    params: Params,
    cfg: RenderConfig,
    rays: dict,
    train: bool = False,
    sec_views_vis: bool = False,
    retraw: Optional[bool] = None,
    keep_per_sample: bool = True,
    generator: Optional[torch.Generator] = None,
    u_coarse: Optional[torch.Tensor] = None,
    u_fine: Optional[torch.Tensor] = None,
    noise: Optional[dict] = None,
) -> dict:
    """Render a batch of rays through the SimpleNeRF hierarchy.

    rays: dict with 'rays_o', 'rays_d', 'view_dirs', 'near', 'far' (nr, 1)
    (+ '_ndc' variants when cfg.ndc, + optional 'rays_o2' (nr, k, 3)).
    `train` enables stratified jitter, sigma noise, stochastic importance
    sampling and the augmented models (the reference's training graph).
    Draws are given, `u_coarse` (nr, ns_c), `u_fine` (nr, ns_f) and
    `noise` {MLP name: standard-normal (nr, ns)}, or come from `generator`
    (on the rays' device) through `step_draws`.

    Returns the reference-keyed output dict. With keep_per_sample=False,
    per-sample tensors (alpha/weights/visibility/z_vals/raw) are dropped to
    keep full-image renders lean.
    """
    if retraw is None:
        retraw = train
    out: dict = {}

    near = rays["near_ndc"] if cfg.ndc else rays["near"]
    far = rays["far_ndc"] if cfg.ndc else rays["far"]
    nr = near.shape[0]
    device = near.device
    perturb = cfg.perturb and train
    if train and generator is not None:
        draws = step_draws(cfg, nr, generator, device, u_coarse, u_fine, noise)
        u_coarse, u_fine, noise = draws["u_coarse"], draws["u_fine"], draws["noise"]
    noise = noise or {}

    def emit(prefix: str, level: str, composited: dict, net_out: dict):
        for k, v in composited.items():
            out[f"{prefix}{k}_{level}"] = v
        if retraw:
            for k, v in net_out.items():
                out[f"{prefix}raw_{k}_{level}"] = v.permute(1, 2, 0) if k == "rgb" else v

    def run(level: str, z_vals):
        members = []
        for name, prefix in _LEVEL_MEMBERS[level]:
            mcfg = getattr(cfg, f"{name}_mlp")
            if mcfg is None or (prefix and not train):
                continue
            members.append((name, prefix, mcfg, noise.get(name)))
        needs_vis2 = (
            sec_views_vis
            and "rays_o2" in rays
            and any(mcfg.predict_visibility for _, _, mcfg, _ in members)
        )
        if len(members) > 1 and not needs_vis2 and _use_fused(cfg, device):
            results = _run_level_ensemble(cfg, params, members, z_vals, rays, train)
        else:
            results = [
                _run_level(cfg, params, name, mcfg, z_vals, rays, sec_views_vis, train, n)
                for name, _, mcfg, n in members
            ]
        weights = None
        for (name, prefix, _, _), (comp, net) in zip(members, results):
            if not prefix:
                weights = comp["weights"]
            emit(prefix, level, comp, net)
        return weights

    weights_coarse = None
    z_coarse = None
    if cfg.coarse_mlp is not None:
        z_coarse = sampling.stratified_z_vals(
            near, far, cfg.coarse_mlp.num_samples, cfg.lindisp, perturb, u=u_coarse
        )
        out["z_vals_coarse"] = z_coarse
        weights_coarse = run("coarse", z_coarse)

    if cfg.fine_mlp is not None:
        z_fine = sampling.fine_z_vals(
            z_coarse, weights_coarse, cfg.fine_mlp.num_samples, perturb, u=u_fine
        )
        out["z_vals_fine"] = z_fine
        run("fine", z_fine)

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
