"""mip-NeRF's render step, as FreeNeRF trains it: conical frustums between
interval edges, their integrated positional encoding (IPE), one field MLP
at both levels, blur-resampling, compositing over intervals.

Written from mip-NeRF (Barron et al., ICCV 2021: `sample_along_rays`,
`cast_rays` / `conical_frustum_to_gaussian`, `integrated_pos_enc`,
`volumetric_rendering`, `resample_along_rays`,
`sorted_piecewise_constant_pdf`) and FreeNeRF (Yang, Pavone and Wang,
CVPR 2023: `get_freq_reg_mask`). A level of nr rays and ns intervals:

- edges t (nr, ns + 1): coarse, `linspace(near, far, ns + 1)` stratified
  by one uniform an edge; fine, ns + 1 fresh edges drawn from the coarse
  weights (padded, max of neighbours, blurred with (1/2, 1/2), + 0.01) by
  inverting their piecewise-constant CDF at the stratified uniforms (i +
  u_i) / (ns + 1), clamped below 1, without gradient and not merged with
  the coarse edges;
- the points operand lo: the frustums' IPE at `points_pe_degree` octaves,
  [mean | sin | cos] in the kernels' blocked order, times the step's
  points frequency mask (`fused_mlp.ipe_operands`: the kernel on the card;
  span `field.ipe`); the views operand: the view directions' PE times the
  views mask, through the first views layer's dirs rows (`hvx`);
- the field: one MLP's raw planes (`fused_mlp.fused_apply`: the kernel on
  the card, its plain version on the CPU, whatever `fused_mlp`), sigma =
  softplus(raw + noise - 1), rgb = sigmoid(raw) (1 + 2 0.001) - 0.001;
- compositing: delta = (t1 - t0) |d|, alpha = 1 - exp(-sigma delta),
  weights alpha T with T = exp(-cumsum of sigma delta before), depth over
  the intervals' middles.

Both levels read the same leaves (`params["mlp"]`), so autograd sums the
two levels' gradients. Outputs: `{rgb, acc, weights, depth, depth_var,
depth_ndc, depth_var_ndc, density, t_vals, ipe}_{coarse,fine}`, density the
per-interval sigma that FreeNeRF's occlusion loss reads, ipe the level's
points operand lo.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from simplenerf_torch.fields import encoding
from simplenerf_torch.fields import mlp as mlp_lib
from simplenerf_torch.geometry import projection
from simplenerf_torch.utils import profiling

RESAMPLE_PADDING = 0.01  # mip-NeRF's resample_padding
DENSITY_BIAS = -1.0  # mip-NeRF's density_bias
RGB_PADDING = 0.001  # mip-NeRF's rgb_padding
PDF_EPS = 1e-5  # sorted_piecewise_constant_pdf's floor of a ray's weight sum
U_MAX = 1.0 - float(np.finfo(np.float32).eps)  # the largest stratified uniform


def freq_mask(length: int, step: int, end: int) -> np.ndarray:
    """FreeNeRF's frequency mask (`get_freq_reg_mask`) of `length` encoding
    channels at `step` of a schedule that ends at `end`: all ones once step
    >= end; before, with p = (length / 3) step / end + 1 and k = floor(p),
    the first 3k channels 1, the next 3 at p - k, the rest 0."""
    if step >= end:
        return np.ones(length, np.float32)
    p = length / 3.0 * step / end + 1.0
    k = int(p)
    out = np.zeros(length, np.float64)
    out[: 3 * k] = 1.0
    out[3 * k : 3 * k + 3] = p - k
    return out.astype(np.float32)


def mask_lengths(mcfg: mlp_lib.MLPConfig) -> tuple[int, int]:
    """Channels of the points (IPE) and the views operand: (3 + 6 L, 3 + 6 Lv)."""
    return encoding.out_dim(mcfg.points_pe_degree), encoding.out_dim(mcfg.views_pe_degree)


def step_masks(mcfg: mlp_lib.MLPConfig, step: int, end: int) -> np.ndarray:
    """The step's points mask and views mask, one float32 vector."""
    return np.concatenate([freq_mask(n, step, end) for n in mask_lengths(mcfg)])


def step_draws(mcfg: mlp_lib.MLPConfig, noise_std: float, nr: int, generator: torch.Generator,
               device) -> dict:
    """A train step's draws from `generator`, in the render's order: the
    coarse edges' uniforms (nr, ns + 1), the coarse sigma noise (nr, ns),
    the fine stratified uniforms (nr, ns + 1), the fine sigma noise."""
    ns = mcfg.num_samples
    out = {"u_coarse": None, "u_fine": None, "noise": {}}
    for level in ("coarse", "fine"):
        out[f"u_{level}"] = torch.rand((nr, ns + 1), generator=generator, dtype=torch.float32,
                                       device=device)
        if noise_std > 0.0:
            out["noise"][level] = torch.randn((nr, ns), generator=generator, device=device)
    return out


def coarse_edges(near, far, n_edges: int, u: Optional[torch.Tensor]) -> torch.Tensor:
    """linspace(near, far, n_edges) per ray, each edge moved to lower +
    (upper - lower) u within the midpoints around it (u None: unmoved)."""
    s = torch.linspace(0.0, 1.0, n_edges, dtype=torch.float32, device=near.device)
    t = near * (1.0 - s) + far * s
    if u is None:
        return t
    mids = 0.5 * (t[:, 1:] + t[:, :-1])
    upper = torch.cat([mids, t[:, -1:]], dim=-1)
    lower = torch.cat([t[:, :1], mids], dim=-1)
    return lower + (upper - lower) * u


def resample(t: torch.Tensor, weights: torch.Tensor, u: Optional[torch.Tensor]) -> torch.Tensor:
    """mip-NeRF's fine edges: as many as t's, from the blurred, padded
    coarse weights through the inverse of their piecewise-constant CDF over
    t, at the stratified uniforms (i + u_i) / n (u None: evenly spaced, the
    eval render), without gradient."""
    with torch.no_grad():
        w = weights.detach()
        wp = torch.cat([w[:, :1], w, w[:, -1:]], dim=-1)
        wmax = torch.maximum(wp[:, :-1], wp[:, 1:])
        w = 0.5 * (wmax[:, :-1] + wmax[:, 1:]) + RESAMPLE_PADDING
        wsum = w.sum(-1, keepdim=True)
        pad = (PDF_EPS - wsum).clamp(min=0.0)
        w = w + pad / w.shape[-1]
        pdf = w / (wsum + pad)
        cdf = torch.cumsum(pdf[:, :-1], dim=-1).clamp(max=1.0)
        cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf, torch.ones_like(cdf[:, :1])], dim=-1)
        n = t.shape[-1]
        i = torch.arange(n, dtype=torch.float32, device=t.device)
        if u is None:
            s = torch.linspace(0.0, U_MAX, n, dtype=torch.float32, device=t.device).expand(t.shape)
        else:
            s = ((i + u) / n).clamp(max=U_MAX)
        s = s.contiguous()
        # the last edge whose cdf <= s and the first above it (mip-NeRF's
        # masked max and min over the sorted edges)
        above = torch.searchsorted(cdf.contiguous(), s, right=True)
        below = (above - 1).clamp(min=0)
        above = above.clamp(max=n - 1)
        c0, c1 = cdf.gather(-1, below), cdf.gather(-1, above)
        b0, b1 = t.gather(-1, below), t.gather(-1, above)
        frac = torch.nan_to_num((s - c0) / (c1 - c0), nan=0.0).clamp(0.0, 1.0)
        return b0 + frac * (b1 - b0)


def composite(sigma, rgb, t, rays: dict) -> dict:
    """mip-NeRF's compositing over intervals: sigma (nr, ns), rgb (3, nr,
    ns) planes, edges t (nr, ns + 1) in NDC along rays_d_ndc."""
    delta = (t[:, 1:] - t[:, :-1]) * torch.linalg.norm(rays["rays_d_ndc"], dim=-1, keepdim=True)
    sd = sigma * delta
    alpha = 1.0 - torch.exp(-sd)
    trans = torch.exp(-torch.cat([torch.zeros_like(sd[:, :1]), torch.cumsum(sd[:, :-1], dim=-1)],
                                 dim=-1))
    weights = alpha * trans
    acc = weights.sum(-1)
    mids = 0.5 * (t[:, 1:] + t[:, :-1])
    out = {"rgb": torch.sum(weights[None] * rgb, dim=-1).T, "acc": acc, "weights": weights}
    metric = projection.depth_from_ndc(mids, rays["rays_o"], rays["rays_d"])
    for key, z in (("_ndc", mids), ("", metric)):
        depth = torch.sum(weights * z, dim=-1)
        out["depth" + key] = depth
        out["depth_var" + key] = torch.sum(weights * torch.square(z - depth[:, None]), dim=-1)
    return out


class Field:
    """The shared MLP's operands that both levels of a step use: its kernel
    parameters (one gather) and the per-ray views term hvx, from the
    view directions' PE times the views mask."""

    def __init__(self, params, mcfg: mlp_lib.MLPConfig, view_dirs, views_mask, dtype):
        from simplenerf_torch.ops import fused_mlp

        self.mcfg, self.dtype = mcfg, dtype
        self.cdtype = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
        with profiling.span("field.encode", device=view_dirs.device):
            xv, sv, cv = encoding.encode_parts(view_dirs, mcfg.views_pe_degree)
            enc = mlp_lib._cat_parts(xv, sv, cv)
            if views_mask is not None:
                enc = enc * views_mask
            self.hvx = mlp_lib._mm(enc, fused_mlp.dirs_w(params, mcfg), dtype).contiguous()
            self.kp = fused_mlp.kernel_params(params, mcfg)

    def planes(self, lo, ns: int) -> list:
        """Raw planes [sigma, r, g, b] at the points operand lo (nr ns, 3 + 6 L)."""
        from simplenerf_torch.ops import fused_mlp

        spec = fused_mlp.make_spec(self.mcfg, ns, self.dtype)
        return list(fused_mlp.fused_apply(spec, self.kp, lo, None, self.hvx))


def _level(field: Field, rays: dict, t, noise, noise_std: float, points_mask) -> dict:
    """One level at edges t: the IPE operand, the field, the activations and
    compositing; adds the per-interval density, the edges and the IPE
    operand."""
    from simplenerf_torch.ops import fused_mlp

    mcfg = field.mcfg
    ns = t.shape[1] - 1
    with profiling.span("field.ipe", device=t.device):
        lo = fused_mlp.ipe_operands(rays["rays_o_ndc"], rays["rays_d_ndc"], rays["radii_ndc"],
                                    t.contiguous(), mcfg.points_pe_degree, points_mask, field.cdtype)
    raw = field.planes(lo, ns)
    raw_sigma = raw[0]
    if noise is not None and noise_std > 0.0:
        raw_sigma = raw_sigma + noise_std * noise
    sigma = torch.nn.functional.softplus(raw_sigma + DENSITY_BIAS)
    rgb = torch.sigmoid(torch.stack(raw[1:4])) * (1.0 + 2.0 * RGB_PADDING) - RGB_PADDING
    out = composite(sigma, rgb, t, rays)
    out.update(density=sigma, t_vals=t, ipe=lo)
    return out


def render_rays(params, cfg, rays: dict, train: bool = False, keep_per_sample: bool = True,
                u_coarse=None, u_fine=None, noise: Optional[dict] = None,
                freq_mask: Optional[torch.Tensor] = None) -> dict:
    """Both levels of mip-NeRF through one MLP (`cfg.shared_mlp`, leaves
    `params["mlp"]`). rays: the NDC rays with `radii_ndc` (nr, 1), the
    world rays and `view_dirs`, `near_ndc` / `far_ndc`. train: the edges'
    uniforms `u_coarse`, `u_fine` (nr, ns + 1) and the sigma noise
    {level: (nr, ns)} (`step_draws`) are used, and `freq_mask`, the step's
    points and views masks in one vector (`step_masks`); eval: evenly
    spaced edges, no noise, masks of ones unless given."""
    mcfg = cfg.shared_mlp
    n_pts, _ = mask_lengths(mcfg)
    pmask = vmask = None
    if freq_mask is not None:
        pmask, vmask = freq_mask[:n_pts], freq_mask[n_pts:]
    noise = (noise or {}) if train else {}
    field = Field(params["mlp"], mcfg, rays["view_dirs"], vmask, cfg.dtype)
    out: dict = {}
    t = coarse_edges(rays["near_ndc"], rays["far_ndc"], mcfg.num_samples + 1,
                     u_coarse if train and cfg.perturb else None)
    for level in ("coarse", "fine"):
        if level == "fine":
            t = resample(t, out["weights_coarse"], u_fine if train and cfg.perturb else None)
        res = _level(field, rays, t, noise.get(level), cfg.raw_noise_std if train else 0.0, pmask)
        out.update({f"{k}_{level}": v for k, v in res.items()})
    if not keep_per_sample:
        for k in [k for k in out if k.split("_")[0] in ("weights", "density", "t", "ipe")]:
            del out[k]
    return out
