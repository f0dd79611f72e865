"""Ray sampling: stratified coarse z-values and inverse-CDF importance sampling.

Reference behavior: SimpleNeRF01.get_z_vals_coarse, get_z_vals_fine and
sample_pdf, as ported in simplenerf_tpu/render/sampling.py. Random draws are
explicit: a `torch.Generator`, or the uniforms themselves (`u`) so that a
test can hand both frameworks the same numbers.
"""

from __future__ import annotations

from typing import Optional

import torch


def stratified_z_vals(
    near: torch.Tensor,
    far: torch.Tensor,
    num_samples: int,
    lindisp: bool = False,
    perturb: bool = False,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Coarse z-values: uniform in depth (or disparity), optional stratified jitter.

    near/far: (num_rays, 1). Returns (num_rays, num_samples). Without
    perturb (eval) this is the deterministic linspace.
    """
    t = torch.linspace(0.0, 1.0, num_samples, dtype=torch.float32, device=near.device)
    if not lindisp:
        z = near * (1.0 - t) + far * t
    else:
        z = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)

    if perturb:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], dim=-1)
        lower = torch.cat([z[..., :1], mids], dim=-1)
        if u is None:
            u = torch.rand(z.shape, generator=generator, dtype=z.dtype).to(z.device)
        z = lower + (upper - lower) * u
    return z


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    deterministic: bool = False,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse-CDF importance sampling of `num_samples` points per ray.

    bins: (num_rays, m) sorted bin edges; weights: (num_rays, m-1). The
    reference's edge handling: +1e-5 weight floor, right-sided search,
    denominator guard for degenerate intervals. `torch.searchsorted(...,
    right=True)` gives the same brackets as the TPU version's compare-all
    inversion: the cdf starts at 0 <= u, so the index is >= 1, and the
    upper bracket is clamped to the last entry.
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (nr, m)

    if u is None:
        shape = (*cdf.shape[:-1], num_samples)
        if deterministic:
            u = torch.linspace(0.0, 1.0, num_samples, dtype=cdf.dtype, device=cdf.device)
            u = u.expand(shape)
        else:
            u = torch.rand(shape, generator=generator, dtype=cdf.dtype).to(cdf.device)
    u = u.contiguous()

    m = cdf.shape[-1]
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (idx - 1).clamp(min=0)
    above = idx.clamp(max=m - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def fine_z_vals(
    z_vals_coarse: torch.Tensor,
    weights_coarse: torch.Tensor,
    num_samples_fine: int,
    perturb: bool = False,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Importance samples from the coarse weights, unioned and sorted.

    Midpoint bins, first/last coarse weights dropped, as the reference
    does. The samples carry no gradient (the reference detaches them).
    """
    z_mid = 0.5 * (z_vals_coarse[..., 1:] + z_vals_coarse[..., :-1])
    z_samples = sample_pdf(
        z_mid, weights_coarse[..., 1:-1], num_samples_fine,
        deterministic=not perturb, generator=generator, u=u,
    ).detach()
    return torch.sort(torch.cat([z_vals_coarse, z_samples], dim=-1), dim=-1).values
