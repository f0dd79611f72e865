"""Plain PyTorch reference of the FreeNeRF LLFF train step.

Written from the published methods: mip-NeRF (Barron et al., ICCV 2021,
github.com/google/mipnerf: `sample_along_rays`, `cast_rays` with
`conical_frustum_to_gaussian` and `lift_gaussian`, `integrated_pos_enc`,
the MLP, `volumetric_rendering`, `resample_along_rays`,
`sorted_piecewise_constant_pdf`, its loss with coarse_loss_mult 0.1 and its
log-linear learning rate) and FreeNeRF (Yang, Pavone and Wang, CVPR 2023,
github.com/Jiawei-Yang/FreeNeRF: `get_freq_reg_mask`, the occlusion
regulariser of its Eq. 4). It imports nothing of `simplenerf_torch` and
takes nothing the program made; it reuses the SimpleNeRF reference's scene
normalisation, NDC rays, product rounding and TF32 switch
(`benchmark/reference.py`, by import). From the loader's output, the
configuration and the weights it works out the rays of a batch with their
NDC form and mip-NeRF's NDC radii (from the NDC origins of the pixel's
neighbours below and to the right), the batch sampler's permutations, the
step's draws, both levels through the one MLP, the two losses, the
gradients and Adam.

Departures from the published descriptions, all of them the benchmark's
choices shared with the program under test:
- the weights are the program's canonical layout: an encoding's rows in
  the interleaved order [x, sin 2^0 x, cos 2^0 x, sin 2^1 x, ...], and the
  skip join's input rows before the trunk's (mip-NeRF concatenates the
  input after); the frequency masks, defined on the blocked order [x | sin
  | cos], are applied channel by channel in that interleaved order;
- pixel rays through integer pixel corners (the port's ray cache; mip-NeRF
  offsets by half a pixel); near 0 and far 1 in NDC, lindisp off;
- sin of the scaled mean directly (mip-NeRF's safe_sin reduces arguments
  above 100 pi modulo 100 pi first);
- the fine level's stratified uniforms are (i + u_i) / (ns + 1) with u_i in
  [0, 1), clamped at 1 - eps (mip-NeRF draws u_i in [0, 1 - eps (ns + 1)));
- no gradient clipping, no weight decay; Adam's lr follows the step count
  from a fresh state; sigma noise of std `raw_noise_std` on raw density at
  both levels; the occlusion loss at both levels, summed;
- each level of a step is evaluated whole (4096 rays x 128 intervals: the
  float32 activations autograd keeps come to ~11 GB a level);
- products round their operands to the configuration's precision and
  accumulate in float32 (`reference.Precision`), TF32 off.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import reference as base

RESAMPLE_PADDING, DENSITY_BIAS, RGB_PADDING = 0.01, -1.0, 0.001


# --------------------------------------------------------------------------
# The train scene: rays of any pixel with their radii, and the sampler


class FreeScene:
    """The LLFF train scene: normalised poses, every pixel's ray by index,
    the epoch sampler of 4096-ray batches over the train views' pixels."""

    def __init__(self, raw: dict, configs: dict, seed: int, device):
        dl = configs["data_loader"]
        self.s = base.normalise_scene(raw, dl["bd_factor"])
        self.device = device
        self.n = len(raw["frame_nums"])
        t = lambda a: torch.as_tensor(np.asarray(a), device=device)  # noqa: E731
        self.images = t(raw["nerf_data"]["images"].astype(np.float32) / 255.0)
        self.poses = t(self.s["poses"])
        self.K = t(self.s["K"])
        self.rng = np.random.default_rng(seed)
        self.pool = np.arange(self.n * self.s["h"] * self.s["w"])
        self.perm, self.cursor, self.count = self.rng.permutation(self.pool), 0, dl["num_rays"]

    def _next(self) -> np.ndarray:
        out, count = [], self.count
        while count > 0:
            take = min(count, len(self.perm) - self.cursor)
            out.append(self.perm[self.cursor : self.cursor + take])
            self.cursor += take
            count -= take
            if self.cursor >= len(self.perm):
                self.perm, self.cursor = self.rng.permutation(self.pool), 0
        return np.concatenate(out)

    def skip(self, steps: int):
        for _ in range(steps):
            self._next()

    def rays(self, frame, x, y) -> tuple:
        """World and NDC rays of pixels (x, y) of frames `frame`."""
        h, w = self.s["h"], self.s["w"]
        K = self.K[frame]
        dx = (x.float() - K[:, 0, 2]) / K[:, 0, 0]
        dy = (y.float() - K[:, 1, 2]) / K[:, 1, 1]
        cam = torch.stack([dx, -dy, -torch.ones_like(dx)], -1)
        c2w = self.poses[frame]
        d = torch.einsum("nij,nj->ni", c2w[:, :3, :3], cam)
        o = c2w[:, :3, 3]
        o_n, d_n = base.ndc_rays(o, d, h, w, K[:, 0, 0], K[:, 1, 1], self.s["near"])
        return o, d, o_n, d_n

    def radii(self, frame, x, y):
        """mip-NeRF's NDC radii: the mean distance of the pixel's NDC origin
        to its neighbours' one row down and one column right (the last row
        and column take the pair before them), times 2 / sqrt(12)."""
        h, w = self.s["h"], self.s["w"]
        y0 = torch.where(y == h - 1, y - 1, y)
        x0 = torch.where(x == w - 1, x - 1, x)
        dist = []
        for (xa, ya), (xb, yb) in (((x, y0), (x, y0 + 1)), ((x0, y), (x0 + 1, y))):
            oa, ob = self.rays(frame, xa, ya)[2], self.rays(frame, xb, yb)[2]
            dist.append(((oa - ob) ** 2).sum(-1).sqrt())
        return (0.5 * (dist[0] + dist[1]) * 2.0 / math.sqrt(12.0))[:, None]

    def next_batch(self) -> dict:
        idx = torch.as_tensor(self._next(), device=self.device)
        h, w = self.s["h"], self.s["w"]
        frame, rem = idx // (h * w), idx % (h * w)
        y, x = rem // w, rem % w
        o, d, o_n, d_n = self.rays(frame, x, y)
        return {"rays_o": o, "rays_d": d, "view_dirs": d / d.norm(dim=-1, keepdim=True),
                "rays_o_ndc": o_n, "rays_d_ndc": d_n, "radii": self.radii(frame, x, y),
                "target_rgb": self.images[frame, y, x]}


# --------------------------------------------------------------------------
# FreeNeRF's frequency mask, the encodings


def freq_reg_mask(length: int, step: int, end: int) -> torch.Tensor:
    """FreeNeRF's `get_freq_reg_mask(length, step, end)`: ones once step >=
    end; else, with ptr = length / 3 * step / end + 1, ones on the first
    3 floor(ptr) channels, ptr - floor(ptr) on the next 3, zeros after."""
    m = np.zeros(length)
    if step >= end:
        m[:] = 1.0
    else:
        ptr = length / 3 * step / end + 1
        k = int(math.floor(ptr))
        m[: 3 * k] = 1.0
        m[3 * k : 3 * k + 3] = ptr - k
    return torch.as_tensor(m, dtype=torch.float32)


def _interleave(x, sins, coss, mask):
    """[x, sin_0, cos_0, sin_1, ...] (the weights' row order) with the mask
    of the blocked order [x | sin_l | cos_l] applied channel by channel."""
    deg = len(sins)
    feats = [x * mask[:3]]
    for i, (s, c) in enumerate(zip(sins, coss)):
        feats += [s * mask[3 + 3 * i : 6 + 3 * i], c * mask[3 + 3 * deg + 3 * i : 6 + 3 * deg + 3 * i]]
    return torch.cat(feats, -1)


def blocked(enc, deg: int):
    """The interleaved encoding's channels in the blocked order [x | sin_l |
    cos_l] (the order the frequency masks are defined on)."""
    idx = list(range(3)) + [3 + 6 * i + j for i in range(deg) for j in range(3)]
    idx += [6 + 6 * i + j for i in range(deg) for j in range(3)]
    return enc[:, idx]


def cast(t, o, d, radii):
    """mip-NeRF's conical frustums between consecutive edges t (nr, ns + 1)
    as Gaussians: means and diagonal covariances (nr, ns, 3)."""
    t0, t1 = t[:, :-1], t[:, 1:]
    mu, hw = (t0 + t1) / 2, (t1 - t0) / 2
    den = 3 * mu**2 + hw**2
    t_mean = mu + (2 * mu * hw**2) / den
    t_var = hw**2 / 3 - (4 / 15) * ((hw**4 * (12 * mu**2 - hw**2)) / den**2)
    r_var = radii**2 * ((mu**2) / 4 + (5 / 12) * hw**2 - 4 / 15 * (hw**4) / den)
    mean = o[:, None] + d[:, None] * t_mean[..., None]
    d_outer = d**2
    null_outer = 1 - d_outer / torch.clamp((d**2).sum(-1, keepdim=True), min=1e-10)
    cov = t_var[..., None] * d_outer[:, None] + r_var[..., None] * null_outer[:, None]
    return mean, cov


def ipe(mean, cov, deg: int, mask):
    """The integrated PE of Gaussians (n, 3), with the mean itself first:
    sin(2^l mean) exp(-1/2 4^l var) and cos, l < deg."""
    sins, coss = [], []
    for i in range(deg):
        y, y_var = mean * 2.0**i, cov * 4.0**i
        damp = torch.exp(-0.5 * y_var)
        sins.append(torch.sin(y) * damp)
        coss.append(torch.cos(y) * damp)
    return _interleave(mean, sins, coss, mask)


def dirs_pe(dirs, deg: int, mask):
    return _interleave(dirs, [torch.sin(dirs * 2.0**i) for i in range(deg)],
                       [torch.cos(dirs * 2.0**i) for i in range(deg)], mask)


# --------------------------------------------------------------------------
# The field, compositing, resampling


def field(p: dict, x_enc, v_enc, ns: int, prec):
    """Raw density (n,) and raw RGB (n, 3) of the MLP at encoded points; the
    views encoding per ray, repeated over its ns points."""
    h = x_enc
    for i, layer in enumerate(p["pts"]):
        h = torch.relu(base.dense(h, layer, prec))
        if i == 4:
            h = torch.cat([x_enc, h], -1)
    raw_density = base.dense(h, p["pts_out"], prec)[:, 0]
    bottleneck = base.dense(h, p["feature"], prec)
    hv = torch.cat([bottleneck, v_enc.repeat_interleave(ns, 0)], -1)
    for layer in p["views"]:
        hv = torch.relu(base.dense(hv, layer, prec))
    return raw_density, base.dense(hv, p["views_out"], prec)


def render_level(p, mlp, rays, t, prec, noise, noise_std, masks) -> dict:
    nr, ns = t.shape[0], t.shape[1] - 1
    mean, cov = cast(t, rays["rays_o_ndc"], rays["rays_d_ndc"], rays["radii"])
    x_enc = ipe(mean.reshape(-1, 3), cov.reshape(-1, 3), mlp["points_positional_encoding_degree"],
                masks[0])
    v_enc = dirs_pe(rays["view_dirs"], mlp["views_positional_encoding_degree"], masks[1])
    raw_density, raw_rgb = field(p, x_enc, v_enc, ns, prec)
    ipe_ms = prec.fwd(blocked(x_enc.detach(), mlp["points_positional_encoding_degree"])).square().mean(0)
    raw_density = raw_density + noise_std * noise.reshape(-1)
    density = torch.nn.functional.softplus(raw_density + DENSITY_BIAS).view(nr, ns)
    rgb = (torch.sigmoid(raw_rgb) * (1 + 2 * RGB_PADDING) - RGB_PADDING).view(nr, ns, 3)
    delta = (t[:, 1:] - t[:, :-1]) * rays["rays_d_ndc"].norm(dim=-1, keepdim=True)
    density_delta = density * delta
    alpha = 1 - torch.exp(-density_delta)
    trans = torch.exp(-torch.cat([torch.zeros_like(density_delta[:, :1]),
                                  torch.cumsum(density_delta[:, :-1], -1)], -1))
    weights = alpha * trans
    return {"rgb": (weights[..., None] * rgb).sum(1), "weights": weights, "density": density,
            "ipe": ipe_ms}


def sorted_piecewise_constant_pdf(bins, weights, u):
    """mip-NeRF's inverse CDF, its masked form, at uniforms u (nr, m)."""
    eps = 1e-5
    weight_sum = weights.sum(-1, keepdim=True)
    padding = torch.clamp(eps - weight_sum, min=0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding
    pdf = weights / weight_sum
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], -1), max=1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf, torch.ones_like(cdf[:, :1])], -1)
    mask = u[:, None, :] >= cdf[:, :, None]

    def find_interval(x):
        x0 = torch.where(mask, x[:, :, None], x[:, :1, None]).max(-2).values
        x1 = torch.where(~mask, x[:, :, None], x[:, -1:, None]).min(-2).values
        return x0, x1

    bins_g0, bins_g1 = find_interval(bins)
    cdf_g0, cdf_g1 = find_interval(cdf)
    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0), 0), 0, 1)
    return bins_g0 + t * (bins_g1 - bins_g0)


def resample_along_rays(t, weights, u):
    weights = weights.detach()
    pad = torch.cat([weights[:, :1], weights, weights[:, -1:]], -1)
    wmax = torch.maximum(pad[:, :-1], pad[:, 1:])
    blur = 0.5 * (wmax[:, :-1] + wmax[:, 1:]) + RESAMPLE_PADDING
    m = t.shape[-1]
    s = torch.clamp((torch.arange(m, device=t.device) + u) / m, max=1 - float(np.finfo(np.float32).eps))
    return sorted_piecewise_constant_pdf(t, blur, s).detach()


def render(params, mlp, rays, prec, draws, noise_std, masks) -> dict:
    """Both levels of a train step through the one MLP (`params["mlp"]`)."""
    nr, ns = rays["rays_o"].shape[0], mlp["num_samples"]
    t = torch.linspace(0.0, 1.0, ns + 1, device=rays["rays_o"].device).expand(nr, ns + 1)
    mids = 0.5 * (t[:, 1:] + t[:, :-1])
    upper = torch.cat([mids, t[:, -1:]], -1)
    lower = torch.cat([t[:, :1], mids], -1)
    t = lower + (upper - lower) * draws["u_coarse"]
    coarse = render_level(params["mlp"], mlp, rays, t, prec, draws["noise"]["coarse"], noise_std, masks)
    t_f = resample_along_rays(t, coarse["weights"], draws["u_fine"])
    fine = render_level(params["mlp"], mlp, rays, t_f, prec, draws["noise"]["fine"], noise_std, masks)
    return {"coarse": coarse, "fine": fine}


# --------------------------------------------------------------------------
# Losses, draws, the train steps


def losses(configs: dict, batch: dict, out: dict) -> dict:
    vals = {}
    for spec in configs["losses"]:
        name = spec["name"]
        if name == "MipNeRFMSE01":
            mse = {lv: ((out[lv]["rgb"] - batch["target_rgb"]) ** 2).mean() for lv in out}
            v = mse["fine"] + spec.get("coarse_weight", 0.1) * mse["coarse"]
        elif name == "OcclusionLoss01":
            r = spec.get("reg_range", 10)
            v = sum((out[lv]["density"][:, :r].sum(-1) / out[lv]["density"].shape[-1]).mean()
                    for lv in ("coarse", "fine"))
        else:
            raise ValueError(f"the FreeNeRF reference has no loss {name}")
        vals[name] = v
    return vals


def step_draws(seed: int, it: int, nr: int, ns: int, noise_std: float, device) -> dict:
    """A step's draws from a device generator seeded with seed * 2**32 + it,
    in the method's order: the coarse edges' uniforms, the coarse sigma
    noise, the fine stratified uniforms, the fine sigma noise."""
    g = torch.Generator(device=device).manual_seed(seed * 2**32 + it)
    draws = {"noise": {}}
    for level in ("coarse", "fine"):
        draws[f"u_{level}"] = torch.rand((nr, ns + 1), generator=g, device=device)
        draws["noise"][level] = (torch.randn((nr, ns), generator=g, device=device) if noise_std > 0
                                 else torch.zeros((nr, ns), device=device))
    return draws


def lr_at(opt: dict, step: int) -> float:
    """mip-NeRF's learning rate: log-linear from lr_initial to lr_final over
    max_steps, times lr_delay_mult + (1 - lr_delay_mult) sin(pi / 2 x
    clip(step / lr_delay_steps, 0, 1))."""
    delay = opt.get("lr_delay_steps", 0)
    mult = opt.get("lr_delay_mult", 1.0)
    rate = 1.0
    if delay > 0:
        rate = mult + (1 - mult) * math.sin(0.5 * math.pi * min(max(step / delay, 0.0), 1.0))
    t = min(max(step / opt["max_steps"], 0.0), 1.0)
    return rate * math.exp(math.log(opt["lr_initial"]) * (1 - t) + math.log(opt["lr_final"]) * t)


def train_steps(raw, configs, params0, seed, start_iter, n_steps, precision, device,
                skip: int = 0) -> dict:
    """`n_steps` FreeNeRF steps from `params0` and a fresh Adam state,
    numbered from `start_iter`, after the sampler has drawn `skip` batches:
    each step's total loss and its values, the first step's gradient per
    leaf, each leaf's change after the last step, and each step's
    per-interval densities by level (`density`, (rows, intervals)) and the
    mean square of each points-encoding channel, blocked order, rounded to
    the precision (`ipe`, (channels,)). Leaves keyed by tree path."""
    from benchmark.scene import tree_items, tree_map

    prec = base.Precision(precision)
    model = configs["model"]
    mlp = model["mlp"]
    scene = FreeScene(raw, configs, seed, device)
    scene.skip(skip)
    params = tree_map(lambda t: t.detach().clone().float().requires_grad_(), params0)
    leaves = tree_items(params)
    opt = configs["optimizer"]
    b1, b2 = opt.get("beta1", 0.9), opt.get("beta2", 0.999)
    mu = [torch.zeros_like(p) for _, p in leaves]
    nu = [torch.zeros_like(p) for _, p in leaves]
    noise_std = float(model.get("raw_noise_std", 0.0))
    lengths = (3 + 6 * mlp["points_positional_encoding_degree"],
               3 + 6 * mlp["views_positional_encoding_degree"])
    out = {"loss": [], "values": [], "grad": None, "density": [], "ipe": []}
    with base.exact_float32():
        for k in range(n_steps):
            it = start_iter + k
            batch = scene.next_batch()
            end = model.get("freq_reg_end")
            masks = [freq_reg_mask(n, it, end if end is not None else -1).to(device) for n in lengths]
            draws = step_draws(seed, it, batch["rays_o"].shape[0], mlp["num_samples"], noise_std,
                               device)
            outs = render(params, mlp, batch, prec, draws, noise_std, masks)
            vals = losses(configs, batch, outs)
            total = sum(float(s["weight"]) * vals[s["name"]] for s in configs["losses"])
            grads = torch.autograd.grad(total, [p for _, p in leaves], allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for (_, p), g in zip(leaves, grads)]
            if k == 0:
                out["grad"] = {path: g.detach().clone() for (path, _), g in zip(leaves, grads)}
            c = k + 1
            lr = lr_at(opt, k)
            bc1, bc2 = np.float32(1 - b1**c), np.float32(1 - b2**c)
            with torch.no_grad():
                for (_, p), g, m, v in zip(leaves, grads, mu, nu):
                    m.mul_(b1).add_((1 - b1) * g)
                    v.mul_(b2).add_((1 - b2) * g * g)
                    p.add_(-np.float32(lr) * ((m / bc1) / (torch.sqrt(v / bc2) + 1e-8)))
            out["loss"].append(float(total.detach()))
            out["values"].append({n: float(v.detach()) for n, v in vals.items()})
            out["density"].append({lv: outs[lv]["density"].detach().float().cpu()
                                   for lv in ("coarse", "fine")})
            out["ipe"].append({lv: outs[lv]["ipe"].float().cpu() for lv in ("coarse", "fine")})
    p0 = dict(tree_items(params0))
    out["delta"] = {path: (p.detach() - p0[path]) for path, p in leaves}
    return out
