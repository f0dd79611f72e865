"""Plain PyTorch reference of the ViP-NeRF LLFF train step.

Written from the published method (ViP-NeRF, Somraj & Soundararajan,
SIGGRAPH 2023: its ViPNeRF model, VisibilityLoss01 and
VisibilityPriorLoss01) and independent of the program: it imports nothing
of `simplenerf_torch` and takes nothing the program made. It reuses the
SimpleNeRF reference's scene normalisation, rays, sampler, draws,
compositing, product rounding and the two colour and sparse-depth losses
(`benchmark/reference.py`, by import). From the loader's output with the
visibility prior's masks (`raw["visibility_prior_data"]["masks"]`, (n, n-1,
h, w): column j of a frame is its j-th other train frame), the
configuration and the weights it works out the batch with each ray's prior
masks and its frame's other camera centres, both levels of the render
through the coarse and the fine MLP in the concat layout, each MLP's
views branch evaluated again at every sample for the k other cameras'
directions (one view at a time, so that the published widths fit), the
four losses (MSE01, SparseDepthMSE01, VisibilityLoss01,
VisibilityPriorLoss01), the gradients and Adam.

Departures from the published description, all of them the benchmark's
choices shared with the program under test:
- the secondary direction of sample i from camera j is normalise(p_i -
  o_j), p_i the sample's metric point o + t d with t from its NDC z as the
  method computes it (with its 1e-6 in 1 - z + 1e-6);
- every ray of the batch, NeRF and sparse-depth, is rendered at the
  secondary views; VisibilityPriorLoss01 reads only the NeRF rays;
- VisibilityLoss01 averages its per-ray sample means over every ray of the
  batch;
- products round their operands to the configuration's precision and
  accumulate in float32 (`reference.Precision`), TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import reference as base


class VipScene(base.TrainScene):
    """The train scene with each ray's prior masks and its frame's other
    camera centres (`rays_o2`), in the masks' column order."""

    def __init__(self, raw: dict, configs: dict, seed: int, device):
        super().__init__(raw, configs, seed, device)
        masks = np.asarray(raw["visibility_prior_data"]["masks"], np.float32)
        self.masks = torch.as_tensor(masks, device=device)  # (n, n-1, h, w)
        centres = self.poses[:, :3, 3]
        self.others = torch.stack([torch.cat([centres[:f], centres[f + 1 :]]) for f in range(self.n)])

    def batch(self, idx, mask_nerf) -> dict:
        b = super().batch(idx, mask_nerf)
        b["prior"] = self.masks[b["frame"], :, b["y"], b["x"]]  # (nr, n-1)
        b["rays_o2"] = self.others[b["frame"]]  # (nr, n-1, 3)
        return b


def views_out(p: dict, feature, dirs_pe, prec):
    """The views branch on [feature, dirs PE], its head's raw channels."""
    hv = torch.cat([feature, dirs_pe], -1)
    for layer in p["views"]:
        hv = torch.relu(base.dense(hv, layer, prec))
    return base.dense(hv, p["views_out"], prec)


def field(p: dict, mlp: dict, pts, dirs, dirs2, prec, noise=None):
    """sigma (n,), rgb (n, 3), visibility (n,) and secondary visibility
    (n, k) of one MLP with a visibility head, at flat points; dirs (n, 3)
    per point, dirs2 (n, k, 3) the secondary directions."""
    d = mlp["points_positional_encoding_degree"]
    dv = mlp["views_positional_encoding_degree"]
    enc = base.pe(pts, d)
    h = enc
    for i, layer in enumerate(p["pts"]):
        h = torch.relu(base.dense(h, layer, prec))
        if i == 4:
            h = torch.cat([enc, h], -1)
    po = base.dense(h, p["pts_out"], prec)
    raw = po[:, 0] if noise is None else po[:, 0] + noise
    feature = base.dense(h, p["feature"], prec)
    out = views_out(p, feature, base.pe(dirs, dv), prec)
    vis2 = torch.stack([torch.sigmoid(views_out(p, feature, base.pe(dirs2[:, j], dv), prec)[:, 3])
                        for j in range(dirs2.shape[1])], -1)
    return torch.relu(raw), torch.sigmoid(out[:, :3]), torch.sigmoid(out[:, 3]), vis2


def secondary_dirs(rays: dict, z):
    """(nr, ns, k, 3) unit directions from each other camera to each sample."""
    o, d, o2 = rays["rays_o"], rays["rays_d"], rays["rays_o2"]
    oz, dz = o[:, 2:3], d[:, 2:3]
    tn = -(1.0 + oz) / dz
    t = ((oz + tn * dz) / (1.0 - z + 1e-6) - oz) / dz
    pts = o[:, None] + t[..., None] * d[:, None]
    v = pts[:, :, None] - o2[:, None]
    return v / v.norm(dim=-1, keepdim=True)


def level(p: dict, mlp: dict, rays: dict, z, prec, noise):
    nr, ns = z.shape
    pts = (rays["rays_o_ndc"][:, None] + rays["rays_d_ndc"][:, None] * z[..., None]).reshape(-1, 3)
    dirs = rays["view_dirs"][:, None].expand(nr, ns, 3).reshape(-1, 3)
    dirs2 = secondary_dirs(rays, z)
    k = dirs2.shape[2]
    sigma, rgb, vis, vis2 = field(p, mlp, pts, dirs, dirs2.reshape(-1, k, 3), prec,
                                  None if noise is None else noise.reshape(-1))
    out = base.composite(sigma.view(nr, ns), rgb.view(nr, ns, 3), z, rays)
    alpha = 1.0 - torch.exp(-sigma.view(nr, ns) * (
        (torch.cat([z, torch.ones_like(z[:, :1])], -1)[:, 1:] - z) * rays["rays_d_ndc"].norm(dim=-1, keepdim=True)))
    out["transmittance"] = torch.cumprod(
        torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], -1), -1)[:, :-1]
    out["raw_visibility"] = vis.view(nr, ns)
    w = out["weights"]
    out["visibility2"] = (w[..., None] * vis2.view(nr, ns, k)).sum(1) / (out["acc"][:, None] + 1e-6)
    return out


def render(params, mlps, rays, prec, draws) -> dict:
    """Both levels in train mode: jittered coarse z, sigma noise, sampled fine z."""
    nr = rays["rays_o"].shape[0]
    ns_c, ns_f = mlps["coarse"]["num_samples"], mlps["fine"]["num_samples"]
    t = torch.linspace(0.0, 1.0, ns_c, device=rays["rays_o"].device)
    z = t.expand(nr, ns_c)
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], -1)
    lower = torch.cat([z[:, :1], mids], -1)
    z = lower + (upper - lower) * draws["u_coarse"]
    coarse = level(params["coarse"], mlps["coarse"], rays, z, prec, draws["noise"].get("coarse"))
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    z_s = base.sample_pdf(z_mid, coarse["weights"][:, 1:-1].detach(), draws["u_fine"]).detach()
    z_f = torch.sort(torch.cat([z, z_s], -1), -1).values
    fine = level(params["fine"], mlps["fine"], rays, z_f, prec, draws["noise"].get("fine"))
    return {"coarse": coarse, "fine": fine}


def losses(configs: dict, batch: dict, out: dict) -> dict:
    nm, tgt = batch["mask_nerf"], batch["target_rgb"]
    vals = {}
    for spec in configs["losses"]:
        name = spec["name"]
        if name == "MSE01":
            v = base._mse(out["coarse"]["rgb"], tgt, nm) + base._mse(out["fine"]["rgb"], tgt, nm)
        elif name == "SparseDepthMSE01":
            v = base._sd(out["fine"]["depth"], batch)
        elif name == "VisibilityLoss01":
            v = 0.0
            for lv in ("coarse", "fine"):
                pred, target = out[lv]["raw_visibility"], out[lv]["transmittance"]
                v = v + (pred - target.detach()).abs().mean(1).mean() + (pred.detach() - target).abs().mean(1).mean()
        elif name == "VisibilityPriorLoss01":
            v = 0.0
            m = nm.float()
            for lv in ("coarse", "fine"):
                per_ray = (batch["prior"] * (1.0 - out[lv]["visibility2"])).sum(-1)
                v = v + (per_ray * m).sum() / m.sum()
        else:
            raise ValueError(f"the ViP-NeRF reference has no loss {name}")
        vals[name] = v
    return vals


def train_steps(raw, configs, params0, seed, start_iter, n_steps, precision, device,
                skip: int = 0) -> dict:
    """`n_steps` ViP-NeRF steps from `params0` and a fresh Adam state,
    numbered from `start_iter`, after the sampler has drawn `skip` batches:
    as `reference.train_steps` (each step's total loss and its values, the
    first step's gradient per leaf, each leaf's change after the last), and
    each step's secondary visibility by level, (rows, k) (`vis2`)."""
    from benchmark.scene import model_mlps, tree_items, tree_map

    prec = base.Precision(precision)
    mlps = model_mlps(configs)
    scene = VipScene(raw, configs, seed, device)
    scene.skip(skip)
    params = tree_map(lambda t: t.detach().clone().float().requires_grad_(), params0)
    leaves = tree_items(params)
    opt = configs["optimizer"]
    b1, b2 = opt.get("beta1", 0.9), opt.get("beta2", 0.999)
    mu = [torch.zeros_like(p) for _, p in leaves]
    nu = [torch.zeros_like(p) for _, p in leaves]
    noise_std = float(configs["model"].get("raw_noise_std", 0.0))
    out = {"loss": [], "values": [], "grad": None, "vis2": []}
    with base.exact_float32():
        for k in range(n_steps):
            it = start_iter + k
            batch = scene.next_batch()
            draws = base.step_draws(seed, it, len(batch["mask_nerf"]), mlps, noise_std, device)
            outs = render(params, mlps, batch, prec, draws)
            vals = losses(configs, batch, outs)
            total = sum(base.loss_weight(s, it) * vals[s["name"]] for s in configs["losses"])
            grads = torch.autograd.grad(total, [p for _, p in leaves], allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for (_, p), g in zip(leaves, grads)]
            if k == 0:
                out["grad"] = {path: g.detach().clone() for (path, _), g in zip(leaves, grads)}
            c = k + 1
            lr = opt["lr_initial"] * 0.1 ** (k / (opt["lr_decay"] * 1000.0))
            bc1, bc2 = np.float32(1 - b1**c), np.float32(1 - b2**c)
            with torch.no_grad():
                for (_, p), g, m, v in zip(leaves, grads, mu, nu):
                    m.mul_(b1).add_((1 - b1) * g)
                    v.mul_(b2).add_((1 - b2) * g * g)
                    p.add_(-np.float32(lr) * ((m / bc1) / (torch.sqrt(v / bc2) + 1e-8)))
            out["loss"].append(float(total.detach()))
            out["values"].append({n: float(v.detach()) for n, v in vals.items()})
            out["vis2"].append({lv: outs[lv]["visibility2"].detach().float().cpu()
                                for lv in ("coarse", "fine")})
    p0 = dict(tree_items(params0))
    out["delta"] = {path: (p.detach() - p0[path]) for path, p in leaves}
    return out
