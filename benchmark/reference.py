"""Plain PyTorch reference of the SimpleNeRF LLFF train step and test render.

Written from the published method (SimpleNeRF's DataPreprocessor01,
SimpleNeRF01 and loss_functions) and independent of the program: it
imports nothing of `simplenerf_torch` and takes nothing the program made.
From the loader's output (scene.make_llff_scene), the configuration dict
and the weights it works out again the normalised poses, the rays and their
NDC form, the sparse-depth raster, the batch sampler's permutations, the
step's draws, both levels of the render through the four MLPs (concat
layout), the nine losses, the gradients and Adam.

`Precision` rounds the operands of every MLP product: "float32" (none,
TF32 off), "tf32", "bfloat16", or "fp8" (per-tensor scaled e4m3 forward,
e5m2 gradients). Products accumulate in float32 and their backward rounds
the incoming gradient as the forward rounds its operands, so a precision
stands for a whole kernel computed in it. The reference runs in the
configuration's `compute_dtype`; the control is the next precision below.
"tf32x3" multiplies as three TF32 products of each operand's big and small
TF32 halves, the scheme of the program's float32 kernels: a witness of
what that scheme alone does to a reading (calibrate.py --witness).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


# --------------------------------------------------------------------------
# Operand rounding


def _round_tf32(x):
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _round_fp8(x, fmt):
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = torch.finfo(fmt).max / amax
    return (x * scale).to(fmt).float() / scale


def _tf32_halves(x):
    big = _round_tf32(x)
    return big, _round_tf32(x - big)


class Precision:
    def __init__(self, name: str):
        if name not in ("float32", "tf32x3", "tf32", "bfloat16", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def fwd(self, x):
        if self.name == "float32":
            return x
        if self.name == "tf32":
            return _round_tf32(x)
        if self.name == "bfloat16":
            return x.to(torch.bfloat16).float()
        return _round_fp8(x, torch.float8_e4m3fn)

    def grad(self, g):
        if self.name == "fp8":
            return _round_fp8(g, torch.float8_e5m2)
        return self.fwd(g)

    def matmul(self, a, b):
        """a @ b of rounded operands; "tf32x3" as big * big + (big * small
        + small * big) of the operands' TF32 halves."""
        if self.name == "tf32x3":
            (ab, as_), (bb, bs) = _tf32_halves(a), _tf32_halves(b)
            return ab @ bb + (ab @ bs + as_ @ bb)
        return self.fwd(a) @ self.fwd(b)


class _LowMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, prec):
        ctx.save_for_backward(x, w)
        ctx.prec = prec
        return prec.matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        prec = ctx.prec
        if prec.name == "tf32x3":
            return prec.matmul(g, w.T), prec.matmul(x.T, g), None
        gr, xr, wr = prec.grad(g), prec.fwd(x), prec.fwd(w)
        return gr @ wr.T, xr.T @ gr, None


def mm(x, w, prec: Precision):
    return _LowMM.apply(x, w, prec)


@contextlib.contextmanager
def exact_float32():
    """Float32 products without TF32 for the reference's matmuls."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# --------------------------------------------------------------------------
# Scene normalisation (LLFF: bd_factor scale, recentring, OpenCV -> NeRF axes)

_FLIP = np.diag([1.0, -1.0, -1.0])


def _unit(v):
    return v / np.linalg.norm(v)


def _mean_pose_w2c(w2c):
    c2w = np.linalg.inv(w2c)
    centre = c2w[:, :3, 3].mean(0)
    fwd = _unit(c2w[:, :3, 2].sum(0))
    up = c2w[:, :3, 1].sum(0)
    right = _unit(np.cross(up, fwd))
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, _unit(np.cross(fwd, right)), fwd, centre
    return np.linalg.inv(m)


def _to_nerf(w2c, sc, avg_w2c):
    """Raw OpenCV w2c poses -> normalised NeRF-convention c2w (float64)."""
    p = np.array(w2c, np.float64)
    p[:, :3, 3] *= sc
    p = avg_w2c[None] @ np.linalg.inv(p)
    out = p.copy()
    out[:, :3, :3] = _FLIP.T @ p[:, :3, :3] @ _FLIP
    out[:, :3, 3] = p[:, :3, 3] * np.diag(_FLIP)[None]
    return out


def normalise_scene(raw: dict, bd_factor: float) -> dict:
    nerf = raw["nerf_data"]
    b = np.asarray(nerf["bounds"], np.float64)
    sc = 1.0 / (b[0] * bd_factor)
    w2c = np.array(nerf["extrinsics"], np.float64)
    w2c[:, :3, 3] *= sc
    avg = _mean_pose_w2c(w2c)
    poses = _to_nerf(nerf["extrinsics"], sc, avg)
    h, w = nerf["resolution"]
    return {
        "sc": sc, "avg": avg, "poses": poses.astype(np.float32),
        "K": np.asarray(nerf["intrinsics"], np.float32),
        "near": float(b[0] * sc * bd_factor), "far": float(b[1] * sc),
        "h": int(h), "w": int(w),
    }


def camera_rays(c2w, K, x, y):
    """World rays of pixels (x, y) (float32 tensors) of one camera."""
    dx = (x - K[0, 2]) / K[0, 0]
    dy = (y - K[1, 2]) / K[1, 1]
    d = torch.stack([dx, -dy, -torch.ones_like(dx)], -1) @ c2w[:3, :3].T
    return c2w[:3, 3].expand(d.shape), d


def ndc_rays(o, d, h, w, fx, fy, near):
    t = -(near + o[..., 2]) / d[..., 2]
    o = o + t[..., None] * d
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    ao, bo = -2.0 * fx / w, -2.0 * fy / h
    o_n = torch.stack([ao * ox / oz, bo * oy / oz, 1.0 + 2.0 * near / oz], -1)
    d_n = torch.stack([ao * (dx / dz - ox / oz), bo * (dy / dz - oy / oz), -2.0 * near / oz], -1)
    return o_n, d_n


def depth_from_ndc(z, o, d):
    oz, dz = o[..., 2:3], d[..., 2:3]
    tn = -(1.0 + oz) / dz
    guard = torch.where(z == 1.0, 1e-3, 0.0)
    return (oz + tn * dz) / dz * (1.0 / (1.0 - z + guard) - 1.0) + tn


# --------------------------------------------------------------------------
# The train scene: rays of any pixel, the sparse-depth raster, the sampler


class TrainScene:
    def __init__(self, raw: dict, configs: dict, seed: int, device):
        dl = configs["data_loader"]
        self.s = normalise_scene(raw, dl["bd_factor"])
        self.device = device
        self.n = len(raw["frame_nums"])
        h, w = self.s["h"], self.s["w"]
        t = lambda a: torch.as_tensor(np.asarray(a), device=device)  # noqa: E731
        self.images = t(raw["nerf_data"]["images"].astype(np.float32) / 255.0)
        self.poses = t(self.s["poses"])
        self.K = t(self.s["K"])
        depth = -np.ones((self.n, h, w), np.float32)
        for i, fn in enumerate(raw["frame_nums"]):
            fr = raw["sparse_depth_data"][int(fn)]
            xi = np.clip(np.round(np.asarray(fr["x"])), 0, w - 1).astype(int)
            yi = np.clip(np.round(np.asarray(fr["y"])), 0, h - 1).astype(int)
            depth[i, yi, xi] = np.asarray(fr["depth"]) * self.s["sc"]
        self.sparse = t(depth.reshape(-1))
        rng = np.random.default_rng(seed)
        self.pools = [np.arange(self.n * h * w), np.where(depth.reshape(-1) > 0)[0]]
        self.rng = rng
        self.perms = [rng.permutation(self.pools[0]), None]
        self.perms[1] = rng.permutation(self.pools[1])
        self.cursors = [0, 0]
        self.counts = (dl["num_rays"], dl["sparse_depth"]["num_rays"])

    def _next(self, k, count):
        out = []
        while count > 0:
            take = min(count, len(self.perms[k]) - self.cursors[k])
            out.append(self.perms[k][self.cursors[k] : self.cursors[k] + take])
            self.cursors[k] += take
            count -= take
            if self.cursors[k] >= len(self.perms[k]):
                self.perms[k] = self.rng.permutation(self.pools[k])
                self.cursors[k] = 0
        return np.concatenate(out)

    def skip(self, steps: int):
        """Draw `steps` batches' indices and drop them."""
        for _ in range(steps):
            self._next(0, self.counts[0])
            self._next(1, self.counts[1])

    def next_batch(self) -> dict:
        a = self._next(0, self.counts[0])
        b = self._next(1, self.counts[1])
        idx = torch.as_tensor(np.concatenate([a, b]), device=self.device)
        mask_nerf = torch.zeros(len(idx), dtype=torch.bool, device=self.device)
        mask_nerf[: len(a)] = True
        return self.batch(idx, mask_nerf)

    def batch(self, idx, mask_nerf) -> dict:
        h, w = self.s["h"], self.s["w"]
        frame, rem = idx // (h * w), idx % (h * w)
        y, x = rem // w, rem % w
        K = self.K[frame]
        xf, yf = x.float(), y.float()
        dx = (xf - K[:, 0, 2]) / K[:, 0, 0]
        dy = (yf - K[:, 1, 2]) / K[:, 1, 1]
        cam = torch.stack([dx, -dy, -torch.ones_like(dx)], -1)
        c2w = self.poses[frame]
        d = torch.einsum("nij,nj->ni", c2w[:, :3, :3], cam)
        o = c2w[:, :3, 3]
        o_n, d_n = ndc_rays(o, d, h, w, K[:, 0, 0], K[:, 1, 1], self.s["near"])
        return {
            "rays_o": o, "rays_d": d, "view_dirs": d / d.norm(dim=-1, keepdim=True),
            "rays_o_ndc": o_n, "rays_d_ndc": d_n,
            "target_rgb": self.images[frame, y, x], "frame": frame, "x": x, "y": y,
            "sparse_depth": self.sparse[idx], "mask_nerf": mask_nerf, "mask_sd": ~mask_nerf,
        }


# --------------------------------------------------------------------------
# Field


def pe(x, degree):
    feats = [x]
    for i in range(degree):
        feats += [torch.sin(x * 2.0**i), torch.cos(x * 2.0**i)]
    return torch.cat(feats, -1)


def dense(x, layer, prec):
    return mm(x, layer["w"], prec) + layer["b"]


def field(p: dict, mlp: dict, pts, dirs, prec, noise=None):
    """sigma (n,), rgb (n, 3) of one MLP at flat points; dirs per point."""
    d = mlp["points_positional_encoding_degree"]
    ds = mlp.get("points_sigma_positional_encoding_degree")
    enc = pe(pts, d)
    p_in = 3 + 6 * (d if ds is None else ds)
    lo, hi = enc[:, :p_in], enc[:, p_in:]
    h = lo
    for i, layer in enumerate(p["pts"]):
        h = torch.relu(dense(h, layer, prec))
        if i == 4:
            h = torch.cat([lo, h], -1)
    po = dense(h, p["pts_out"], prec)
    raw = po[:, 0]
    if noise is not None:
        raw = raw + noise
    sigma = torch.relu(raw)
    if not mlp["view_dependent_rgb"]:
        return sigma, torch.sigmoid(po[:, 1:4])
    parts = [dense(h, p["feature"], prec)]
    if hi.shape[1]:
        parts.append(hi)
    if mlp["use_view_dirs"]:
        parts.append(pe(dirs, mlp["views_positional_encoding_degree"]))
    hv = torch.cat(parts, -1)
    for layer in p["views"]:
        hv = torch.relu(dense(hv, layer, prec))
    return sigma, torch.sigmoid(dense(hv, p["views_out"], prec)[:, :3])


def composite(sigma, rgb, z, rays):
    """NDC compositing: sigma (nr, ns), rgb (nr, ns, 3), z (nr, ns)."""
    d_norm = rays["rays_d_ndc"].norm(dim=-1, keepdim=True)
    deltas = (torch.cat([z, torch.ones_like(z[:, :1])], -1)[:, 1:] - z) * d_norm
    alpha = 1.0 - torch.exp(-sigma * deltas)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], -1), -1)[:, :-1]
    wts = alpha * trans
    acc = wts.sum(-1)
    out = {"rgb": (wts[..., None] * rgb).sum(1), "acc": acc, "weights": wts}
    for key, zz in (("_ndc", z), ("", depth_from_ndc(z, rays["rays_o"], rays["rays_d"]))):
        dep = (wts * zz).sum(-1) / (acc + 1e-6)
        out["depth" + key] = dep
        out["depth_var" + key] = (wts * (zz - dep[:, None]) ** 2).sum(-1)
    return out


def sample_pdf(bins, weights, u):
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = (idx - 1).clamp(min=0)
    above = idx.clamp(max=cdf.shape[-1] - 1)
    cb, ca = cdf.gather(-1, below), cdf.gather(-1, above)
    bb, ba = bins.gather(-1, below), bins.gather(-1, above)
    den = ca - cb
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    return bb + (u - cb) / den * (ba - bb)


def _level(params, mlps, names, rays, z, prec, noises):
    nr, ns = z.shape
    pts = (rays["rays_o_ndc"][:, None] + rays["rays_d_ndc"][:, None] * z[..., None]).reshape(-1, 3)
    dirs = rays["view_dirs"][:, None].expand(nr, ns, 3).reshape(-1, 3)
    outs = {}
    for name in names:
        noise = noises.get(name)
        sigma, rgb = field(params[name], mlps[name], pts, dirs, prec,
                           None if noise is None else noise.reshape(-1))
        outs[name] = composite(sigma.view(nr, ns), rgb.view(nr, ns, 3), z, rays)
    return outs


COARSE_MEMBERS = (("coarse", ""), ("points_aug_coarse", "points_augmentation_"),
                  ("views_aug_coarse", "views_augmentation_"))


def render(params, mlps, rays, prec, train: bool, draws=None) -> dict:
    """Both levels; train: jittered coarse z, the trio, sigma noise and
    sampled fine z from `draws`; eval: linspace z and the main MLPs."""
    nr = rays["rays_o"].shape[0]
    ns_c, ns_f = mlps["coarse"]["num_samples"], mlps["fine"]["num_samples"]
    t = torch.linspace(0.0, 1.0, ns_c, device=rays["rays_o"].device)
    z = t.expand(nr, ns_c)
    if train:
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        upper = torch.cat([mids, z[:, -1:]], -1)
        lower = torch.cat([z[:, :1], mids], -1)
        z = lower + (upper - lower) * draws["u_coarse"]
    members = [n for n, _ in COARSE_MEMBERS if n in mlps] if train else ["coarse"]
    noises = draws["noise"] if train else {}
    coarse = _level(params, mlps, members, rays, z, prec, noises)
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    u = draws["u_fine"] if train else torch.linspace(0.0, 1.0, ns_f, device=z.device).expand(nr, ns_f)
    z_s = sample_pdf(z_mid, coarse["coarse"]["weights"][:, 1:-1].detach(), u).detach()
    z_f = torch.sort(torch.cat([z, z_s], -1), -1).values
    fine = _level(params, mlps, ["fine"], rays, z_f, prec, noises)["fine"]
    out = {f"{k}_fine": v for k, v in fine.items()}
    for name, prefix in COARSE_MEMBERS:
        if name in coarse:
            out.update({f"{prefix}{k}_coarse": v for k, v in coarse[name].items()})
    return out


# --------------------------------------------------------------------------
# The nine losses


def _mse(pred, target, mask):
    per = ((pred - target) ** 2).mean(-1)
    return (per * mask).sum() / mask.sum()


def _sd(pred, batch):
    m = batch["mask_sd"]
    return (((pred - batch["sparse_depth"]) ** 2) * m).sum() / m.sum()


def _patches(images, ids, x, y, half):
    n, h, w, _ = images.shape
    off = torch.arange(-half, half + 1, device=x.device)
    yy = (y[:, None] + off).clamp(0, h - 1)
    xx = (x[:, None] + off).clamp(0, w - 1)
    return images[ids[:, None, None], yy[:, :, None], xx[:, None, :]]


def arbitrated(d1, d2, batch, scene: TrainScene, patch: int, thr: float):
    """Reprojection-arbitrated depth consistency (loss_functions ...Loss02)."""
    half = patch // 2
    h, w = scene.s["h"], scene.s["w"]
    origins = scene.poses[:, :3, 3]
    dist = ((origins[:, None] - origins[None]) ** 2).sum(-1)
    closest = torch.argsort(dist, dim=1, stable=True)[:, 1]
    ids_a = batch["frame"]
    ids_b = closest[ids_a]
    pose_b = scene.poses[ids_b]
    K = scene.K[0]

    def reproject(depth):
        pts = batch["rays_o"] + batch["rays_d"] * depth.detach()[:, None]
        rel = pts - pose_b[:, :3, 3]
        cam = torch.einsum("nkj,nk->nj", pose_b[:, :3, :3], rel) * torch.tensor(
            [1.0, -1.0, -1.0], device=rel.device)
        uv = cam @ K.T
        pos = uv[:, :2] / uv[:, 2:]
        pos = torch.where(torch.isfinite(pos), pos, torch.full_like(pos, -1e9))
        pos = torch.round(pos).clamp(-2**30, 2**30).long()
        return pos[:, 0], pos[:, 1]

    def valid(x, y):
        return (x >= half) & (x < w - half) & (y >= half) & (y < h - half)

    x1, y1 = reproject(d1)
    x2, y2 = reproject(d2)
    xa, ya = batch["x"], batch["y"]
    pa = _patches(scene.images, ids_a, xa, ya, half)
    r1 = ((pa - _patches(scene.images, ids_b, x1, y1, half)) ** 2).mean((1, 2, 3)).sqrt()
    r2 = ((pa - _patches(scene.images, ids_b, x2, y2, half)) ** 2).mean((1, 2, 3)).sqrt()
    va, v1, v2 = valid(xa, ya), valid(x1, y1), valid(x2, y2)
    m1 = ((r1 < r2) | ~v2) & (r1 < thr) & v1 & va
    m2 = ((r2 < r1) | ~v1) & (r2 < thr) & v2 & va
    nm = batch["mask_nerf"]
    n = nm.sum()
    l1 = (((d1 - d2.detach()) ** 2) * (m2 & nm)).sum() / n
    l2 = (((d2 - d1.detach()) ** 2) * (m1 & nm)).sum() / n
    return l1 + l2


def losses(configs: dict, batch: dict, out: dict, scene: TrainScene) -> dict:
    nm, tgt = batch["mask_nerf"], batch["target_rgb"]
    vals = {}
    for spec in configs["losses"]:
        name = spec["name"]
        patch, thr = spec.get("patch_size", [5, 5])[0], spec.get("rmse_threshold", 0.1)
        if name == "MSE01":
            v = _mse(out["rgb_coarse"], tgt, nm) + _mse(out["rgb_fine"], tgt, nm)
        elif name == "MSE02":
            v = _mse(out["points_augmentation_rgb_coarse"], tgt, nm)
        elif name == "MSE03":
            v = _mse(out["views_augmentation_rgb_coarse"], tgt, nm)
        elif name == "SparseDepthMSE01":
            v = _sd(out["depth_fine"], batch)
        elif name == "SparseDepthMSE02":
            v = _sd(out["points_augmentation_depth_coarse"], batch)
        elif name == "SparseDepthMSE03":
            v = _sd(out["views_augmentation_depth_coarse"], batch)
        elif name == "PointsAugmentationDepthLoss02":
            v = arbitrated(out["depth_coarse"], out["points_augmentation_depth_coarse"], batch,
                           scene, patch, thr)
        elif name == "ViewsAugmentationDepthLoss02":
            v = arbitrated(out["depth_coarse"], out["views_augmentation_depth_coarse"], batch,
                           scene, patch, thr)
        elif name == "CoarseFineConsistencyLoss02":
            v = arbitrated(out["depth_coarse"], out["depth_fine"], batch, scene, patch, thr)
            v = v + _sd_teach(out["depth_coarse"], out["depth_fine"], batch)
        else:
            raise ValueError(f"the reference has no loss {name}")
        vals[name] = v
    return vals


def _sd_teach(dc, df, batch):
    m = batch["mask_sd"]
    return (((dc - df.detach()) ** 2) * m).sum() / m.sum()


def loss_weight(spec: dict, it: int) -> float:
    if "weight" in spec:
        return float(spec["weight"])
    w = None
    for k in sorted(spec["iter_weights"], key=int):
        if it >= int(k):
            w = spec["iter_weights"][k]
    return float(w)


# --------------------------------------------------------------------------
# Draws, the train steps, the test render


def step_draws(seed: int, it: int, nr: int, mlps: dict, noise_std: float, device) -> dict:
    """A step's jitter, importance uniforms and sigma noise, drawn from a
    device generator seeded with seed * 2**32 + it in the method's order:
    coarse jitter, each coarse member's noise, fine uniforms, fine noise."""
    g = torch.Generator(device=device).manual_seed(seed * 2**32 + it)
    ns_c, ns_f = mlps["coarse"]["num_samples"], mlps["fine"]["num_samples"]
    draws = {"u_coarse": torch.rand((nr, ns_c), generator=g, device=device), "noise": {}}
    for name, _ in COARSE_MEMBERS:
        if name in mlps and noise_std > 0:
            draws["noise"][name] = noise_std * torch.randn((nr, ns_c), generator=g, device=device)
    draws["u_fine"] = torch.rand((nr, ns_f), generator=g, device=device)
    if noise_std > 0:
        draws["noise"]["fine"] = noise_std * torch.randn((nr, ns_c + ns_f), generator=g, device=device)
    return draws


def train_steps(raw, configs, params0, seed, start_iter, n_steps, precision, device,
                skip: int = 0) -> dict:
    """`n_steps` steps from `params0` and a fresh Adam state, numbered from
    `start_iter`, after the sampler has drawn `skip` batches: each step's
    total loss and its nine values, the first step's gradient per leaf, and
    each leaf's change after the last step. Leaves are keyed by tree path."""
    from benchmark.scene import model_mlps, tree_items, tree_map

    prec = Precision(precision)
    mlps = model_mlps(configs)
    scene = TrainScene(raw, configs, seed, device)
    scene.skip(skip)
    params = tree_map(lambda t: t.detach().clone().float().requires_grad_(), params0)
    leaves = tree_items(params)
    opt = configs["optimizer"]
    b1, b2 = opt.get("beta1", 0.9), opt.get("beta2", 0.999)
    mu = [torch.zeros_like(p) for _, p in leaves]
    nu = [torch.zeros_like(p) for _, p in leaves]
    noise_std = float(configs["model"].get("raw_noise_std", 0.0))
    out = {"loss": [], "values": [], "grad": None}
    with exact_float32():
        for k in range(n_steps):
            it = start_iter + k
            batch = scene.next_batch()
            draws = step_draws(seed, it, len(batch["mask_nerf"]), mlps, noise_std, device)
            outs = render(params, mlps, batch, prec, True, draws)
            vals = losses(configs, batch, outs, scene)
            total = sum(loss_weight(s, it) * vals[s["name"]] for s in configs["losses"])
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
    p0 = dict(tree_items(params0))
    out["delta"] = {path: (p.detach() - p0[path]) for path, p in leaves}
    return out


def test_rays(raw, configs, pose_w2c, device) -> dict:
    """The test rays of a raw world-to-camera pose: normalised by the train
    scene's scale and mean pose, the mean intrinsics, NDC at the near plane."""
    s = normalise_scene(raw, configs["data_loader"]["bd_factor"])
    c2w = _to_nerf(np.asarray(pose_w2c)[None], s["sc"], s["avg"])[0].astype(np.float32)
    K = s["K"].mean(0)
    h, w = s["h"], s["w"]
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    Kt, c2wt = torch.as_tensor(K, device=device), torch.as_tensor(c2w, device=device)
    o, d = camera_rays(c2wt, Kt, xs.reshape(-1), ys.reshape(-1))
    o_n, d_n = ndc_rays(o, d, h, w, Kt[0, 0], Kt[1, 1], s["near"])
    return {"rays_o": o.contiguous(), "rays_d": d, "view_dirs": d / d.norm(dim=-1, keepdim=True),
            "rays_o_ndc": o_n, "rays_d_ndc": d_n, "hw": (h, w)}


@torch.no_grad()
def render_frame(raw, configs, params, pose_w2c, precision, device, pixels=None, chunk=32768) -> dict:
    """A test frame's outputs as the serving path hands them back (fine
    level): the uint8 image and the clipped depths and variances, flat over
    the frame's pixels in raster order, or over `pixels` (flat indices)."""
    from benchmark.scene import model_mlps

    prec = Precision(precision)
    mlps = model_mlps(configs)
    rays = test_rays(raw, configs, pose_w2c, device)
    rays.pop("hw")
    if pixels is not None:
        idx = torch.as_tensor(np.asarray(pixels), device=device)
        rays = {k: v[idx] for k, v in rays.items()}
    nr = rays["rays_o"].shape[0]
    parts: dict = {}
    with exact_float32():
        for s in range(0, nr, chunk):
            sub = {k: v[s : s + chunk] for k, v in rays.items()}
            o = render(params, mlps, sub, prec, False)
            for k in ("rgb_fine", "depth_fine", "depth_var_fine", "depth_ndc_fine", "depth_var_ndc_fine",
                      "acc_fine"):
                parts.setdefault(k, []).append(o[k].float().cpu())
    cat = {k: torch.cat(v).numpy() for k, v in parts.items()}
    return {
        "image": np.clip(np.round(np.clip(cat["rgb_fine"], 0, 1) * 255), 0, 255).astype(np.uint8),
        "depth": np.clip(cat["depth_fine"], 0, np.inf),
        "depth_var": np.clip(cat["depth_var_fine"], 0, np.inf),
        "depth_ndc": np.clip(cat["depth_ndc_fine"], 0, np.inf),
        "depth_var_ndc": np.clip(cat["depth_var_ndc_fine"], 0, np.inf),
        "acc": cat["acc_fine"],
    }


def leaf_gap(got: dict, want: dict, keep=None) -> tuple:
    """Per leaf, | |got| - |want| | / max(|want leaf|, median |want|); the
    worst leaf's gap and path, and the median leaf's gap. `keep` filters
    the leaves compared."""
    norms = {k: float(v.float().norm()) for k, v in want.items()}
    med = float(np.median(list(norms.values())))
    gaps = {k: abs(float(got[k].float().norm()) - n) / max(n, med, 1e-30)
            for k, n in norms.items() if keep is None or keep(k)}
    worst = max(gaps, key=lambda k: gaps[k] if math.isfinite(gaps[k]) else math.inf)
    return gaps[worst], worst, float(np.median(list(gaps.values())))
