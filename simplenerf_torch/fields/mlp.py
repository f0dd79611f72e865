"""NeRF field MLP as plain functions over nested dicts of tensors.

Architecture of the reference MLP: a points net of depth Dp / width Wp
with a skip join re-injecting the encoded points after layer 4; heads for
sigma (+ optional pre-ReLU Gaussian noise), view-independent RGB, or a
views branch (depth Dv / width Wv) on [feature, encoded view dirs] for
view-dependent RGB and an optional visibility head. With
`points_sigma_pe_degree` set, the points net sees only the low-frequency
prefix of the encoding and the rest is routed into the views branch.

Three evaluations of the same function:
- `apply_reference`: the concat-based transcription of the reference;
- `apply`: the "blocked" form (skip and views joins as sums of matmuls over
  row slices of the canonical weights, view dirs encoded once per ray);
- `apply_fused`: the field through `ops.fused_mlp.fused_apply`, which
  launches the CUDA kernels (forward, and backward under autograd) for
  CUDA tensors. It returns the plane layout of `to_planes`;
  `apply_fused_ensemble` evaluates several MLPs at the same points through
  `fused_apply_ensemble`, one plane dict per member.

`dtype` is the matmul input precision (bfloat16 or float32); products
accumulate in float32 and trunk activations are stored at `dtype`.
Parameters keep the canonical reference channel layout: weights are
(fan_in, fan_out), biases (fan_out,).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from simplenerf_torch.fields import encoding
from simplenerf_torch.utils import profiling

Params = Any  # nested dict of tensors


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    """Static architecture config for one NeRF field MLP."""

    points_net_depth: int = 8
    views_net_depth: int = 1
    points_net_width: int = 256
    views_net_width: int = 128
    points_pe_degree: int = 10
    views_pe_degree: int = 4
    # Reduced-degree PE for the sigma/points net (points-augmentation trick).
    points_sigma_pe_degree: Optional[int] = None
    use_view_dirs: bool = True
    view_dependent_rgb: bool = True
    predict_visibility: bool = False
    num_samples: int = 64
    skip_layers: tuple[int, ...] = (4,)

    @property
    def full_points_dim(self) -> int:
        return encoding.out_dim(self.points_pe_degree)

    @property
    def sigma_pe_degree(self) -> int:
        return (
            self.points_sigma_pe_degree
            if self.points_sigma_pe_degree is not None
            else self.points_pe_degree
        )

    @property
    def points_input_dim(self) -> int:
        return encoding.out_dim(self.sigma_pe_degree)

    @property
    def extra_views_dim(self) -> int:
        return self.full_points_dim - self.points_input_dim

    @property
    def views_input_dim(self) -> int:
        dim = encoding.out_dim(self.views_pe_degree) if self.use_view_dirs else 0
        return dim + self.extra_views_dim

    @property
    def view_dep_outputs(self) -> bool:
        return self.view_dependent_rgb or self.predict_visibility

    @property
    def points_output_dim(self) -> int:
        return 1 + (0 if self.view_dependent_rgb else 3)

    @property
    def views_output_dim(self) -> int:
        return (3 if self.view_dependent_rgb else 0) + (1 if self.predict_visibility else 0)


def _init_dense(generator: torch.Generator, fan_in: int, fan_out: int, device) -> dict:
    """U(-1/sqrt(fan_in), +1/sqrt(fan_in)) for weight and bias (torch.nn.Linear's law)."""
    bound = 1.0 / math.sqrt(fan_in)

    def uniform(shape):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return ((2.0 * u - 1.0) * bound).to(device)

    return {"w": uniform((fan_in, fan_out)), "b": uniform((fan_out,))}


def init(generator: torch.Generator, cfg: MLPConfig, device="cpu") -> Params:
    """Parameter tree for one field MLP, drawn from a CPU `torch.Generator`."""
    params: dict = {}
    pts_layers = []
    in_dim = cfg.points_input_dim
    for i in range(cfg.points_net_depth):
        pts_layers.append(_init_dense(generator, in_dim, cfg.points_net_width, device))
        # Layer i+1 sees [encoded_pts, h] when layer i is a skip layer.
        in_dim = cfg.points_net_width + (cfg.points_input_dim if i in cfg.skip_layers else 0)
    params["pts"] = pts_layers
    params["pts_out"] = _init_dense(generator, cfg.points_net_width, cfg.points_output_dim, device)

    if cfg.view_dep_outputs:
        params["feature"] = _init_dense(
            generator, cfg.points_net_width, cfg.points_net_width, device
        )
        views_layers = []
        in_dim = cfg.views_input_dim + cfg.points_net_width
        for _ in range(cfg.views_net_depth):
            views_layers.append(_init_dense(generator, in_dim, cfg.views_net_width, device))
            in_dim = cfg.views_net_width
        params["views"] = views_layers
        params["views_out"] = _init_dense(
            generator, cfg.views_net_width, cfg.views_output_dim, device
        )
    return params


def _mm(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """Matmul with inputs rounded to `dtype` and float32 accumulation.

    A product of two bfloat16 values is exact in float32, so upcasting the
    rounded inputs and multiplying in float32 is the bf16-in/f32-accumulate
    product.
    """
    return x.to(dtype).float() @ w.to(dtype).float()


def _dense(x: torch.Tensor, p: dict, dtype) -> torch.Tensor:
    return _mm(x, p["w"], dtype) + p["b"]


def _extra_rows_perm(cfg: MLPConfig) -> list[int]:
    """Blocked order of the high-frequency channels within the reference's
    enc_pts[:, P:] row segment of the first views-branch weight."""
    ds, d = cfg.sigma_pe_degree, cfg.points_pe_degree
    p = cfg.points_input_dim
    rows = [3 + 6 * i + j - p for i in range(ds, d) for j in range(3)]  # sin
    rows += [3 + 6 * i + 3 + j - p for i in range(ds, d) for j in range(3)]  # cos
    return rows


def _noisy_relu_sigma(sigma, noise_std: float, noise: Optional[torch.Tensor]):
    """Noise is added to raw sigma before the ReLU; `noise` holds the
    standard-normal draws (shaped like sigma)."""
    if noise_std > 0.0 and noise is not None:
        sigma = sigma + noise_std * noise.reshape(sigma.shape)
    return torch.relu(sigma)


def _finalize_heads(cfg, pts_out, h, params, enc_extra, enc_views, dtype,
                    noise_std, noise, view_dirs_tile, out):
    out["sigma"] = _noisy_relu_sigma(pts_out[..., :1], noise_std, noise)

    if not cfg.view_dependent_rgb:
        rgb = torch.sigmoid(pts_out[..., 1:4])
        out["rgb_view_independent"] = rgb
        out["rgb"] = rgb

    if cfg.view_dep_outputs:
        wp = cfg.points_net_width
        e = cfg.extra_views_dim
        wv0 = params["views"][0]
        # Views join as a sum of matmuls over canonical row slices: feature
        # rows, high-frequency rows (re-permuted to blocked order), dir rows.
        hv = _mm(_dense(h, params["feature"], dtype), wv0["w"][:wp], dtype)
        if e:
            hv = hv + _mm(enc_extra, encoding.take_rows(wv0["w"][wp : wp + e], _extra_rows_perm(cfg)),
                          dtype)
        if cfg.use_view_dirs:
            perm = encoding.blocked_to_reference_perm(cfg.views_pe_degree)
            contrib = _mm(enc_views, encoding.take_rows(wv0["w"][wp + e :], perm), dtype)
            if view_dirs_tile > 1:
                contrib = contrib.repeat_interleave(view_dirs_tile, dim=0)
            hv = hv + contrib
        hv = torch.relu(hv + wv0["b"]).to(dtype)
        for layer in params["views"][1:]:
            hv = torch.relu(_dense(hv, layer, dtype)).to(dtype)
        views_out = _dense(hv, params["views_out"], dtype)
        if cfg.view_dependent_rgb:
            rgb = torch.sigmoid(views_out[..., :3])
            out["rgb_view_dependent"] = rgb
            out["rgb"] = rgb
        if cfg.predict_visibility:
            ch = 3 if cfg.view_dependent_rgb else 0
            out["visibility"] = torch.sigmoid(views_out[..., ch : ch + 1])
    return out


def apply(
    params: Params,
    cfg: MLPConfig,
    pts: torch.Tensor,
    view_dirs: Optional[torch.Tensor] = None,
    view_dirs2: Optional[torch.Tensor] = None,
    noise_std: float = 0.0,
    noise: Optional[torch.Tensor] = None,
    dtype=torch.float32,
    view_dirs_tile: int = 1,
) -> dict:
    """Evaluate the field at flat points (blocked form).

    pts: (n, 3); view_dirs: (n, 3), or (n / view_dirs_tile, 3) when
    view_dirs_tile > 1 (one direction per ray, tiled across samples).
    Secondary-view visibility (view_dirs2) routes through apply_reference.
    Returns 'sigma' (n, 1), 'rgb' (n, 3) and the reference output keys.
    """
    if view_dirs2 is not None:
        return apply_reference(
            params, cfg, pts, view_dirs=view_dirs, view_dirs2=view_dirs2,
            noise_std=noise_std, noise=noise, dtype=dtype,
        )

    ds, d = cfg.sigma_pe_degree, cfg.points_pe_degree
    x, s, c = encoding.encode_parts(pts, d)
    x = x.to(dtype)
    if d == 0:
        pts_in = x
    else:
        s, c = s.to(dtype), c.to(dtype)
        # Blocked low-frequency input [x | sin f<ds | cos f<ds].
        pts_in = torch.cat([x, s[..., : 3 * ds], c[..., : 3 * ds]], dim=-1)
    enc_extra = (
        torch.cat([s[..., 3 * ds :], c[..., 3 * ds :]], dim=-1) if cfg.extra_views_dim else None
    )

    w0_perm = encoding.blocked_to_reference_perm(ds)
    layer0 = params["pts"][0]
    h = _mm(pts_in, encoding.take_rows(layer0["w"], w0_perm), dtype)
    h = torch.relu(h + layer0["b"]).to(dtype)
    for i, layer in enumerate(params["pts"][1:], start=1):
        if (i - 1) in cfg.skip_layers:
            # Skip join as a matmul sum: encoded-points rows + hidden rows.
            p = cfg.points_input_dim
            pre = (
                _mm(pts_in, encoding.take_rows(layer["w"][:p], w0_perm), dtype)
                + _mm(h, layer["w"][p:], dtype)
                + layer["b"]
            )
        else:
            pre = _dense(h, layer, dtype)
        h = torch.relu(pre).to(dtype)

    pts_out = _dense(h, params["pts_out"], dtype)

    enc_views = None
    if cfg.use_view_dirs and cfg.view_dep_outputs:
        xv, sv, cv = encoding.encode_parts(view_dirs, cfg.views_pe_degree)
        enc_views = _cat_parts(xv, sv, cv).to(dtype)

    return _finalize_heads(
        cfg, pts_out, h, params, enc_extra, enc_views, dtype,
        noise_std, noise, view_dirs_tile, {},
    )


def _cat_parts(x, s, c):
    return x if s is None else torch.cat([x, s, c], dim=-1)


def to_planes(out: dict, nr: int, ns: int) -> dict:
    """Flat (n, ch) MLP outputs -> plane layout.

    {"sigma": (nr, ns), "rgb": (3, nr, ns), "visibility": (nr, ns),
     "visibility2": (nr, ns, k)}: the layout `render.volume` composites.
    """
    planes = {"sigma": out["sigma"].reshape(nr, ns)}
    if "rgb" in out:
        planes["rgb"] = out["rgb"].reshape(nr, ns, 3).permute(2, 0, 1)
    if "visibility" in out:
        planes["visibility"] = out["visibility"].reshape(nr, ns)
    if "visibility2" in out:
        k = out["visibility2"].shape[-2]
        planes["visibility2"] = out["visibility2"].reshape(nr, ns, k)
    return planes


def apply_fused(
    params: Params,
    cfg: MLPConfig,
    pts: torch.Tensor,
    view_dirs: Optional[torch.Tensor] = None,
    noise_std: float = 0.0,
    noise: Optional[torch.Tensor] = None,
    dtype=torch.float32,
    view_dirs_tile: int = 1,
) -> dict:
    """Evaluate the field through `ops.fused_mlp.fused_apply`.

    Same function as `to_planes(apply(...))` (minus view_dirs2): pts (n, 3)
    grouped as nr = n / view_dirs_tile rays x ns = view_dirs_tile samples;
    view_dirs (nr, 3). The kernel emits raw linear head planes; noise and
    activations are applied here on (nr, ns) planes. Sigma noise is the
    standard-normal `noise` (nr, ns). The kernel masks its ragged last
    block itself, so nothing is padded. Differentiable in `params`.
    """
    from simplenerf_torch.ops import fused_mlp

    n = pts.shape[0]
    ns = view_dirs_tile
    if n % ns:
        raise ValueError(f"{n} points do not split into rays of {ns} samples")
    with profiling.span("field.encode", device=pts.device):
        operands = fused_operands(params, cfg, pts, view_dirs, ns, dtype)
    planes = fused_mlp.fused_apply(*operands)
    return _fused_epilogue(cfg, operands[0].out_p, planes, noise_std, noise)


def fused_operands(params: Params, cfg: MLPConfig, pts, view_dirs, ns: int, dtype) -> tuple:
    """Arguments of `ops.fused_mlp.fused_apply`: (spec, kernel params, lo, hi, hvx).

    pts (n, 3), view_dirs (n // ns, 3) or None; `hvx` is the per-ray dirs
    contribution to the first views layer (None without view dirs).
    """
    from simplenerf_torch.ops import fused_mlp

    spec = fused_mlp.make_spec(cfg, ns, dtype)
    hvx = _hvx(params, cfg, view_dirs, dtype) if spec.has_hvx else None
    lo, hi = fused_mlp.pe_operands(pts, cfg.points_pe_degree, cfg.sigma_pe_degree, spec.cdtype)
    return spec, fused_mlp.kernel_params(params, cfg), lo, hi, hvx


def _hvx(params: Params, cfg: MLPConfig, view_dirs, dtype) -> torch.Tensor:
    """Per-ray dirs contribution to the first views layer, (nr, Wv) f32."""
    from simplenerf_torch.ops import fused_mlp

    xv, sv, cv = encoding.encode_parts(view_dirs, cfg.views_pe_degree)
    return _mm(_cat_parts(xv, sv, cv), fused_mlp.dirs_w(params, cfg), dtype).contiguous()


def ensemble_operands(members: list, pts, view_dirs, ns: int, dtype) -> tuple:
    """Arguments of `ops.fused_mlp.fused_apply_ensemble`: (ens, kps, lo, hvxs).

    members: (params, cfg) pairs. One shared full-degree lo block
    [x | sin f<D | cos f<D] (D the largest member degree) serves every
    member; the members' joins are zero-row padded to it.
    """
    from simplenerf_torch.ops import fused_mlp

    ens = fused_mlp.make_ensemble_spec([cfg for _, cfg in members], ns, dtype)
    d_max = max(cfg.points_pe_degree for _, cfg in members)
    kps = tuple(fused_mlp.kernel_params(p, c, shared_degree=d_max) for p, c in members)
    hvxs = tuple(
        _hvx(p, c, view_dirs, dtype) for (p, c), m in zip(members, ens.members) if m.has_hvx
    )
    lo, _ = fused_mlp.pe_operands(pts, d_max, d_max, ens.cdtype)
    return ens, kps, lo, hvxs


def apply_fused_ensemble(
    members: list,
    pts: torch.Tensor,
    view_dirs: Optional[torch.Tensor] = None,
    noise_std: float = 0.0,
    noises: Optional[list] = None,
    dtype=torch.float32,
    view_dirs_tile: int = 1,
) -> list:
    """Evaluate several field MLPs at the same points in one fused kernel.

    members: (params, cfg) pairs; pts (n, 3) grouped as nr = n / ns rays x
    ns = view_dirs_tile samples; view_dirs (nr, 3) shared; noises: per-member
    standard-normal sigma noise (nr, ns) or None. Returns one plane-layout
    output dict per member, the same as `apply_fused` on each member.
    """
    from simplenerf_torch.ops import fused_mlp

    ns = view_dirs_tile
    if pts.shape[0] % ns:
        raise ValueError(f"{pts.shape[0]} points do not split into rays of {ns} samples")
    noises = noises if noises is not None else [None] * len(members)
    with profiling.span("field.encode", device=pts.device):
        ens, kps, lo, hvxs = ensemble_operands(members, pts, view_dirs, ns, dtype)
    planes = fused_mlp.fused_apply_ensemble(ens, kps, lo, hvxs)
    outs, pos = [], 0
    for (_, cfg), m, noise in zip(members, ens.members, noises):
        outs.append(_fused_epilogue(cfg, m.out_p, planes[pos : pos + m.n_planes], noise_std, noise))
        pos += m.n_planes
    return outs


def _fused_epilogue(cfg: MLPConfig, out_p: int, planes, noise_std, noise) -> dict:
    """Raw linear head planes -> activated plane-layout outputs."""
    out: dict = {"sigma": _noisy_relu_sigma(planes[0], noise_std, noise)}
    if not cfg.view_dependent_rgb:
        out["rgb"] = torch.sigmoid(torch.stack(planes[1:4], dim=0))
    if cfg.view_dep_outputs:
        vp = planes[out_p:]
        if cfg.view_dependent_rgb:
            out["rgb"] = torch.sigmoid(torch.stack(vp[:3], dim=0))
        if cfg.predict_visibility:
            ch = 3 if cfg.view_dependent_rgb else 0
            out["visibility"] = torch.sigmoid(vp[ch])
    return out


def apply_reference(
    params: Params,
    cfg: MLPConfig,
    pts: torch.Tensor,
    view_dirs: Optional[torch.Tensor] = None,
    view_dirs2: Optional[torch.Tensor] = None,
    noise_std: float = 0.0,
    noise: Optional[torch.Tensor] = None,
    dtype=torch.float32,
) -> dict:
    """Direct transcription of the reference forward (concat-based layout).

    Used by the visibility2 path and as the oracle for `apply`.
    view_dirs: (n, 3); view_dirs2: (n, k, 3).
    """
    enc_pts = encoding.encode(pts, cfg.points_pe_degree)
    pts_in = enc_pts[..., : cfg.points_input_dim]

    h = pts_in.to(dtype)
    for i, layer in enumerate(params["pts"]):
        h = torch.relu(_dense(h, layer, dtype)).to(dtype)
        if i in cfg.skip_layers:
            h = torch.cat([pts_in.to(dtype), h], dim=-1)

    pts_out = _dense(h, params["pts_out"], dtype)
    out = {"sigma": _noisy_relu_sigma(pts_out[..., :1], noise_std, noise)}

    if not cfg.view_dependent_rgb:
        rgb = torch.sigmoid(pts_out[..., 1:4])
        out["rgb_view_independent"] = rgb
        out["rgb"] = rgb

    if cfg.view_dep_outputs:
        feature = _dense(h, params["feature"], dtype).to(dtype)
        # High-frequency PE channels excluded from the points net feed the
        # views branch instead (points-augmentation routing).
        feature = torch.cat([feature, enc_pts[..., cfg.points_input_dim :].to(dtype)], dim=-1)

        def views_branch(dirs_enc, feat):
            hv = feat if dirs_enc is None else torch.cat([feat, dirs_enc.to(dtype)], dim=-1)
            for layer in params["views"]:
                hv = torch.relu(_dense(hv, layer, dtype)).to(dtype)
            return _dense(hv, params["views_out"], dtype)

        enc_views = (
            encoding.encode(view_dirs, cfg.views_pe_degree) if cfg.use_view_dirs else None
        )
        views_out = views_branch(enc_views, feature)
        ch = 0
        if cfg.view_dependent_rgb:
            rgb = torch.sigmoid(views_out[..., ch : ch + 3])
            out["rgb_view_dependent"] = rgb
            out["rgb"] = rgb
            ch += 3
        if cfg.predict_visibility:
            out["visibility"] = torch.sigmoid(views_out[..., ch : ch + 1])

        if cfg.predict_visibility and view_dirs2 is not None:
            k = view_dirs2.shape[-2]
            enc_views2 = encoding.encode(view_dirs2, cfg.views_pe_degree)
            feat2 = feature[..., None, :].expand(*feature.shape[:-1], k, feature.shape[-1])
            views_out2 = views_branch(enc_views2, feat2)
            ch2 = 3 if cfg.view_dependent_rgb else 0
            out["visibility2"] = torch.sigmoid(views_out2[..., ch2 : ch2 + 1])
    return out
