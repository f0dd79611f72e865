"""Fused NeRF field MLP: CUDA kernels for Hopper + their plain versions.

Replaces the four TPU kernels of simplenerf_tpu/ops/fused_mlp.py:

- `_fwd_kernel` (behind `fused_apply`): one field MLP's forward over
  N = nr * ns points: the trunk of `depth` layers with row-merged skip
  joins, the points head, and the optional views branch (feature layer,
  first views layer on feature + `hi` + per-ray `hvx`, more views layers,
  views head). It emits the raw linear head channels as (nr, ns) float32
  planes; noise, ReLU and sigmoids are the caller's epilogue
  (`fields.mlp._fused_epilogue`). CUDA: csrc/fused_mlp_fwd.cu.
- `_bwd_kernel`: its recompute VJP, every kernel parameter's gradient in
  float32 and the per-ray hvx cotangent. CUDA: csrc/fused_mlp_bwd.cu.
- `_ens_fwd_kernel` / `_ens_bwd_kernel` (behind `fused_apply_ensemble`):
  the same for several MLPs at the same points, reading one shared
  full-degree lo block (the coarse trio of training). CUDA: the same two
  sources with a longer program.

What bounds them on an H100: arithmetic. The published 8x256 main MLP does
2 * 589,952 FLOP per point forward against ~142 bytes of device-memory
traffic per point in bf16, far above the ~295 FLOP/byte at which the
H100's published bf16 peak and memory rate balance (SXM data sheet,
700 W). The forward keeps every activation on chip: a block owns 128 rows,
holds its lo/hi inputs and one activation tile in shared memory, and walks
a program of layers (`pack_program`) with each layer's transposed weight
streaming through a ring in shared memory that every block reads from L2.
The weights are packed as the ring's shared-memory image, copied by one
producer thread with bulk copies, and two consumer warpgroups multiply
with wgmma and fold the heads into their epilogues: bf16 in 64-deep
swizzled slabs (csrc/fused_mlp_sm90.cuh); float32 on the same engine in
3xTF32 (csrc/fused_mlp_tf32_sm90.cuh: 64-row x 32-deep chunks in a
permuted K order, each split on the card into its big and small TF32
images by `tf32_split`, three TF32 products per product). The backward
(`pack_bwd_program`) runs the forward program again, stashes the rounded
activations and cotangents in device memory, and computes dW in a second
pass over the stash; sums over rows are fixed-order reductions, so
gradients do not change from run to run. Its row pass runs the forward's
engine forward and back, with an image of every backward product's weight
beside the forward's (`bwd90_plan`): bf16 with the stash leaving by TMA
stores (csrc/fused_mlp_bwd_sm90.cuh), float32 on the 3xTF32 core with the
stash stored from registers (csrc/fused_mlp_bwd_tf32_sm90.cuh). The bf16
weight pass is bound by the stash bytes it reads, and reads whole dW
panels through TMA boxes into wgmma, the two panels of a dW in one
cluster (`_wgrad_plan`, csrc/fused_mlp_wgrad_sm90.cuh); the float32 one
runs 128 x 128 tiles of plain FMAs.

Each wrapper takes the plain version for CPU tensors and launches its
kernel (or raises) for CUDA tensors, and counts its launches:
`fused_apply.launches`, `fused_bwd.launches`,
`fused_apply_ensemble.launches`, `fused_ens_bwd.launches` (and, for the
weight pass and the column sums alone, `wgrad.launches` and
`column_sums.launches`, and `tf32_split.launches`, the float32 weight
images' split, which every float32 launch makes; all of them:
`launch_counts`). Under autograd
`fused_apply` and `fused_apply_ensemble` differentiate through the
backward wrappers; the points carry no gradient.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from simplenerf_torch.fields import encoding


@dataclasses.dataclass(frozen=True)
class FusedSpec:
    """Static shape/architecture info of one fused MLP evaluation."""

    depth: int
    width: int
    views_depth: int  # 0 = no views branch
    views_width: int
    pe_degree: int  # full points PE degree d
    sigma_pe_degree: int  # ds <= d; trunk sees frequencies < ds
    skip_layers: tuple[int, ...]
    out_p: int  # points-head output channels (1 or 4)
    out_v: int  # views-head output channels (0, 3 or 4)
    has_extra: bool  # high-freq channels routed to views branch (ds < d)
    has_hvx: bool  # per-ray hv_extra input present (use_view_dirs)
    ns: int  # samples per ray = plane width; 1 = per-point
    dtype: str  # matmul input precision: "float32" | "bfloat16" (| "float64": plain versions only)
    # Ensemble mode: every member reads ONE shared full-degree lo block
    # [x | sin f<D | cos f<D]; its joins carry zero rows for the frequencies
    # outside its own window (`kernel_params(shared_degree=D)`).
    shared_pe_degree: Optional[int] = None

    @property
    def cdtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float64": torch.float64}.get(self.dtype, torch.float32)

    @property
    def acc_dtype(self) -> torch.dtype:
        """The plain versions' accumulation type: float64 for a "float64"
        spec (the float32 kernels' yardstick), else float32."""
        return torch.float64 if self.dtype == "float64" else torch.float32

    @property
    def has_views(self) -> bool:
        return self.views_depth > 0 or self.out_v > 0

    @property
    def in_lo(self) -> int:
        """Trunk input channels: [x | sin f<ds | cos f<ds] (or the shared full block)."""
        d = self.shared_pe_degree if self.shared_pe_degree is not None else self.sigma_pe_degree
        return 3 + 6 * d

    @property
    def in_hi(self) -> int:
        """Views-branch extra channels: [sin f>=ds | cos f>=ds] (or the shared full block)."""
        if not self.has_extra:
            return 0
        if self.shared_pe_degree is not None:
            return 3 + 6 * self.shared_pe_degree
        return 6 * (self.pe_degree - self.sigma_pe_degree)

    @property
    def n_planes(self) -> int:
        return self.out_p + self.out_v

    def param_keys(self) -> list[str]:
        """Kernel parameter names, in the TPU kernel's argument order."""
        keys = ["w0i", "b0"]
        for i in range(1, self.depth):
            keys += [f"w{i}", f"b{i}"]
            if (i - 1) in self.skip_layers:
                keys += [f"w{i}i"]
        keys += ["wpo_t", "bpo"]
        if self.has_views:
            keys += ["wf", "bf", "wv0f", "bv0"]
            if self.has_extra:
                keys += ["wv0i"]
            for i in range(1, self.views_depth):
                keys += [f"wv{i}", f"bv{i}"]
            keys += ["wvo_t", "bvo"]
        return keys

    def _input_macs(self) -> int:
        """Multiply-adds of one point against the lo/hi inputs (no dX there)."""
        n_joins = 1 + sum(1 for i in range(1, self.depth) if (i - 1) in self.skip_layers)
        macs = n_joins * self.in_lo * self.width
        if self.has_views:
            macs += self.in_hi * self.views_width
        return macs

    def macs_per_point(self) -> int:
        """Multiply-adds of one point through every matmul and head (padded
        join rows of an ensemble member counted)."""
        macs = self._input_macs() + (self.depth - 1) * self.width**2 + self.out_p * self.width
        if self.has_views:
            macs += self.width**2 + self.width * self.views_width
            macs += (self.views_depth - 1) * self.views_width**2 + self.out_v * self.views_width
        return macs

    def flops_per_point(self) -> int:
        return 2 * self.macs_per_point()

    def bwd_flops_per_point(self) -> int:
        """The recompute VJP: the forward again, dW, and dX except into lo/hi."""
        return 2 * (3 * self.macs_per_point() - self._input_macs())

    def row_flops_per_point(self) -> int:
        """The backward's row pass: the forward again and dX (its dW is the weight pass's)."""
        return 2 * (2 * self.macs_per_point() - self._input_macs())


def make_spec(cfg, ns: int, dtype, shared_pe_degree: Optional[int] = None) -> FusedSpec:
    """Static spec for one `fields.mlp.MLPConfig` evaluation.

    ns groups rows for `hvx`: samples per ray when view dirs are per-ray,
    else 1.
    """
    return FusedSpec(
        depth=cfg.points_net_depth,
        width=cfg.points_net_width,
        views_depth=cfg.views_net_depth if cfg.view_dep_outputs else 0,
        views_width=cfg.views_net_width,
        pe_degree=cfg.points_pe_degree,
        sigma_pe_degree=cfg.sigma_pe_degree,
        skip_layers=tuple(cfg.skip_layers),
        out_p=cfg.points_output_dim,
        out_v=cfg.views_output_dim if cfg.view_dep_outputs else 0,
        has_extra=cfg.extra_views_dim > 0,
        has_hvx=bool(cfg.use_view_dirs and cfg.view_dep_outputs),
        ns=ns,
        dtype={torch.bfloat16: "bfloat16", torch.float64: "float64"}.get(dtype, "float32"),
        shared_pe_degree=shared_pe_degree,
    )


@dataclasses.dataclass(frozen=True)
class EnsembleSpec:
    """Several field MLPs evaluated at the same points from one shared lo block.

    Architectures may differ (the published main + points-augmentation +
    Lambertian views-augmentation coarse trio); all members share ns, the
    compute dtype and the shared PE degree.
    """

    members: tuple[FusedSpec, ...]

    @property
    def ns(self) -> int:
        return self.members[0].ns

    @property
    def cdtype(self) -> torch.dtype:
        return self.members[0].cdtype

    @property
    def in_lo(self) -> int:
        return self.members[0].in_lo

    @property
    def n_planes(self) -> int:
        return sum(m.n_planes for m in self.members)

    @property
    def hvx_members(self) -> tuple[int, ...]:
        return tuple(i for i, m in enumerate(self.members) if m.has_hvx)

    def flops_per_point(self) -> int:
        return sum(m.flops_per_point() for m in self.members)

    def bwd_flops_per_point(self) -> int:
        return sum(m.bwd_flops_per_point() for m in self.members)

    def row_flops_per_point(self) -> int:
        return sum(m.row_flops_per_point() for m in self.members)


def with_dtype(spec, dtype: str):
    """A FusedSpec or EnsembleSpec in another compute type; "float64" runs
    the plain versions in float64 (no kernel takes it)."""
    if isinstance(spec, EnsembleSpec):
        return EnsembleSpec(members=tuple(with_dtype(m, dtype) for m in spec.members))
    return dataclasses.replace(spec, dtype=dtype)


def make_ensemble_spec(cfgs, ns: int, dtype) -> EnsembleSpec:
    """Spec for evaluating `cfgs` jointly at shared points from one shared
    full-degree lo block (the largest member's PE degree)."""
    d_max = max(cfg.points_pe_degree for cfg in cfgs)
    return EnsembleSpec(members=tuple(make_spec(cfg, ns, dtype, d_max) for cfg in cfgs))


def kernel_params(params, cfg, shared_degree: Optional[int] = None) -> dict:
    """Re-slice canonical (reference-layout) params into kernel layout.

    Input joins are row-merged to the blocked [x | sin | cos] order (one
    matmul per join); head weights are transposed to (n_out, W) rows. The
    dirs rows of the first views-branch weight are not included (see
    `dirs_w`: they enter through the per-ray `hvx`). Differentiable: the
    gradients of the result reach `params` through the gathers.

    `shared_degree=D`: ensemble mode. The joins are zero-row padded to the
    shared full-degree layout [x | s f<D | c f<D], so every member reads the
    same lo block. The zero rows are constants; their gradient is dropped by
    `torch.cat`'s backward, so the canonical gradients are unchanged.
    """
    from simplenerf_torch.fields.mlp import _extra_rows_perm

    ds, d = cfg.sigma_pe_degree, cfg.points_pe_degree
    perm_lo = encoding.blocked_to_reference_perm(ds)
    p = cfg.points_input_dim

    def zeros(rows, w):
        return torch.zeros((rows, w.shape[1]), dtype=w.dtype, device=w.device)

    def pad_lo(w):
        """(3+6ds, W) [x|s<ds|c<ds] -> (3+6D, W) with zeros at f >= ds."""
        if shared_degree is None or shared_degree == ds:
            return w
        z = zeros(3 * (shared_degree - ds), w)
        return torch.cat([w[: 3 + 3 * ds], z, w[3 + 3 * ds :], z])

    def pad_hi(w):
        """(6(d-ds), W) [s ds..d | c ds..d] -> (3+6D, W) full-layout pad."""
        if shared_degree is None:
            return w
        nsd, tail = 3 * (d - ds), zeros(3 * (shared_degree - d), w)
        return torch.cat([zeros(3 + 3 * ds, w), w[:nsd], tail, zeros(3 * ds, w), w[nsd:], tail])

    kp: dict = {}
    w0 = params["pts"][0]
    kp["w0i"] = pad_lo(encoding.take_rows(w0["w"], perm_lo))
    kp["b0"] = w0["b"][None]
    for i in range(1, cfg.points_net_depth):
        layer = params["pts"][i]
        if (i - 1) in cfg.skip_layers:
            kp[f"w{i}i"] = pad_lo(encoding.take_rows(layer["w"][:p], perm_lo))
            kp[f"w{i}"] = layer["w"][p:]
        else:
            kp[f"w{i}"] = layer["w"]
        kp[f"b{i}"] = layer["b"][None]
    kp["wpo_t"] = params["pts_out"]["w"].T
    kp["bpo"] = params["pts_out"]["b"][None]

    if cfg.view_dep_outputs:
        kp["wf"] = params["feature"]["w"]
        kp["bf"] = params["feature"]["b"][None]
        wv0 = params["views"][0]
        wp, e = cfg.points_net_width, cfg.extra_views_dim
        kp["wv0f"] = wv0["w"][:wp]
        kp["bv0"] = wv0["b"][None]
        if e:
            kp["wv0i"] = pad_hi(encoding.take_rows(wv0["w"][wp : wp + e], _extra_rows_perm(cfg)))
        for i in range(1, cfg.views_net_depth):
            kp[f"wv{i}"] = params["views"][i]["w"]
            kp[f"bv{i}"] = params["views"][i]["b"][None]
        kp["wvo_t"] = params["views_out"]["w"].T
        kp["bvo"] = params["views_out"]["b"][None]
    return kp


def dirs_w(params, cfg):
    """Blocked dirs-rows of the first views-branch weight (for hvx)."""
    wp, e = cfg.points_net_width, cfg.extra_views_dim
    perm = encoding.blocked_to_reference_perm(cfg.views_pe_degree)
    return encoding.take_rows(params["views"][0]["w"][wp + e :], perm)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path, and the oracles the kernels are held against)
# ---------------------------------------------------------------------------


def _op(x, spec: FusedSpec):
    """x rounded to the compute dtype, in the accumulation type."""
    return x.to(spec.cdtype).to(spec.acc_dtype)


def _mm(a, b, spec: FusedSpec):
    return _op(a, spec) @ _op(b, spec)


def _mm_tn(a, b, spec: FusedSpec):
    """a^T @ b with operands rounded to the compute dtype (for dW)."""
    return _op(a, spec).T @ _op(b, spec)


def _mm_nt(a, b, spec: FusedSpec):
    """a @ b^T with operands rounded to the compute dtype (for dX)."""
    return _op(a, spec) @ _op(b, spec).T


def _relu_mask(h):
    return (h.float() > 0).float()


def _head_planes(spec: FusedSpec, h, wt, b, n_out):
    """Head channel j: plane_j[r, s] = sum_k h[r*ns+s, k] * wt[j, k] + b[j], in f32."""
    h3 = h.to(spec.acc_dtype).reshape(-1, spec.ns, h.shape[-1])
    return [(h3 * wt[j].to(spec.acc_dtype)).sum(-1) + b[0, j] for j in range(n_out)]


def _head_backward(spec: FusedSpec, h, wt, d_planes):
    """VJP of `_head_planes`: (dh (N, W) f32, dwt (n_out, W) f32, db (1, n_out) f32)."""
    h3 = h.to(spec.acc_dtype).reshape(-1, spec.ns, h.shape[-1])
    dh3 = torch.zeros_like(h3)
    dwt, db = [], []
    for j, dp in enumerate(d_planes):
        dp3 = dp.reshape(-1, spec.ns, 1)
        dh3 = dh3 + dp3 * wt[j].to(spec.acc_dtype)
        dwt.append((h3 * dp3).sum((0, 1)))
        db.append(dp.sum())
    return dh3.reshape(-1, h.shape[-1]), torch.stack(dwt), torch.stack(db)[None]


def _trunk_forward(spec: FusedSpec, kp: dict, lo, keep: bool = True) -> list:
    """Post-ReLU trunk activations h_0..h_{D-1}, stored at the compute
    dtype (only the last one unless `keep`)."""
    h = torch.relu(_mm(lo, kp["w0i"], spec) + kp["b0"]).to(spec.cdtype)
    hs = [h]
    for i in range(1, spec.depth):
        acc = _mm(h, kp[f"w{i}"], spec)
        if (i - 1) in spec.skip_layers:
            acc = acc + _mm(lo, kp[f"w{i}i"], spec)
        h = torch.relu(acc + kp[f"b{i}"]).to(spec.cdtype)
        hs = hs + [h] if keep else [h]
    return hs


def _views_forward(spec: FusedSpec, kp: dict, h, hi, hvx):
    """Views branch: (feature, [hv_0, ...]); hvx (nr, Wv) per ray or None."""
    f = (_mm(h, kp["wf"], spec) + kp["bf"]).to(spec.cdtype)
    acc = _mm(f, kp["wv0f"], spec) + kp["bv0"]
    if spec.has_extra:
        acc = acc + _mm(hi, kp["wv0i"], spec)
    if hvx is not None:
        acc = acc + hvx.to(spec.acc_dtype).repeat_interleave(spec.ns, dim=0)
    hvs = [torch.relu(acc).to(spec.cdtype)]
    for i in range(1, spec.views_depth):
        hvs.append(torch.relu(_mm(hvs[-1], kp[f"wv{i}"], spec) + kp[f"bv{i}"]).to(spec.cdtype))
    return f, hvs


def fused_apply_reference(spec: FusedSpec, kp: dict, lo, hi, hvx) -> tuple:
    """The forward kernel's function in plain PyTorch (same roundings, f32 heads)."""
    hs = _trunk_forward(spec, kp, lo, keep=False)
    planes = _head_planes(spec, hs[-1], kp["wpo_t"], kp["bpo"], spec.out_p)
    if spec.has_views:
        _, hvs = _views_forward(spec, kp, hs[-1], hi, hvx)
        planes += _head_planes(spec, hvs[-1], kp["wvo_t"], kp["bvo"], spec.out_v)
    return tuple(planes)


def fused_bwd_reference(spec: FusedSpec, kp: dict, lo, hi, hvx, d_planes):
    """The backward kernel's function in plain PyTorch: (dkp, dhvx).

    A transcription of the TPU `_bwd_kernel` over all rows at once (not
    autograd through `fused_apply_reference`, which would round in other
    places): every product rounds both operands to the compute dtype and
    accumulates in f32, the ReLU mask is taken on the stored activation,
    head gradients and every db are f32 sums. dkp holds f32 gradients of
    every kernel parameter; dhvx (nr, Wv) is the per-ray sum of the f32
    views-layer-0 cotangent (None without hvx). d_planes: (n_planes, nr, ns)
    or a sequence of (nr, ns) tensors, None for a plane no loss reads.
    """
    nr = lo.shape[0] // spec.ns
    ref = torch.empty((nr, spec.ns), device=lo.device, dtype=spec.acc_dtype)
    dps = _cotangent_list(spec.n_planes, d_planes, ref)
    grads: dict = {}

    def acc(key, val):
        grads[key] = grads[key] + val if key in grads else val

    hs = _trunk_forward(spec, kp, lo)
    dh = None
    dhvx = None
    if spec.has_views:
        f, hvs = _views_forward(spec, kp, hs[-1], hi, hvx)
        g, dwvo_t, dbvo = _head_backward(spec, hvs[-1], kp["wvo_t"], dps[spec.out_p :])
        acc("wvo_t", dwvo_t)
        acc("bvo", dbvo)
        g = g * _relu_mask(hvs[-1])
        for i in range(spec.views_depth - 1, 0, -1):
            acc(f"wv{i}", _mm_tn(hvs[i - 1], g, spec))
            acc(f"bv{i}", g.sum(0, keepdim=True))
            g = _mm_nt(g, kp[f"wv{i}"], spec) * _relu_mask(hvs[i - 1])
        if hvx is not None:
            dhvx = g.reshape(nr, spec.ns, -1).sum(1)
        acc("bv0", g.sum(0, keepdim=True))
        acc("wv0f", _mm_tn(f, g, spec))
        if spec.has_extra:
            acc("wv0i", _mm_tn(hi, g, spec))
        df = _mm_nt(g, kp["wv0f"], spec)
        acc("wf", _mm_tn(hs[-1], df, spec))
        acc("bf", df.sum(0, keepdim=True))
        dh = _mm_nt(df, kp["wf"], spec)

    dpo_h, dwpo_t, dbpo = _head_backward(spec, hs[-1], kp["wpo_t"], dps[: spec.out_p])
    acc("wpo_t", dwpo_t)
    acc("bpo", dbpo)
    dh = dpo_h if dh is None else dh + dpo_h
    for i in range(spec.depth - 1, 0, -1):
        g = dh * _relu_mask(hs[i])
        acc(f"w{i}", _mm_tn(hs[i - 1], g, spec))
        acc(f"b{i}", g.sum(0, keepdim=True))
        if (i - 1) in spec.skip_layers:
            acc(f"w{i}i", _mm_tn(lo, g, spec))
        dh = _mm_nt(g, kp[f"w{i}"], spec)
    g = dh * _relu_mask(hs[0])
    acc("w0i", _mm_tn(lo, g, spec))
    acc("b0", g.sum(0, keepdim=True))
    return {k: grads[k] for k in spec.param_keys()}, dhvx


def _cotangent_list(n_planes: int, d_planes, ref) -> list:
    """Plane cotangents as n_planes tensors shaped like `ref`, of its dtype
    (float32, or float64 for the yardstick); None -> zeros."""
    if isinstance(d_planes, torch.Tensor):
        d_planes = d_planes.unbind(0)
    d_planes = list(d_planes)
    if len(d_planes) != n_planes:
        raise ValueError(f"{len(d_planes)} plane cotangents for {n_planes} planes")
    return [torch.zeros_like(ref) if d is None else d.to(ref.dtype).reshape(ref.shape)
            for d in d_planes]


def _member_planes(ens: EnsembleSpec, seq) -> list:
    """Split a flat member-major sequence of planes into per-member lists."""
    out, pos = [], 0
    for m in ens.members:
        out.append(list(seq[pos : pos + m.n_planes]))
        pos += m.n_planes
    return out


def _member_hvx(ens: EnsembleSpec, hvxs) -> list:
    slots = {mi: slot for slot, mi in enumerate(ens.hvx_members)}
    return [hvxs[slots[mi]] if mi in slots else None for mi in range(len(ens.members))]


def fused_apply_ensemble_reference(ens: EnsembleSpec, kps, lo, hvxs) -> tuple:
    """The ensemble forward's function: each member over the shared lo block
    (which is also its views-branch extra input), planes member-major."""
    planes: list = []
    for m, kp, hvx in zip(ens.members, kps, _member_hvx(ens, hvxs)):
        planes += fused_apply_reference(m, kp, lo, lo if m.has_extra else None, hvx)
    return tuple(planes)


def fused_ens_bwd_reference(ens: EnsembleSpec, kps, lo, hvxs, d_planes):
    """The ensemble backward's function: (tuple of per-member dkp, tuple of
    dhvx in `hvx_members` order)."""
    nr = lo.shape[0] // ens.ns
    ref = torch.empty((nr, ens.ns), device=lo.device, dtype=ens.members[0].acc_dtype)
    dps = _cotangent_list(ens.n_planes, d_planes, ref)
    dkps, dhvx = [], {}
    for mi, (m, kp, hvx, dp) in enumerate(
        zip(ens.members, kps, _member_hvx(ens, hvxs), _member_planes(ens, dps))
    ):
        dkp, dh = fused_bwd_reference(m, kp, lo, lo if m.has_extra else None, hvx, dp)
        dkps.append(dkp)
        dhvx[mi] = dh
    return tuple(dkps), tuple(dhvx[mi] for mi in ens.hvx_members)


# ---------------------------------------------------------------------------
# Program packing (shared with csrc/fused_mlp_fwd.cu and csrc/fused_mlp_bwd.cu)
# ---------------------------------------------------------------------------

_MAX_OPS = 40  # layers of a forward program (sm90::kMaxOps)
_SRC_ACT, _SRC_LO, _SRC_HI = 0, 1, 2
_FLAG_RELU, _FLAG_HVX, _FLAG_ZERO = 1, 2, 4
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block can use
# The backward's intermediate program (`_bwd_plan`), which `bwd90_plan`
# translates for the row pass: a header of _BHEADER_WORDS and ops of
# _BOP_WORDS; and the float32 weight pass's Task in fused_mlp_bwd.cu.
_BHEADER = ("n_ops", "n_rows", "ns", "in_lo", "in_hi", "lo_kpad", "hi_kpad", "part_w", "hvx_w",
            "n_masks")
_BHEADER_WORDS = len(_BHEADER)
_BOP_WORDS = 24
_F_IN, _F_LAYER, _B_LAYER = 0, 1, 3
_MAX_HEAD = 4  # head channels one op takes (kMaxHead in the .cu)
_TASK_WORDS = 9  # a float32 weight-pass task
_WTILE = 128  # float32 weight-pass output tile
_WEIGHT_BLOCKS = 4 * 132  # float32 weight-pass blocks to aim for: four per SM
# bf16 weight pass: struct wgrad::Job and the constants of fused_mlp_wgrad_sm90.cuh.
_JOB_WORDS = 9
_WGRAD_MAX_MAPS = 128  # tensor maps the kernel's parameter holds (kMaxMaps)
_WBOX = 64  # rows and columns of one TMA box
_WBOX_BYTES = _WBOX * _WBOX * 2
_WGRAD_STAGES = 4
_WGRAD_SMEM = _WGRAD_STAGES * 6 * _WBOX_BYTES + 2 * _WGRAD_STAGES * 8  # two A and four G boxes
_SMS = 132  # streaming multiprocessors of an H100 SXM; the bf16 weight pass runs one CTA on each
_WGRAD_WAVES = (2, 4)  # the weight pass's grid: this many waves of _SMS CTAs, at least and at most
_WGRAD_FULL = 0.95  # a last wave this full is full enough
_COLSUM_THREADS = _SMS * 1024  # threads a column sum aims for (half of the card's resident threads)
_COLSUM_MIN_ROWS = 16  # rows one thread sums at least, where a sum is split into slices
# The float32 engines' weight chunks (csrc/fused_mlp_tf32_sm90.cuh): 64
# output rows x 32 deep, 8 KB; the ring's slot holds a chunk's big and small
# TF32 images.
_TF32_DEPTH = 32
_TF32_CHUNK_ROWS = 64
_TF32_CHUNK_FLOATS = _TF32_CHUNK_ROWS * _TF32_DEPTH
_TF32_SLOT = 2 * _TF32_CHUNK_FLOATS * 4
# The K row of an 8-deep group that its slot p holds in a float32 chunk: the
# TF32 A fragment takes columns (t, t + 4) of a k8 step where the float32
# tile's thread holds (2t, 2t + 1).
_TF32_PERM = np.array([0, 2, 4, 6, 1, 3, 5, 7])


def _round16(k: int) -> int:
    return -(-k // 16) * 16


def _tiling(cdtype) -> tuple[int, int]:
    """(rows per block, K depth of a weight slab or chunk): bf16 128 x 64,
    float32 128 x 32; a 64-row consumer's K block is 8 KB in both."""
    return (128, 64) if cdtype == torch.bfloat16 else (128, _TF32_DEPTH)


def _members_of(spec, kp):
    """(member specs, their kernel params, shared lo block?) of a spec or ensemble."""
    if isinstance(spec, EnsembleSpec):
        return list(spec.members), list(kp), True
    return [spec], [kp], False


def pack_program(spec, kp, n_rows: int):
    """Forward kernel operands: (program words int32 numpy, wts, fpar (f32), smem bytes).

    `spec` is a FusedSpec with its kernel-param dict, or an EnsembleSpec with
    a tuple of them. The program (`sm90_plan`) lists the layers in execution
    order, member after member, with the tiles each layer reads (the
    activation tile, which it then overwrites, the lo tile, the hi tile); an
    ensemble member's extra input is the shared lo tile. wts: the bf16 slab
    image, or the float32 chunk image's split (`tf32_split`).
    """
    _, kps, _ = _members_of(spec, kp)
    plan, w_index, f_index = _sm90_on(spec, kps[0]["w0i"].device)
    with torch.no_grad():
        zero = kps[0]["b0"].new_zeros(1, dtype=torch.float32)
        wsrc = torch.cat([kps[mi][k].reshape(-1).float() for mi, k in plan.w_src] + [zero])
        fsrc = torch.cat([kps[mi][k].reshape(-1).float() for mi, k in plan.f_src] + [zero])
        if plan.f32:
            wts = tf32_split(wsrc.index_select(0, w_index))
        else:
            wts = wsrc.to(torch.bfloat16).index_select(0, w_index)
        fpar = fsrc.index_select(0, f_index)
    words = plan.words.copy()
    words[1] = n_rows
    return words, wts, fpar, plan.smem


# The forward program of both engines: struct sm90::Program / sm90::Op in
# csrc/fused_mlp_sm90.cuh.
_SM90_HEADER_WORDS = 14
_SM90_OP_WORDS = 16
_SM90_KBLOCK = 64 * 128  # bytes of one K block of a consumer's 64-row tile (64 bf16, 32 floats deep)
_SM90_STAGES = (4, 3, 2)  # ring depths, the deepest that fits first
_SM90_BARRIERS = 9 * 8  # full and empty per stage (4 + 4) and the heads' mbarrier
_SM90_BIAS = 256  # floats of a layer's bias in a consumer's staging area (kBiasFloats)


def _n_pad(n: int) -> int:
    """The wgmma width a layer of n outputs runs at: 64, 128 or 256."""
    return 64 if n <= 64 else 128 if n <= 128 else 256


def _kblocks(k: int, depth: int = 64) -> int:
    return -(-k // depth)


def _slab_index(k: int, n: int, n_pad: int, base: int, strides=None, f32: bool = False) -> np.ndarray:
    """Source element of each element of a (K, N) = (k, n) weight's image,
    -1 for padding; the weight's element (kk, r) is source element
    base + kk * n + r, or base + kk * strides[0] + r * strides[1].

    bf16: slab kbi is n_pad rows of 128 bytes holding
    W^T[:, 64 kbi : 64 kbi + 64], the 16-byte chunk c of row r stored at
    chunk c ^ (r % 8) (the 128-byte swizzle of csrc/fused_mlp_sm90.cuh).
    float32 (csrc/fused_mlp_tf32_sm90.cuh): each 32-deep slab kbi is n_pad /
    64 chunks of 64 rows of 128 bytes, chunk ch holding
    W^T[64 ch : 64 ch + 64, 32 kbi : 32 kbi + 32] in the same swizzle (four
    floats a 16-byte chunk), its depth permuted: slot p of each 8-deep group
    holds the group's K row _TF32_PERM[p % 8]."""
    sk, sr = strides or (n, 1)
    if not f32:
        kb = _kblocks(k)
        kbi, r, kl = np.meshgrid(np.arange(kb), np.arange(n_pad), np.arange(64), indexing="ij")
        kk = kbi * 64 + kl
        pos = kbi * n_pad * 64 + r * 64 + ((kl // 8) ^ (r % 8)) * 8 + kl % 8
        row = r
    else:
        kb, chunks = _kblocks(k, _TF32_DEPTH), n_pad // _TF32_CHUNK_ROWS
        kbi, ch, r, sl = np.meshgrid(np.arange(kb), np.arange(chunks), np.arange(_TF32_CHUNK_ROWS),
                                     np.arange(_TF32_DEPTH), indexing="ij")
        kk = kbi * _TF32_DEPTH + sl // 8 * 8 + _TF32_PERM[sl % 8]
        pos = (((kbi * chunks + ch) * _TF32_CHUNK_ROWS + r) * _TF32_DEPTH
               + ((sl // 4) ^ (r % 8)) * 4 + sl % 4)
        row = ch * _TF32_CHUNK_ROWS + r
    idx = np.full(pos.size, -1, dtype=np.int64)
    idx[pos.reshape(-1)] = np.where((row < n) & (kk < k), base + kk * sk + row * sr, -1).reshape(-1)
    return idx


@dataclasses.dataclass(frozen=True)
class Sm90Plan:
    """The forward program of one spec, without its parameters.

    words: the program (n_rows left 0); w_src / f_src: ((member, key), ...)
    whose flattened values, concatenated with one zero after them, the
    image indices w_index (the bf16 slab image, or the float32 chunk image
    before its split; `_slab_index`) and f_index (the float32 buffer: head
    weights first, each row zero-padded to its layer's n_pad, then each
    layer's bias padded to n_pad, then the head biases) gather from; smem:
    shared-memory bytes of a block; f32: the float32 engine's program.
    """

    words: np.ndarray
    w_src: tuple
    w_index: np.ndarray
    f_src: tuple
    f_index: np.ndarray
    smem: int
    f32: bool = False


def _sm90_shapes(m: FusedSpec) -> dict:
    """(K, N) of every kernel parameter of a member, as `kernel_params` makes them."""
    W, Wv = m.width, m.views_width
    shapes = {"w0i": (m.in_lo, W), "b0": (1, W), "wpo_t": (m.out_p, W), "bpo": (1, m.out_p)}
    for i in range(1, m.depth):
        shapes[f"w{i}"], shapes[f"b{i}"] = (W, W), (1, W)
        if (i - 1) in m.skip_layers:
            shapes[f"w{i}i"] = (m.in_lo, W)
    if m.has_views:
        shapes.update(wf=(W, W), bf=(1, W), wv0f=(W, Wv), bv0=(1, Wv), wvo_t=(m.out_v, Wv),
                      bvo=(1, m.out_v))
        if m.has_extra:
            shapes["wv0i"] = (m.in_hi, Wv)
        for i in range(1, m.views_depth):
            shapes[f"wv{i}"], shapes[f"bv{i}"] = (Wv, Wv), (1, Wv)
    return shapes


def sm90_plan(spec) -> Sm90Plan:
    """The forward program of a FusedSpec or EnsembleSpec: the bf16
    engine's, or in float32 the 3xTF32 engine's (K blocks and slabs 32
    deep, 16 KB slots of a chunk's two images)."""
    members = list(spec.members) if isinstance(spec, EnsembleSpec) else [spec]
    shared = isinstance(spec, EnsembleSpec)
    m0 = members[0]
    f32 = m0.cdtype != torch.bfloat16
    depth = _TF32_DEPTH if f32 else 64
    w_src, w_parts, w_size = [], [], [0]  # w_size: source elements so far
    f_src, f_pos = [], [0]
    heads, biases, head_biases = [], [], []  # (layer, source base, sizes...) of each
    ops = []

    def fsource(mi, key, size):
        f_src.append((mi, key))
        f_pos[0] += size
        return f_pos[0] - size

    def layer(mi, shapes, segs, n, bkey, flags, hvx_slot=0):
        n_pad = _n_pad(n)
        op = [n, n_pad, 0, flags, len(segs), 0, 0, 0, 0, 0, 0, hvx_slot, 0, 0, 0, 0]
        for s, (src, key) in enumerate(segs):
            k, nn = shapes[key]
            w_parts.append(_slab_index(k, nn, n_pad, w_size[0], f32=f32))
            w_src.append((mi, key))
            w_size[0] += k * nn
            op[5 + s], op[8 + s] = src, _kblocks(k, depth)
        biases.append((len(ops), fsource(mi, bkey, n), n, n_pad))
        ops.append(op)

    def head(mi, shapes, wkey, bkey, plane):
        n_out, k = shapes[wkey]
        if n_out > _MAX_HEAD:
            raise ValueError(f"a head of {n_out} channels; the kernel takes {_MAX_HEAD}")
        op = ops[-1]
        op[12], op[13] = plane, n_out
        heads.append((len(ops) - 1, fsource(mi, wkey, n_out * k), n_out, k, op[1]))
        head_biases.append((len(ops) - 1, fsource(mi, bkey, n_out), n_out))

    extra_src = _SRC_LO if shared else _SRC_HI
    plane, hvx_slot = 0, 0
    for mi, m in enumerate(members):
        sh = _sm90_shapes(m)
        layer(mi, sh, [(_SRC_LO, "w0i")], m.width, "b0", _FLAG_RELU)
        for i in range(1, m.depth):
            segs = [(_SRC_ACT, f"w{i}")]
            if (i - 1) in m.skip_layers:
                segs.append((_SRC_LO, f"w{i}i"))
            layer(mi, sh, segs, m.width, f"b{i}", _FLAG_RELU)
        head(mi, sh, "wpo_t", "bpo", plane)
        if m.has_views:
            layer(mi, sh, [(_SRC_ACT, "wf")], m.width, "bf", 0)
            segs = [(_SRC_ACT, "wv0f")] + ([(extra_src, "wv0i")] if m.has_extra else [])
            layer(mi, sh, segs, m.views_width, "bv0", _FLAG_RELU | (_FLAG_HVX if m.has_hvx else 0),
                  hvx_slot)
            hvx_slot += int(m.has_hvx)
            for i in range(1, m.views_depth):
                layer(mi, sh, [(_SRC_ACT, f"wv{i}")], m.views_width, f"bv{i}", _FLAG_RELU)
            head(mi, sh, "wvo_t", "bvo", plane + m.out_p)
        plane += m.n_planes
    if len(ops) > _MAX_OPS:
        raise ValueError(f"{len(ops)} kernel layers exceed the program's {_MAX_OPS}")

    # The float32 buffer: head weights (rows padded to n_pad), biases, head biases.
    f_index = []
    for oi, base, n_out, k, n_pad in heads:
        ops[oi][14] = sum(x.size for x in f_index)
        c = np.arange(n_pad)
        f_index += [np.where(c < k, base + o * k + c, -1) for o in range(n_out)]
    head_floats = sum(x.size for x in f_index)
    for oi, base, n, n_pad in biases:
        ops[oi][2] = sum(x.size for x in f_index)
        c = np.arange(n_pad)
        f_index.append(np.where(c < n, base + c, -1))
    for oi, base, n_out in head_biases:
        ops[oi][15] = sum(x.size for x in f_index)
        c = np.arange(4)
        f_index.append(np.where(c < n_out, base + c, -1))
    w_index = np.concatenate(w_parts)
    f_index = np.concatenate(f_index)
    w_index[w_index < 0] = w_size[0]  # the zero after the weights
    f_index[f_index < 0] = f_pos[0]

    in_hi = 0 if shared else m0.in_hi
    lo_kb, hi_kb = _kblocks(m0.in_lo, depth), _kblocks(in_hi, depth)
    act_kb = max(op[1] for op in ops) // depth
    slot = _TF32_SLOT if f32 else max(op[1] for op in ops) * 128
    hvx_w = max((m.views_width for m in members if m.has_hvx), default=0)
    hvx_rays = 63 // m0.ns + 2 if hvx_w else 0  # rays that 64 consecutive rows can touch

    def smem(stages, rays):
        return (stages * slot + 2 * (act_kb + lo_kb + hi_kb) * _SM90_KBLOCK
                + -(-head_floats * 4 // 16) * 16 + 2 * 4 * (_SM90_BIAS + rays * hvx_w)
                + _SM90_BARRIERS)

    # The deepest ring first, then hvx rows staged in shared memory if they
    # fit (float32 with a hi tile at the published widths: two 16 KB slots).
    stages, rays = next(((s, r) for s in _SM90_STAGES for r in (hvx_rays, 0)
                         if smem(s, r) <= _SMEM_LIMIT), (_SM90_STAGES[-1], 0))
    header = [len(ops), 0, m0.ns, m0.in_lo, in_hi, lo_kb, hi_kb, act_kb, slot, stages,
              head_floats, rays, _SM90_BIAS + rays * hvx_w, 0]
    words = np.asarray(header + [w for op in ops for w in op], dtype=np.int32)
    words.setflags(write=False)
    return Sm90Plan(words=words, w_src=tuple(w_src), w_index=w_index, f_src=tuple(f_src),
                    f_index=f_index, smem=smem(stages, rays), f32=f32)


@functools.lru_cache(maxsize=64)
def _sm90_on(spec, dev: torch.device) -> tuple:
    """(plan, w_index, f_index): `sm90_plan(spec)` with its gather indices as
    int32 tensors on `dev`, cached per spec and device."""
    plan = sm90_plan(spec)
    return (plan, *(torch.from_numpy(i.astype(np.int32)).to(dev) for i in (plan.w_index, plan.f_index)))


def slab_bytes(spec, rows: int) -> int:
    """Bytes of weight image one forward launch's producers ask for: every
    128-row block copies the whole image once (float32: each chunk's big and
    small halves). A count, not a reading of L2 traffic."""
    plan = sm90_plan(spec)
    return -(-rows // 128) * plan.w_index.size * (8 if plan.f32 else 2)


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the int32 view: the 13 low mantissa bits rounded
    to the nearest, ties away from zero (on the magnitude), then cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_halves(x: torch.Tensor) -> tuple:
    """(big, small): big = tf32(x), small = tf32(x - big), float32."""
    big = _tf32_round(x)
    return big, _tf32_round(x.float() - big)


def tf32_split(image: torch.Tensor) -> torch.Tensor:
    """A float32 weight image of 8 KB chunks -> each chunk's big image, then
    its small image (`tf32_halves`), twice the size.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (csrc/fused_mlp_fwd.cu `snerf_tf32_split`) or raise.
    """
    if image.dtype != torch.float32 or image.dim() != 1 or image.numel() % _TF32_CHUNK_FLOATS:
        raise ValueError(f"expected whole {_TF32_CHUNK_FLOATS}-float chunks of float32, got "
                         f"{tuple(image.shape)} {image.dtype}")
    if image.device.type == "cpu":
        return torch.stack(tf32_halves(image.view(-1, _TF32_CHUNK_FLOATS)), 1).reshape(-1)
    from simplenerf_torch.ops import build

    out = torch.empty(2 * image.numel(), dtype=torch.float32, device=image.device)
    rc = build.load_library("fused_mlp_fwd").snerf_tf32_split(
        _ptr(image.contiguous()), _ptr(out), image.numel(), _stream(image.device))
    if rc != 0:
        raise RuntimeError(f"snerf_tf32_split kernel launch failed: CUDA error {rc}")
    if image.numel():
        tf32_split.launches += 1
    return out


@dataclasses.dataclass
class BwdPlan:
    """Backward kernel operands and where each gradient lands.

    header: (_BHEADER_WORDS,) int32 (named by _BHEADER); ops: (n_ops, 24)
    int32, the backward's program (`_bwd_plan`) in ops of one product each;
    the row pass runs `rows90`, its translation (`bwd90_plan`), and wts /
    fpar are that program's weight image (bf16 slabs, or the float32
    chunks' split) and float32 buffer. wts / fpar are gathered per call from
    the kernel parameters that w_src / f_src name ((member, key) each;
    `_Gather`); the rest depends on the spec and the row count only and is
    cached (`_bwd_on`), with dev_tasks on the device. tasks: the weight
    pass's work, (n_tasks, 9) int32 float32 tiles or (n_jobs, 9) int32
    bf16 jobs (`_wgrad_plan`). The stash holds `stash_cols` column slots of
    n_rows rows each; partials rows are `part_w` wide, dW partials
    `dw_total`. The ReLU masks take `mask_words` int32 words: four per
    consumer thread of a tile for each of its ReLU layers (header n_masks).
    grads[mi][key] = ("dw" | "part", offset, shape) into the reduced dW or
    partials vector. bf16: `maps` (n_maps, 4) int64 are the weight pass's
    tensor maps and `wgrad_bytes` the stash bytes its producers issue
    (`WgradPlan`). dws: every dW as (a_slot, a_w, g_slot, g_w, k_in, n_out,
    dw_off). `slices`: the three column sums' slices (partials, dW
    partials, dhvx; `_colsum_slices`), `scratch` the floats their slice
    sums take.
    """

    header: np.ndarray
    ops: np.ndarray
    tasks: np.ndarray
    stash_cols: int
    part_w: int
    dw_total: int
    n_chunks: int
    chunk_rows: int
    hvx_w: int
    n_hvx: int
    smem: int
    mask_words: int
    grads: list
    maps: np.ndarray
    wgrad_bytes: int
    slices: tuple
    scratch: int
    dws: list
    w_src: tuple
    f_src: tuple
    rows90: "Bwd90Plan"
    wts: Optional[torch.Tensor] = None
    fpar: Optional[torch.Tensor] = None
    dev_tasks: Optional[torch.Tensor] = None


def _colsum_slices(S: int, L: int, C: int) -> tuple[int, int]:
    """(slices, rows per slice) of the column sum out[s] = sum_{i < L} in[s][i]
    (csrc/fused_mlp_bwd.cu `colsum`): the rows go in `slices` ranges of
    `per` rows, each summed in row order by threads of 4 columns, then the
    slices in order. Enough slices that the sum fills the card, none shorter
    than _COLSUM_MIN_ROWS rows, and none empty; the same for every launch at
    a shape, so the bits are the same."""
    groups = max(S * (C // 4 if C % 4 == 0 else C), 1)
    slices = max(1, min(_COLSUM_THREADS // groups, L // _COLSUM_MIN_ROWS))
    per = -(-L // slices) if L else 0
    slices = -(-L // per) if per else 1
    return slices, -(-L // slices) if L else 0


def _colsum_scratch(shapes) -> int:
    """Floats of slice sums the column sums at `shapes` ((S, L, C) each) need."""
    return max([S * _colsum_slices(S, L, C)[0] * C for S, L, C in shapes
                if _colsum_slices(S, L, C)[0] > 1] + [1])


@dataclasses.dataclass
class WgradPlan:
    """The bf16 weight pass's work (struct wgrad::Job in
    csrc/fused_mlp_wgrad_sm90.cuh), for stash slots of n_rows rows.

    jobs: (n_jobs, 9) int32, one CTA each, clusters of two consecutive
    jobs; maps: (n_maps, 4) int64
    tensor-map parameters, one per slot read: (element offset of the slot
    in the stash, width, n_rows, row stride in bytes); the maps' boxes are
    64 x 64. Each chunk of `chunk_rows` rows (a multiple of 64) writes one
    dW partials row. `issued`: the stash bytes the producers ask for (a
    box's rows and columns past the slot left out: the copy engine reads
    none of them).
    """

    jobs: np.ndarray
    maps: np.ndarray
    n_chunks: int
    chunk_rows: int
    issued: int


def _wgrad_chunks(n_rows: int, per_chunk: int) -> tuple[int, int]:
    """(n_chunks, chunk_rows): rows split into chunks of a multiple of 64
    rows, so that the grid (per_chunk CTAs a chunk, one CTA a SM) is
    _WGRAD_WAVES waves of _SMS CTAs: the fewest chunks whose last wave is
    at least _WGRAD_FULL full, else the fullest last wave. More chunks
    than needed only add dW partials to write and sum."""
    best = None
    lo, hi = (-(-w * _SMS // max(per_chunk, 1)) for w in _WGRAD_WAVES)
    for c in range(max(lo, 1), max(hi, 1) + 1):
        rows = max(-(-(-(-n_rows // c)) // _WBOX) * _WBOX, _WBOX)
        n = -(-n_rows // rows)
        slots = -(-n * per_chunk // _SMS) * _SMS
        full = n * per_chunk / slots
        if full >= _WGRAD_FULL:
            return n, rows
        if best is None or full > best[0]:
            best = (full, n, rows)
    return best[1], best[2]


def _wgrad_plan(dws, n_rows: int) -> WgradPlan:
    """The bf16 weight pass for dW = A[:, :k_in]^T G[:, :n_out] of every
    (a_slot, a_w, g_slot, g_w, k_in, n_out, dw_off) in `dws`, with A and G
    stash slots (column offsets and widths; a slot is an (n_rows, width)
    array at stash + slot * n_rows).

    A dW is cut into panels of 128 rows (two consumers of 64, one A box
    each; a panel of <= 64 rows gives both consumers its one A box and half
    of G's boxes), each a CTA that loads all of its boxes. The kernel runs
    consecutive jobs (2i, 2i + 1) as a cluster of two, which starts them
    together: the two panels of a dW of more than 128 rows on one chunk
    are such a pair (they read the same G, and the second read finds it
    in L2); every other panel is paired with the next one.
    """
    maps, map_of = [], {}

    def map_index(slot, width):
        if slot not in map_of:
            map_of[slot] = len(maps)
            maps.append([slot * n_rows, width, n_rows, width * 2])
        return map_of[slot]

    pairs, singles = [], []  # job words without the chunk; pairs: two panels of one dW each
    for a_slot, a_w, g_slot, g_w, k_in, n_out, off in dws:
        panels = [[map_index(a_slot, a_w), i0, min(2, -(-(k_in - i0) // _WBOX)),
                   map_index(g_slot, g_w), -(-n_out // _WBOX), off, k_in, n_out]
                  for i0 in range(0, k_in, 2 * _WBOX)]
        (pairs if len(panels) == 2 else singles).extend(panels)
    if len(maps) > _WGRAD_MAX_MAPS:
        raise ValueError(f"the weight pass reads {len(maps)} stash slots; its kernel takes at most "
                         f"{_WGRAD_MAX_MAPS} tensor maps")
    n_chunks, chunk_rows = _wgrad_chunks(n_rows, len(pairs) + len(singles))
    jobs, pending = [], []
    for c in range(n_chunks):
        jobs += [[c] + w for w in pairs]  # an even count: each pair is one cluster
        for w in singles:
            pending.append([c] + w)
            if len(pending) == 2:
                jobs += pending
                pending = []
    jobs += pending
    jobs = np.asarray(jobs, dtype=np.int32).reshape(-1, _JOB_WORDS)
    maps = np.asarray(maps, dtype=np.int64).reshape(-1, 4)
    return WgradPlan(jobs=jobs, maps=maps, n_chunks=n_chunks, chunk_rows=chunk_rows,
                     issued=_wgrad_issued(jobs, maps, n_rows, chunk_rows))


def _wgrad_issued(jobs: np.ndarray, maps: np.ndarray, n_rows: int, chunk_rows: int) -> int:
    """Stash bytes the jobs' producers issue, as `produce` in
    csrc/fused_mlp_wgrad_sm90.cuh asks for them: each CTA its A boxes and
    all of G's. Only a box's part inside the slot counts."""
    total = 0
    for chunk, a_map, i0, n_a, g_map, n_g, *_ in jobs.tolist():
        rows = min(n_rows, (chunk + 1) * chunk_rows) - chunk * chunk_rows
        boxes = [(a_map, i0 + b * _WBOX) for b in range(n_a)] + [(g_map, b * _WBOX) for b in range(n_g)]
        total += sum(rows * max(0, min(_WBOX, int(maps[m][1]) - c0)) * 2 for m, c0 in boxes)
    return total


class _Gather:
    """A program's weight buffer and float32 buffer as gathers from its
    kernel parameters, made without them: w_src / f_src name the parameters
    ((member, key) each) whose flattened values, concatenated with one zero
    after them, `w_index` / `f_index` gather from (-1: the zero)."""

    def __init__(self):
        self.w_src, self.w_parts, self.w_size, self.w_len = [], [], 0, 0
        self.f_src, self.f_size = [], 0

    def mat(self, src, shape, transpose: bool = True) -> tuple[int, int]:
        """Store the (K, N) parameter `src` as W^T (N, K) [or W (K, N)], rows
        zero-padded to 16 columns: (offset, kpad)."""
        k, n = shape
        rows, cols = (n, k) if transpose else (k, n)
        kpad = _round16(cols)
        r, c = np.meshgrid(np.arange(rows), np.arange(kpad), indexing="ij")
        pos = c * n + r if transpose else r * n + c
        self.w_parts.append(np.where(c < cols, self.w_size + pos, -1).reshape(-1))
        self.w_src.append(src)
        self.w_size += k * n
        self.w_len += rows * kpad
        return self.w_len - rows * kpad, kpad

    def fvec(self, src, size: int) -> int:
        """Store the parameter `src` (size values) as it is: its offset."""
        self.f_src.append(src)
        self.f_size += size
        return self.f_size - size



def _gather(kps, srcs, index: torch.Tensor, dtype) -> torch.Tensor:
    """One buffer of a program: the flattened parameters `srcs` names, one
    zero after them, gathered by `index`."""
    with torch.no_grad():
        flat = [kps[mi][k].detach().reshape(-1).to(dtype) for mi, k in srcs]
        flat.append(kps[0]["b0"].new_zeros(1, dtype=dtype))
        return torch.cat(flat).index_select(0, index)


def pack_bwd_program(spec, kp, n_rows: int) -> BwdPlan:
    """Backward kernel operands for a FusedSpec + kp, or an EnsembleSpec + kps:
    the cached plan of the spec at n_rows (`_bwd_on`) with its weight and
    float32 buffers gathered from the parameters, one gather each."""
    members, kps, _ = _members_of(spec, kp)
    plan, w_index, f_index, tasks = _bwd_on(spec, n_rows, kps[0]["w0i"].device)
    cd = members[0].cdtype
    wts = _gather(kps, plan.w_src, w_index, cd)
    return dataclasses.replace(plan, wts=wts if cd == torch.bfloat16 else tf32_split(wts),
                               fpar=_gather(kps, plan.f_src, f_index, torch.float32),
                               dev_tasks=tasks)


@functools.lru_cache(maxsize=16)
def _bwd_on(spec, n_rows: int, dev: torch.device) -> tuple:
    """(plan, w_index, f_index, tasks): `_bwd_plan(spec, n_rows)` with its
    gathers and its weight-pass tasks on `dev`, cached per spec, row count
    and device."""
    plan, w_index, f_index = _bwd_plan(spec, n_rows)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return plan, up(w_index.astype(np.int32)), up(f_index.astype(np.int32)), up(plan.tasks)


def _bwd_plan(spec, n_rows: int) -> tuple:
    """(plan without wts / fpar, w_index, f_index): the backward's program of
    a FusedSpec or EnsembleSpec at n_rows, its buffers as gathers from the
    concatenated parameters (`_Gather`, then the row pass's weight image and
    float32 buffer, `bwd90_plan`).

    The program runs each member's forward (stashing lo/hi and every layer's
    rounded activation; a ReLU layer also packs its mask as bits, and the
    layer that feeds a head forms the head's per-tile dW and db partials)
    and then its backward: per layer, from the top, the f32 cotangent g
    (head contributions added, the layer's ReLU mask bits applied),
    its per-tile column sum (db), round(g) into the stash, and the product
    round(g) @ W^T with W stored (K, round16(N)). The weight pass then forms
    every dW = A^T G from two stash slots: float32 in 128 x 128 tiles, bf16
    in the panels of `_wgrad_plan`. The column sums' slices follow
    `_colsum_slices`.
    """
    members = list(spec.members) if isinstance(spec, EnsembleSpec) else [spec]
    shared = isinstance(spec, EnsembleSpec)
    cd = members[0].cdtype
    bm, _ = _tiling(cd)
    buf = _Gather()
    ops, tasks, grads = [], [], []
    sizes = {"stash": 0, "part": 0, "dw": 0, "mask": 0}

    def alloc(kind, n):
        off = sizes[kind]
        sizes[kind] += n
        return off

    def op(kind, **f):
        w = [0] * _BOP_WORDS
        w[0] = kind
        for key, idx in (("n", 1), ("b_off", 2), ("flags", 3), ("plane", 14), ("hvx_slot", 15),
                         ("out_slot", 16), ("gn", 17), ("mask_slot", 18), ("head_nout", 19),
                         ("head_w_off", 20), ("part", 21), ("g32_slot", 22), ("part2", 23)):
            w[idx] = f.get(key, -1 if key in ("mask_slot", "g32_slot") else 0)
        for s, (src, key) in enumerate(f.get("segs", ())):
            w_off, kpad = buf.mat((mi, key), sh[key], transpose=f.get("transpose", True))
            w[5 + s], w[8 + s], w[11 + s] = src, w_off, kpad
        w[4] = len(f.get("segs", ()))
        if kind == _F_IN:
            w[5] = f["src"]
        ops.append(w)

    def task(a_slot, a_w, g_slot, g_w, k_in, n_out, key, g):
        off = alloc("dw", k_in * n_out)
        g[key] = ("dw", off, (k_in, n_out))
        tasks.append([a_slot, a_w, g_slot, g_w, k_in, n_out, off])

    m0 = members[0]
    lo_kpad = _round16(m0.in_lo)
    lo_slot = alloc("stash", lo_kpad)
    op(_F_IN, src=_SRC_LO, gn=lo_kpad, out_slot=lo_slot)
    extra = (_SRC_LO, lo_slot, lo_kpad)
    if not shared and m0.has_extra:
        hi_kpad = _round16(m0.in_hi)
        hi_slot = alloc("stash", hi_kpad)
        op(_F_IN, src=_SRC_HI, gn=hi_kpad, out_slot=hi_slot)
        extra = (_SRC_HI, hi_slot, hi_kpad)

    plane, hvx_slot = 0, 0
    hvx_w = max((m.views_width for m in members if m.has_hvx), default=0)
    for mi, m in enumerate(members):
        sh = _sm90_shapes(m)

        def fvec(key):
            return buf.fvec((mi, key), sh[key][0] * sh[key][1])

        if m.has_hvx and m.views_width != hvx_w:
            raise ValueError("the ensemble's hvx members must share one views width")
        if m.has_views and m.views_depth < 1:
            raise ValueError("a views head needs at least one views layer")
        g: dict = {}
        W, Wv = m.width, m.views_width

        def head_partials(key_w, key_b, pl, n_out, k):
            """The fields of the F_LAYER whose activation (k wide) feeds a head."""
            if n_out > _MAX_HEAD:
                raise ValueError(f"a head of {n_out} channels; the kernel takes {_MAX_HEAD}")
            pw, pb = alloc("part", n_out * k), alloc("part", n_out)
            g[key_w], g[key_b] = ("part", pw, (n_out, k)), ("part", pb, (1, n_out))
            return dict(plane=pl, head_nout=n_out, part=pw, part2=pb)

        # Forward, stashing every activation; h/hv: stash slots, hm/hvm: mask slots.
        h, hm = [], []
        for i in range(m.depth):
            segs = [(_SRC_LO, "w0i")] if i == 0 else [(_SRC_ACT, f"w{i}")]
            if i > 0 and (i - 1) in m.skip_layers:
                segs.append((_SRC_LO, f"w{i}i"))
            h.append(alloc("stash", W))
            hm.append(alloc("mask", 1))
            head = head_partials("wpo_t", "bpo", plane, m.out_p, W) if i == m.depth - 1 else {}
            op(_F_LAYER, segs=segs, n=W, b_off=fvec(f"b{i}"), flags=_FLAG_RELU,
               out_slot=h[-1], mask_slot=hm[-1], **head)
        hv, hvm = [], []
        my_hvx = -1
        if m.has_views:
            f_slot = alloc("stash", W)
            op(_F_LAYER, segs=[(_SRC_ACT, "wf")], n=W, b_off=fvec("bf"), flags=0,
               out_slot=f_slot)
            for i in range(m.views_depth):
                if i == 0:
                    segs = [(_SRC_ACT, "wv0f")]
                    if m.has_extra:
                        segs.append((extra[0], "wv0i"))
                    flags = _FLAG_RELU
                    if m.has_hvx:
                        flags |= _FLAG_HVX
                        my_hvx = hvx_slot
                        hvx_slot += 1
                else:
                    segs, flags = [(_SRC_ACT, f"wv{i}")], _FLAG_RELU
                hv.append(alloc("stash", Wv))
                hvm.append(alloc("mask", 1))
                head = {}
                if i == m.views_depth - 1:
                    head = head_partials("wvo_t", "bvo", plane + m.out_p, m.out_v, Wv)
                op(_F_LAYER, segs=segs, n=Wv, b_off=fvec(f"bv{i}"), flags=flags,
                   hvx_slot=max(my_hvx, 0), out_slot=hv[-1], mask_slot=hvm[-1], **head)

        # Backward, from the top.
        def back(gn, relu, mask_slot, b_key, zero=False, head=None, prod=None, g32=-1):
            """One B_LAYER; returns its G slot. head = (plane, n_out, wt key); prod = W's key, (K, N)."""
            g_slot, pdb = alloc("stash", gn), alloc("part", gn)
            g[b_key] = ("part", pdb, (1, gn))
            f = dict(gn=gn, flags=(_FLAG_RELU if relu else 0) | (_FLAG_ZERO if zero else 0),
                     mask_slot=mask_slot, out_slot=g_slot, part=pdb, g32_slot=g32)
            if head is not None:
                f.update(plane=head[0], head_nout=head[1], head_w_off=fvec(head[2]))
            if prod is not None:
                f.update(segs=[(_SRC_ACT, prod)], transpose=False, n=sh[prod][0])
            op(_B_LAYER, **f)
            return g_slot

        if m.has_views:
            vplane = plane + m.out_p
            for i in range(m.views_depth - 1, -1, -1):
                top = i == m.views_depth - 1
                gs = back(Wv, True, hvm[i], f"bv{i}", zero=top,
                          head=(vplane, m.out_v, "wvo_t") if top else None,
                          prod=f"wv{i}" if i else "wv0f",
                          g32=my_hvx if i == 0 else -1)
                if i:
                    task(hv[i - 1], Wv, gs, Wv, Wv, Wv, f"wv{i}", g)
                else:
                    task(f_slot, W, gs, Wv, W, Wv, "wv0f", g)
                    if m.has_extra:
                        task(extra[1], extra[2], gs, Wv, m.in_hi, Wv, "wv0i", g)
            gs = back(W, False, -1, "bf", prod="wf")
            task(h[-1], W, gs, W, W, W, "wf", g)
        for i in range(m.depth - 1, -1, -1):
            top = i == m.depth - 1
            gs = back(W, True, hm[i], f"b{i}", zero=top and not m.has_views,
                      head=(plane, m.out_p, "wpo_t") if top else None,
                      prod=f"w{i}" if i else None)
            if i:
                task(h[i - 1], W, gs, W, W, W, f"w{i}", g)
                if (i - 1) in m.skip_layers:
                    task(lo_slot, lo_kpad, gs, W, m.in_lo, W, f"w{i}i", g)
            else:
                task(lo_slot, lo_kpad, gs, W, m.in_lo, W, "w0i", g)
        grads.append({k: g[k] for k in m.param_keys()})
        plane += m.n_planes

    in_hi = 0 if shared else m0.in_hi
    header = np.asarray(
        [len(ops), n_rows, m0.ns, m0.in_lo, in_hi, lo_kpad, _round16(in_hi) if in_hi else 0,
         sizes["part"], hvx_w, sizes["mask"]], dtype=np.int32)
    if cd == torch.bfloat16:
        wp = _wgrad_plan(tasks, n_rows)
        n_chunks, chunk_rows, jobs, maps, issued = (wp.n_chunks, wp.chunk_rows, wp.jobs, wp.maps,
                                                     wp.issued)
    else:
        n_chunks = max(1, min(-(-_WEIGHT_BLOCKS // max(len(tasks), 1)), -(-n_rows // 256)))
        chunk_rows = -(-(-(-n_rows // n_chunks)) // 32) * 32
        n_chunks = -(-n_rows // chunk_rows)
        jobs = [t + [i0, j0] for t in tasks for i0 in range(0, t[4], _WTILE)
                for j0 in range(0, t[5], _WTILE)]
        jobs = np.asarray(jobs, dtype=np.int32).reshape(-1, _TASK_WORDS)
        maps, issued = np.zeros((0, 4), dtype=np.int64), 0
    sums = [(1, -(-n_rows // bm), sizes["part"]), (1, n_chunks, sizes["dw"]),
            (hvx_slot * (n_rows // m0.ns), m0.ns, hvx_w)]
    ops = np.asarray(ops, dtype=np.int32).reshape(-1, _BOP_WORDS)
    key = header.copy()
    key[1] = 0
    rows90 = bwd90_plan(key, ops, {s for t in tasks for s in (t[0], t[2])},
                        f32=cd != torch.bfloat16)
    w_index = np.concatenate(buf.w_parts)
    w_index = np.where(rows90.w_index < 0, -1, w_index[rows90.w_index])
    f_index = rows90.f_index
    smem, mask_words = rows90.smem, -(-n_rows // bm) * sizes["mask"] * _BWD90_MASK_THREADS * 4
    w_index = np.where(w_index < 0, buf.w_size, w_index)
    f_index = np.where(f_index < 0, buf.f_size, f_index)
    plan = BwdPlan(
        header=header, ops=ops, tasks=jobs,
        stash_cols=sizes["stash"], part_w=sizes["part"], dw_total=sizes["dw"], n_chunks=n_chunks,
        chunk_rows=chunk_rows, hvx_w=hvx_w, n_hvx=hvx_slot, smem=smem, mask_words=mask_words,
        grads=grads, maps=maps, wgrad_bytes=issued,
        slices=tuple(_colsum_slices(*x)[0] for x in sums), scratch=_colsum_scratch(sums), dws=tasks,
        w_src=tuple(buf.w_src), f_src=tuple(buf.f_src), rows90=rows90,
    )
    return plan, w_index, f_index


# The bf16 row pass: struct bwd90::Program / bwd90::Op in
# csrc/fused_mlp_bwd_sm90.cuh.
_BWD90_HEADER = ("n_ops", "n_rows", "ns", "in_lo", "in_hi", "lo_kb", "hi_kb", "act_kb",
                 "slot_bytes", "stages", "hvx_rays", "cst_floats", "part_w", "n_masks", "n_maps",
                 "hvx_w")
_BWD90_OP = ("kind", "n", "n_pad", "b_off", "flags", "nseg", "src", "kb", "hvx_slot", "out_slot",
             "map", "mask_slot", "plane", "head_nout", "head_w", "part", "part2",
             "g32_slot")  # src, kb: _BWD90_MAX_SEG ints each
_BWD90_MAX_SEG = 3
_BWD90_HEADER_WORDS = len(_BWD90_HEADER)
_BWD90_OP_WORDS = len(_BWD90_OP) + 2 * (_BWD90_MAX_SEG - 1)
_BWD90_MAX_OPS = 64
_BWD90_STAGES = (4, 3, 2)  # ring depths, the deepest that fits first
_BWD90_DP = 64 * _MAX_HEAD  # floats of a consumer's staged dp rows (kDpFloats)
_BWD90_RED = 2 * 4 * 256  # floats of the per-warp column sums (kRedFloats)
_BWD90_XFER = _MAX_HEAD * 256 + _MAX_HEAD  # floats of the hand-over buffer (kXferFloats)
_BWD90_BARRIERS = (2 * 4 + 2) * 8  # full and empty per stage (4 + 4), the hand-over's (1 + 1)
_BWD90_MASK_THREADS = 256  # consumer threads of a tile, one uint4 of mask words each


@dataclasses.dataclass(frozen=True)
class Bwd90Plan:
    """The row pass's program, translated from a BwdPlan's ops.

    words: the program (n_rows left 0); w_index: the weight image as a
    gather from the ops' weight buffer with one zero after it (every
    forward op's W^T and every backward product's W, (out rows, depth):
    bf16 in 64-deep slabs of n_pad rows, float32 in the 32-deep chunks of
    `_slab_index`, both 128-byte swizzled); f_index: its
    float32 buffer as a gather from the ops' (each bias padded to n_pad,
    then each head's weights [q][n_pad] for the backward op that adds
    them); maps: (stash slot, width) of the tensor map of each op whose
    slot the weight pass reads (the others' map is -1: the kernel stores
    no stash for them); smem: bytes of a block.
    """

    words: np.ndarray
    w_index: np.ndarray
    f_index: np.ndarray
    maps: tuple
    smem: int


def bwd90_plan(header: np.ndarray, ops: np.ndarray, read, f32: bool = False) -> Bwd90Plan:
    """The row pass's program from a BwdPlan's header and ops; `read`: the
    stash slots the weight pass reads; f32: the float32 engine's (K blocks
    and slabs 32 deep, 16 KB slots of a chunk's two images; `map` then only
    tells which slots to store: that row pass has no tensor maps).

    A forward op keeps its product and epilogue. A backward op of the row
    kernel is the product of the BOp before it (round(g) @ W^T, W stored
    (K, round16(N)) in the ops' buffer), or zeros at the top of a chain,
    followed by its own epilogue: so the product and the epilogue of one op
    share a width, as in the forward engine.
    """
    hdr = dict(zip(_BHEADER, (int(v) for v in header)))
    ns, in_lo, in_hi, part_w, hvx_w, n_masks = (hdr[k] for k in ("ns", "in_lo", "in_hi", "part_w",
                                                                "hvx_w", "n_masks"))
    depth = _TF32_DEPTH if f32 else 64
    w_parts, f_parts, maps, out = [], [], [], []
    f_size = [0]

    def fvec(idx):
        f_parts.append(idx)
        f_size[0] += idx.size
        return f_size[0] - idx.size

    def slabs(w_off, n, kpad):
        """The slabs of a matrix the ops' buffer stores (n, kpad) at w_off: its
        rows are the product's outputs."""
        w_parts.append(_slab_index(kpad, n, _n_pad(n), w_off, strides=(1, kpad), f32=f32))
        return _kblocks(kpad, depth)

    pending = None  # the product the next backward op runs: (w_off, n, kpad)
    for w in ops.tolist():
        kind, n, b_off, flags, nseg = w[:5]
        src, w_off, kpad = w[5:8], w[8:11], w[11:14]
        plane, hvx_slot, out_slot, gn, mask_slot, hn, hw_off, part, g32_slot, part2 = w[14:24]
        op = dict.fromkeys(_BWD90_OP, 0)
        op.update(kind=kind, out_slot=out_slot, map=-1, mask_slot=max(mask_slot, 0),
                  g32_slot=g32_slot, src=[0] * _BWD90_MAX_SEG, kb=[0] * _BWD90_MAX_SEG)
        if kind == _F_IN:
            op["n"], op["src"][0] = gn, src[0]
        elif kind == _F_LAYER:
            if pending is not None:
                raise ValueError("a forward op after a backward product")
            n_pad = _n_pad(n)
            c = np.arange(n_pad)
            op.update(n=n, n_pad=n_pad, b_off=fvec(np.where(c < n, b_off + c, -1)), flags=flags,
                      nseg=nseg, hvx_slot=hvx_slot, plane=plane, head_nout=hn, part=part,
                      part2=part2)
            for s_ in range(nseg):
                op["src"][s_], op["kb"][s_] = src[s_], slabs(w_off[s_], n, kpad[s_])
        else:
            if (pending is None) != bool(flags & _FLAG_ZERO):
                raise ValueError("a backward op's product does not match its chain")
            n_pad = _n_pad(gn)
            op.update(n=gn, n_pad=n_pad, flags=flags & ~_FLAG_ZERO, plane=plane, head_nout=hn,
                      part=part)
            if pending is not None:
                p_off, p_n, p_kpad = pending
                if p_n != gn:
                    raise ValueError(f"a product of width {p_n} feeds a layer of width {gn}")
                op["nseg"], op["src"][0], op["kb"][0] = 1, _SRC_ACT, slabs(p_off, p_n, p_kpad)
            if hn:
                c = np.arange(n_pad)
                op["head_w"] = fvec(np.concatenate([np.where(c < gn, hw_off + q * gn + c, -1)
                                                    for q in range(hn)]))
            pending = (w_off[0], n, kpad[0]) if nseg else None
        if out_slot in read:
            op["map"] = len(maps)
            maps.append((out_slot, op["n"]))
        out.append(op)
    if len(out) > _BWD90_MAX_OPS:
        raise ValueError(f"{len(out)} backward ops exceed the row kernel's {_BWD90_MAX_OPS}")
    if len(maps) > _WGRAD_MAX_MAPS:
        raise ValueError(f"{len(maps)} stash slots written; the row kernel takes {_WGRAD_MAX_MAPS}")
    lo_kb, hi_kb = _kblocks(in_lo, depth), _kblocks(in_hi, depth)
    act_kb = max(op["n_pad"] for op in out) // depth
    slot = _TF32_SLOT if f32 else max(op["n_pad"] for op in out if op["nseg"]) * 128
    hvx_rays = 63 // ns + 2 if hvx_w else 0  # rays that 64 consecutive rows can touch

    def smem(stages, rays):
        return (stages * slot + 2 * (act_kb + lo_kb + hi_kb) * _SM90_KBLOCK
                + 2 * 4 * (_SM90_BIAS + rays * hvx_w + _BWD90_DP) + 4 * (_BWD90_RED + _BWD90_XFER)
                + _BWD90_BARRIERS)

    fits = [(s_, r) for s_ in _BWD90_STAGES for r in (hvx_rays, 0) if smem(s_, r) <= _SMEM_LIMIT]
    if not fits:
        raise ValueError(f"the row kernel needs {smem(_BWD90_STAGES[-1], 0)} B of shared memory")
    stages, rays = fits[0]
    head = dict(n_ops=len(out), n_rows=0, ns=ns, in_lo=in_lo, in_hi=in_hi, lo_kb=lo_kb,
                hi_kb=hi_kb, act_kb=act_kb, slot_bytes=slot, stages=stages, hvx_rays=rays,
                cst_floats=_SM90_BIAS + rays * hvx_w, part_w=part_w, n_masks=n_masks,
                n_maps=len(maps), hvx_w=hvx_w)
    words = [head[k] for k in _BWD90_HEADER]
    for op in out:
        words += [v for k in _BWD90_OP for v in (op[k] if isinstance(op[k], list) else [op[k]])]
    words = np.asarray(words, dtype=np.int32)
    words.setflags(write=False)
    return Bwd90Plan(words=words, w_index=np.concatenate(w_parts), f_index=np.concatenate(f_parts),
                     maps=tuple(maps), smem=smem(stages, rays))


def unpack_grads(plan: BwdPlan, dw, part) -> list:
    """Per-member {key: f32 gradient} from the reduced dW and partials vectors."""
    out = []
    for g in plan.grads:
        dkp = {}
        for key, (where, off, shape) in g.items():
            src = dw if where == "dw" else part
            dkp[key] = src[off : off + shape[0] * shape[1]].view(shape)
        out.append(dkp)
    return out


# ---------------------------------------------------------------------------
# CUDA kernel launches
# ---------------------------------------------------------------------------


def _check_operands(spec: FusedSpec, lo, hi, hvx):
    if spec.width % 16 or not 16 <= spec.width <= 256:
        raise ValueError(f"kernel width {spec.width} must be a multiple of 16 in [16, 256]")
    if spec.has_views and (spec.views_width % 16 or not 16 <= spec.views_width <= 256):
        raise ValueError(f"views width {spec.views_width} must be a multiple of 16 in [16, 256]")
    if spec.has_views and spec.views_depth < 1:
        raise ValueError("a views head needs at least one views layer")
    n = lo.shape[0]
    if n % spec.ns:
        raise ValueError(f"{n} rows do not split into rays of {spec.ns} samples")
    expect = [("lo", lo, (n, spec.in_lo), spec.cdtype)]
    if spec.has_extra and hi is not None:
        expect.append(("hi", hi, (n, spec.in_hi), spec.cdtype))
    elif spec.has_extra and spec.shared_pe_degree is None:
        raise ValueError("hi: expected a tensor for a views-branch extra input")
    if spec.has_hvx:
        expect.append(("hvx", hvx, (n // spec.ns, spec.views_width), torch.float32))
    for name, t, shape, dt in expect:
        if t is None or tuple(t.shape) != shape or t.dtype != dt:
            got = None if t is None else (tuple(t.shape), t.dtype)
            raise ValueError(f"{name}: expected {shape} {dt}, got {got}")
        if not t.is_cuda or t.device != lo.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {lo.device}")


def _check_device(lo, name: str):
    if lo.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {lo.device}")


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _launch_fwd(spec, kp, lo, hi, hvx, entry: str) -> torch.Tensor:
    """Run the forward kernel: (n_planes, nr, ns) f32 planes."""
    from simplenerf_torch.ops import build

    n = lo.shape[0]
    words, wts, fpar, smem = pack_program(spec, kp, n)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"kernel needs {smem} B of shared memory, more than {_SMEM_LIMIT}")
    members = spec.members if isinstance(spec, EnsembleSpec) else (spec,)
    n_planes = sum(m.n_planes for m in members)
    out = torch.empty((n_planes, n // members[0].ns, members[0].ns), dtype=torch.float32,
                      device=lo.device)
    if n:
        lib = build.load_library("fused_mlp_fwd")
        args = [1 if members[0].cdtype == torch.bfloat16 else 0,
                words.ctypes.data_as(ctypes.c_void_p), int(words.size), _ptr(lo)]
        args += [_ptr(hi)] if entry == "snerf_fused_mlp_fwd" else []
        args += [_ptr(hvx), _ptr(wts), _ptr(fpar), _ptr(out), ctypes.c_int(smem),
                 _stream(lo.device)]
        rc = getattr(lib, entry)(*args)
        if rc != 0:
            raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    return out


def _launch_bwd(spec, kp, lo, hi, hvx, d_planes: torch.Tensor, entry: str):
    """Run the backward kernels: (per-member dkp list, dhvx (n_hvx, nr, Wv))."""
    from simplenerf_torch.ops import build

    n = lo.shape[0]
    plan = pack_bwd_program(spec, kp, n)
    if plan.smem > _SMEM_LIMIT:
        raise ValueError(f"kernel needs {plan.smem} B of shared memory, more than {_SMEM_LIMIT}")
    members = spec.members if isinstance(spec, EnsembleSpec) else (spec,)
    dev, cd, ns = lo.device, members[0].cdtype, members[0].ns
    bm, _ = _tiling(cd)
    n_tiles = -(-n // bm)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    stash = torch.empty(plan.stash_cols * n, dtype=cd, device=dev)
    g32 = f32(max(plan.n_hvx * n * plan.hvx_w, 1))
    masks = torch.empty(max(plan.mask_words, 2), dtype=torch.int32, device=dev)
    parts, part_out = f32(n_tiles * plan.part_w), f32(plan.part_w)
    dw_part, dw_out = f32(max(plan.n_chunks * plan.dw_total, 1)), f32(max(plan.dw_total, 1))
    dhvx = f32(plan.n_hvx, n // ns, max(plan.hvx_w, 1))
    scratch = f32(plan.scratch)
    slices = np.asarray(plan.slices, dtype=np.int32)
    words = plan.rows90.words.copy()  # the row pass's program
    words[1] = n
    maps = plan.maps
    if cd == torch.bfloat16:  # the row pass's tensor maps, then the weight pass's
        row_maps = [[slot * n, w, n, 2 * w] for slot, w in plan.rows90.maps]
        maps = np.concatenate([np.asarray(row_maps, dtype=np.int64).reshape(-1, 4), plan.maps])
    lib = build.load_library("fused_mlp_bwd")
    args = [1 if cd == torch.bfloat16 else 0, words.ctypes.data_as(ctypes.c_void_p),
            int(words.size), _ptr(lo)]
    args += [_ptr(hi)] if entry == "snerf_fused_mlp_bwd" else []
    args += [_ptr(hvx), _ptr(d_planes), _ptr(plan.wts), _ptr(plan.fpar), _ptr(plan.dev_tasks),
             len(plan.tasks), plan.n_chunks, plan.chunk_rows, plan.dw_total,
             plan.n_hvx * (n // ns), _ptr(stash), _ptr(g32), _ptr(masks), _ptr(parts),
             _ptr(part_out), _ptr(dw_part), _ptr(dw_out), _ptr(dhvx),
             maps.ctypes.data_as(ctypes.c_void_p), len(maps),
             slices.ctypes.data_as(ctypes.c_void_p), _ptr(scratch), ctypes.c_int(plan.smem),
             _stream(dev)]
    rc = getattr(lib, entry)(*args)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    return unpack_grads(plan, dw_out, part_out), dhvx


def wgrad(slots, dws) -> list:
    """The bf16 weight pass alone: [A[:, :k_in]^T G[:, :n_out]] in float32
    for every (a, g, k_in, n_out) of `dws`, with A = slots[a] and G =
    slots[g], (n_rows, width) bf16 matrices (width a multiple of 16).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (`_wgrad_plan`'s jobs on a stash of the slots, then the column sum of
    its partials over the chunks) or raise.
    """
    if slots[0].device.type == "cpu":
        return [slots[a][:, :k].float().T @ slots[g][:, :m].float() for a, g, k, m in dws]
    n, dev = slots[0].shape[0], slots[0].device
    widths = [x.shape[1] for x in slots]
    for x in slots:
        if x.dtype != torch.bfloat16 or x.device != dev or x.dim() != 2 or x.shape[0] != n:
            raise ValueError("slots must be (n_rows, width) bf16 tensors on one device")
    if any(w % 16 for w in widths) or not n:
        raise ValueError(f"slot widths {widths} must be multiples of 16, rows > 0")
    cols = np.cumsum([0] + widths).tolist()
    stash = torch.cat([x.contiguous().reshape(-1) for x in slots])
    tasks, offs, total = [], [], 0
    for a, g, k, m in dws:
        if not (0 < k <= widths[a] and 0 < m <= widths[g] and m % 2 == 0):
            raise ValueError(f"dW ({k}, {m}) does not fit slots of widths {widths[a]}, {widths[g]}")
        tasks.append([cols[a], widths[a], cols[g], widths[g], k, m, total])
        offs.append(total)
        total += k * m
    dw = _launch_wgrad(stash, n, _wgrad_plan(tasks, n), total)
    wgrad.launches += 1
    return [dw[o : o + k * m].view(k, m) for o, (_, _, k, m) in zip(offs, dws)]


def _launch_wgrad(stash: torch.Tensor, n_rows: int, plan: WgradPlan, dw_total: int) -> torch.Tensor:
    """Run a WgradPlan's jobs on a bf16 stash, then the column sum of their
    partials: the reduced dW vector (dw_total,) float32."""
    from simplenerf_torch.ops import build

    dev = stash.device
    jobs = torch.from_numpy(plan.jobs).to(dev)
    dw_part = torch.empty(plan.n_chunks * dw_total, dtype=torch.float32, device=dev)
    dw = torch.empty(dw_total, dtype=torch.float32, device=dev)
    slices, _ = _colsum_slices(1, plan.n_chunks, dw_total)
    scratch = torch.empty(_colsum_scratch([(1, plan.n_chunks, dw_total)]), dtype=torch.float32,
                          device=dev)
    rc = build.load_library("fused_mlp_bwd").snerf_wgrad(
        _ptr(stash), plan.maps.ctypes.data_as(ctypes.c_void_p), len(plan.maps), _ptr(jobs),
        len(plan.jobs), n_rows, plan.chunk_rows, plan.n_chunks, dw_total, _ptr(dw_part), _ptr(dw),
        slices, _ptr(scratch), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"snerf_wgrad kernel launch failed: CUDA error {rc}")
    return dw


def column_sums(x: torch.Tensor) -> torch.Tensor:
    """(S, L, C) float32 -> (S, C), the sum over L in the backward's fixed
    order (`_colsum_slices`). CPU tensors take the plain version
    (torch.sum); CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return x.sum(1)
    from simplenerf_torch.ops import build

    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"expected an (S, L, C) float32 tensor, got {tuple(x.shape)} {x.dtype}")
    x = x.contiguous()
    S, L, C = x.shape
    slices, _ = _colsum_slices(S, L, C)
    out = torch.empty((S, C), dtype=torch.float32, device=x.device)
    scratch = torch.empty(_colsum_scratch([(S, L, C)]), dtype=torch.float32, device=x.device)
    rc = build.load_library("fused_mlp_bwd").snerf_colsum(
        _ptr(x), _ptr(out), S, L, C, slices, _ptr(scratch), _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"snerf_colsum kernel launch failed: CUDA error {rc}")
    if S and C:
        column_sums.launches += 1
    return out


wgrad.launches = 0
column_sums.launches = 0
tf32_split.launches = 0


def _stacked_cotangents(n_planes: int, d_planes, nr: int, ns: int, device) -> torch.Tensor:
    if isinstance(d_planes, torch.Tensor):
        return d_planes.float().reshape(n_planes, nr, ns).contiguous()
    ref = torch.empty((nr, ns), device=device)
    return torch.stack(_cotangent_list(n_planes, d_planes, ref)).contiguous()


def _zero_grads(kp: dict, keys) -> dict:
    """The gradients of no rows: f32 zeros shaped like each kernel param."""
    return {k: torch.zeros(kp[k].shape, dtype=torch.float32, device=kp[k].device) for k in keys}


def _fwd(spec: FusedSpec, kp: dict, lo, hi, hvx) -> torch.Tensor:
    """The forward kernel (CUDA) or its plain version (CPU): stacked planes."""
    if lo.device.type == "cpu":
        return torch.stack(fused_apply_reference(spec, kp, lo, hi, hvx))
    _check_operands(spec, lo, hi, hvx)
    out = _launch_fwd(spec, kp, lo, hi, hvx, "snerf_fused_mlp_fwd")
    if lo.shape[0]:
        fused_apply.launches += 1
    return out


def fused_bwd(spec: FusedSpec, kp: dict, lo, hi, hvx, d_planes):
    """The backward of `fused_apply`: (dkp f32, dhvx or None).

    CPU tensors take `fused_bwd_reference`; CUDA tensors launch the kernel
    (or raise). d_planes: (n_planes, nr, ns) or a sequence with None for a
    plane no loss reads.
    """
    _check_device(lo, "fused_bwd")
    if lo.device.type == "cpu":
        return fused_bwd_reference(spec, kp, lo, hi, hvx, d_planes)
    _check_operands(spec, lo, hi, hvx)
    n = lo.shape[0]
    if n == 0:
        return _zero_grads(kp, spec.param_keys()), torch.zeros_like(hvx) if spec.has_hvx else None
    dp = _stacked_cotangents(spec.n_planes, d_planes, n // spec.ns, spec.ns, lo.device)
    (dkp,), dhvx = _launch_bwd(spec, kp, lo, hi, hvx, dp, "snerf_fused_mlp_bwd")
    fused_bwd.launches += 1
    return dkp, dhvx[0] if spec.has_hvx else None


class _FusedApply(torch.autograd.Function):
    """fused_apply under autograd: the forward kernel, then the backward kernel."""

    @staticmethod
    def forward(ctx, spec, keys, lo, hi, hvx, *vals):
        ctx.spec, ctx.keys = spec, keys
        ctx.save_for_backward(lo, hi, hvx, *vals)
        return _fwd(spec, dict(zip(keys, vals)), lo, hi, hvx)

    @staticmethod
    def backward(ctx, d_out):
        lo, hi, hvx, *vals = ctx.saved_tensors
        dkp, dhvx = fused_bwd(ctx.spec, dict(zip(ctx.keys, vals)), lo, hi, hvx, d_out)
        return (None, None, None, None, dhvx if ctx.needs_input_grad[4] else None,
                *(dkp[k] for k in ctx.keys))


def fused_apply(spec: FusedSpec, kp: dict, lo, hi, hvx) -> tuple:
    """Fused field evaluation -> tuple of `spec.n_planes` (N // ns, ns) f32 planes.

    lo: (N, in_lo) cdtype trunk input [x | sin f<ds | cos f<ds]; hi:
    (N, in_hi) cdtype high-frequency views-branch extra, required iff
    spec.has_extra; hvx: (N // ns, Wv) f32 per-ray views-branch addend,
    required iff spec.has_hvx. Points-head channels first, then views-head
    channels: raw linear head outputs.

    CPU tensors take the plain versions; CUDA tensors launch the kernels (or
    raise). Differentiable in kp and hvx (`fused_bwd`); lo and hi get none.
    """
    _check_device(lo, "fused_apply")
    keys = tuple(spec.param_keys())
    return _FusedApply.apply(spec, keys, lo, hi, hvx, *(kp[k] for k in keys)).unbind(0)


fused_apply.launches = 0
fused_bwd.launches = 0


def _check_ensemble(ens: EnsembleSpec, lo, hvxs):
    if len(hvxs) != len(ens.hvx_members):
        raise ValueError(f"{len(hvxs)} hvx tensors for {len(ens.hvx_members)} hvx members")
    if len({(m.ns, m.dtype, m.shared_pe_degree) for m in ens.members}) != 1:
        raise ValueError("ensemble members must share ns, dtype and the shared PE degree")
    for m, hvx in zip(ens.members, _member_hvx(ens, hvxs)):
        _check_operands(m, lo, None, hvx)


def _stack_hvx(hvxs):
    return torch.stack(list(hvxs)).contiguous() if hvxs else None


def _ens_fwd(ens: EnsembleSpec, kps, lo, hvxs) -> torch.Tensor:
    if lo.device.type == "cpu":
        return torch.stack(fused_apply_ensemble_reference(ens, kps, lo, hvxs))
    _check_ensemble(ens, lo, hvxs)
    out = _launch_fwd(ens, kps, lo, None, _stack_hvx(hvxs), "snerf_fused_mlp_ens_fwd")
    if lo.shape[0]:
        fused_apply_ensemble.launches += 1
    return out


def fused_ens_bwd(ens: EnsembleSpec, kps, lo, hvxs, d_planes):
    """The backward of `fused_apply_ensemble`: (per-member dkp tuple, dhvx tuple).

    CPU tensors take `fused_ens_bwd_reference`; CUDA tensors launch the
    kernel (or raise).
    """
    _check_device(lo, "fused_ens_bwd")
    if lo.device.type == "cpu":
        return fused_ens_bwd_reference(ens, kps, lo, hvxs, d_planes)
    _check_ensemble(ens, lo, hvxs)
    n = lo.shape[0]
    if n == 0:
        return (tuple(_zero_grads(kp, m.param_keys()) for m, kp in zip(ens.members, kps)),
                tuple(torch.zeros_like(h) for h in hvxs))
    dp = _stacked_cotangents(ens.n_planes, d_planes, n // ens.ns, ens.ns, lo.device)
    dkps, dhvx = _launch_bwd(ens, kps, lo, None, _stack_hvx(hvxs), dp, "snerf_fused_mlp_ens_bwd")
    fused_ens_bwd.launches += 1
    return tuple(dkps), tuple(dhvx.unbind(0)[: len(ens.hvx_members)])


class _FusedEnsemble(torch.autograd.Function):
    """fused_apply_ensemble under autograd."""

    @staticmethod
    def forward(ctx, ens, keys, n_hvx, lo, *flat):
        hvxs, vals = flat[:n_hvx], flat[n_hvx:]
        kps, pos = [], 0
        for ks in keys:
            kps.append(dict(zip(ks, vals[pos : pos + len(ks)])))
            pos += len(ks)
        ctx.ens, ctx.keys, ctx.n_hvx = ens, keys, n_hvx
        ctx.save_for_backward(lo, *flat)
        return _ens_fwd(ens, kps, lo, hvxs)

    @staticmethod
    def backward(ctx, d_out):
        lo, *flat = ctx.saved_tensors
        hvxs, vals = flat[: ctx.n_hvx], flat[ctx.n_hvx :]
        kps, pos = [], 0
        for ks in ctx.keys:
            kps.append(dict(zip(ks, vals[pos : pos + len(ks)])))
            pos += len(ks)
        dkps, dhvxs = fused_ens_bwd(ctx.ens, kps, lo, hvxs, d_out)
        grads = [d if ctx.needs_input_grad[4 + i] else None for i, d in enumerate(dhvxs)]
        for ks, dkp in zip(ctx.keys, dkps):
            grads += [dkp[k] for k in ks]
        return (None, None, None, None, *grads)


def fused_apply_ensemble(ens: EnsembleSpec, kps, lo, hvxs) -> tuple:
    """All ensemble members at shared points -> the flat member-major tuple
    of (N // ns, ns) f32 raw head planes (each member's points-head channels
    first, then its views-head channels).

    kps: one kernel-param dict per member (`kernel_params` with
    shared_degree, joins zero-padded to the full layout); lo: the ONE shared
    (N, 3+6*d_max) cdtype PE block [x|s|c], also every member's views-branch
    extra input; hvxs: (N // ns, Wv) per-ray addends of the members in
    `ens.hvx_members` order. CPU tensors take the plain versions; CUDA
    tensors launch the kernels (or raise). Differentiable in kps and hvxs.
    """
    _check_device(lo, "fused_apply_ensemble")
    keys = tuple(tuple(m.param_keys()) for m in ens.members)
    vals = [kp[k] for kp, ks in zip(kps, keys) for k in ks]
    return _FusedEnsemble.apply(ens, keys, len(hvxs), lo, *hvxs, *vals).unbind(0)


fused_apply_ensemble.launches = 0
fused_ens_bwd.launches = 0


_COUNTED = (fused_apply, fused_bwd, fused_apply_ensemble, fused_ens_bwd, wgrad, column_sums,
            tf32_split)


def launch_counts() -> dict:
    """Every counting wrapper's `launches`, by the wrapper's name."""
    return {f.__name__: f.launches for f in _COUNTED}


def add_launches(counts: dict):
    """Add `counts` (by wrapper name) to the wrappers' `launches`: a CUDA
    graph's replay launches what its capture counted."""
    for f in _COUNTED:
        f.launches += counts.get(f.__name__, 0)
