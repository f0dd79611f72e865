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
700 W). The forward keeps every activation on chip: a block owns a tile
of rows (128 in bf16), holds its lo/hi inputs and one activation tile in
shared memory, and walks a program of layers and heads (`pack_program`)
with each layer's transposed weight streaming through a ring of K-slabs
that every block reads from L2. The backward (`pack_bwd_program`) runs the
same program again, stashes the rounded activations and cotangents in
device memory, and computes dW in a second pass over the stash; sums over
rows are fixed-order reductions, so gradients do not change from run to
run. bf16 products run on the tensor cores (mma.sync, float32
accumulators); the float32 path is plain FMA (no TF32).

Each wrapper takes the plain version for CPU tensors and launches its
kernel (or raises) for CUDA tensors, and counts its launches:
`fused_apply.launches`, `fused_bwd.launches`,
`fused_apply_ensemble.launches`, `fused_ens_bwd.launches`. Under autograd
`fused_apply` and `fused_apply_ensemble` differentiate through the
backward wrappers; the points carry no gradient.
"""

from __future__ import annotations

import ctypes
import dataclasses
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
    dtype: str  # matmul input precision: "float32" | "bfloat16"
    # Ensemble mode: every member reads ONE shared full-degree lo block
    # [x | sin f<D | cos f<D]; its joins carry zero rows for the frequencies
    # outside its own window (`kernel_params(shared_degree=D)`).
    shared_pe_degree: Optional[int] = None

    @property
    def cdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

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
        dtype="bfloat16" if dtype == torch.bfloat16 else "float32",
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
    kp["w0i"] = pad_lo(w0["w"][perm_lo])
    kp["b0"] = w0["b"][None]
    for i in range(1, cfg.points_net_depth):
        layer = params["pts"][i]
        if (i - 1) in cfg.skip_layers:
            kp[f"w{i}i"] = pad_lo(layer["w"][:p][perm_lo])
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
            kp["wv0i"] = pad_hi(wv0["w"][wp : wp + e][_extra_rows_perm(cfg)])
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
    return params["views"][0]["w"][wp + e :][perm]


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path, and the oracles the kernels are held against)
# ---------------------------------------------------------------------------


def _mm(a, b, spec: FusedSpec):
    return a.to(spec.cdtype).float() @ b.to(spec.cdtype).float()


def _mm_tn(a, b, spec: FusedSpec):
    """a^T @ b with operands rounded to the compute dtype (for dW)."""
    return a.to(spec.cdtype).float().T @ b.to(spec.cdtype).float()


def _mm_nt(a, b, spec: FusedSpec):
    """a @ b^T with operands rounded to the compute dtype (for dX)."""
    return a.to(spec.cdtype).float() @ b.to(spec.cdtype).float().T


def _relu_mask(h):
    return (h.float() > 0).float()


def _head_planes(spec: FusedSpec, h, wt, b, n_out):
    """Head channel j: plane_j[r, s] = sum_k h[r*ns+s, k] * wt[j, k] + b[j], in f32."""
    h3 = h.float().reshape(-1, spec.ns, h.shape[-1])
    return [(h3 * wt[j].float()).sum(-1) + b[0, j] for j in range(n_out)]


def _head_backward(spec: FusedSpec, h, wt, d_planes):
    """VJP of `_head_planes`: (dh (N, W) f32, dwt (n_out, W) f32, db (1, n_out) f32)."""
    h3 = h.float().reshape(-1, spec.ns, h.shape[-1])
    dh3 = torch.zeros_like(h3)
    dwt, db = [], []
    for j, dp in enumerate(d_planes):
        dp3 = dp.reshape(-1, spec.ns, 1)
        dh3 = dh3 + dp3 * wt[j].float()
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
        acc = acc + hvx.float().repeat_interleave(spec.ns, dim=0)
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
    ref = torch.empty((nr, spec.ns), device=lo.device)
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
    """Plane cotangents as n_planes f32 tensors shaped like `ref`; None -> zeros."""
    if isinstance(d_planes, torch.Tensor):
        d_planes = d_planes.unbind(0)
    d_planes = list(d_planes)
    if len(d_planes) != n_planes:
        raise ValueError(f"{len(d_planes)} plane cotangents for {n_planes} planes")
    return [torch.zeros_like(ref, dtype=torch.float32) if d is None else d.float().reshape(ref.shape)
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
    dps = _cotangent_list(ens.n_planes, d_planes, torch.empty((nr, ens.ns), device=lo.device))
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

# Forward program: struct Program / Op in fused_mlp_fwd.cu.
_HEADER_WORDS = 13
_OP_WORDS = 16
_MAX_OPS = 40
_OP_LAYER, _OP_HEAD = 0, 1
_SRC_ACT, _SRC_LO, _SRC_HI = 0, 1, 2
_FLAG_RELU, _FLAG_HVX, _FLAG_ZERO = 1, 2, 4
_STAGES = 3  # weight slabs in flight
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block can use
# Backward program: struct BProgram / BOp / Task in fused_mlp_bwd.cu.
_BHEADER_WORDS = 16
_BOP_WORDS = 24
_F_IN, _F_LAYER, _B_LAYER = 0, 1, 3
_MAX_HEAD = 4  # head channels one op takes (kMaxHead in the .cu)
_TASK_WORDS = 9
_WTILE = 128  # weight-pass output tile
_WEIGHT_BLOCKS = 4 * 132  # weight-pass blocks to aim for: four per SM


def _round16(k: int) -> int:
    return -(-k // 16) * 16


def _tiling(cdtype) -> tuple[int, int]:
    """(rows per block, slab depth): bf16 128 x 64, f32 64 x 32 (Traits in the .cu)."""
    return (128, 64) if cdtype == torch.bfloat16 else (64, 32)


def _members_of(spec, kp):
    """(member specs, their kernel params, shared lo block?) of a spec or ensemble."""
    if isinstance(spec, EnsembleSpec):
        return list(spec.members), list(kp), True
    return [spec], [kp], False


class _Buffers:
    """The weight buffer (cdtype) and the float32 buffer of one program."""

    def __init__(self, cd: torch.dtype, device):
        self.cd, self.device = cd, device
        self.mats, self.fvals = [], []
        self.w_size = self.f_size = 0

    def mat(self, w, transpose: bool = True) -> tuple[int, int]:
        """Store w^T (N, K) [or w (K, N)] zero-padded to 16 columns: (offset, kpad)."""
        rows = w.detach().t() if transpose else w.detach()
        n, k = rows.shape
        kpad = _round16(k)
        buf = torch.zeros((n, kpad), dtype=self.cd, device=self.device)
        buf[:, :k] = rows.to(self.cd)
        off = self.w_size
        self.mats.append(buf.reshape(-1))
        self.w_size += n * kpad
        return off, kpad

    def fvec(self, v) -> int:
        v = v.detach().reshape(-1).float()
        off = self.f_size
        self.fvals.append(v)
        self.f_size += v.numel()
        return off

    def tensors(self):
        wts = torch.cat(self.mats) if self.mats else torch.zeros(8, dtype=self.cd, device=self.device)
        return wts.contiguous(), torch.cat(self.fvals).contiguous()


def _layout(members, cd, shared: bool, weighted_ns: list) -> dict:
    """Tile strides and widths of a program's header."""
    pad = 8 if cd == torch.bfloat16 else 4  # 16 bytes: conflict-free fragment reads
    _, slab_k = _tiling(cd)
    m0 = members[0]
    act_w = max(max(m.width, m.views_width if m.has_views else 0) for m in members)
    lo_kpad = _round16(m0.in_lo)
    in_hi = 0 if shared else m0.in_hi
    hi_kpad = _round16(in_hi) if in_hi else 0
    return dict(
        in_lo=m0.in_lo, in_hi=in_hi, lo_kpad=lo_kpad, hi_kpad=hi_kpad,
        act_ld=act_w + pad, lo_ld=lo_kpad + pad, hi_ld=hi_kpad + pad if hi_kpad else 0,
        slab_ld=slab_k + pad, slab_rows=max(weighted_ns), slab_k=slab_k,
    )


def _smem(cd, lay: dict, extra: int = 0) -> int:
    bm, _ = _tiling(cd)
    esize = 2 if cd == torch.bfloat16 else 4
    return extra + esize * (bm * (lay["act_ld"] + lay["lo_ld"] + lay["hi_ld"])
                            + _STAGES * lay["slab_rows"] * lay["slab_ld"])


def pack_program(spec, kp, n_rows: int):
    """Forward kernel operands: (program words int32 numpy, wts (cdtype), fpar (f32), smem bytes).

    `spec` is a FusedSpec with its kernel-param dict, or an EnsembleSpec with
    a tuple of them. Every matmul weight (K, N) is stored transposed and
    zero-padded to (N, round16(K)) in one cdtype buffer; biases and the f32
    head weights go to one float32 buffer. The program lists the layers and
    heads in execution order, member after member, with the tiles each layer
    reads (the activation tile, which it then overwrites, the lo tile, the
    hi tile); an ensemble member's extra input is the shared lo tile.
    """
    members, kps, shared = _members_of(spec, kp)
    cd = members[0].cdtype
    buf = _Buffers(cd, kps[0]["w0i"].device)
    ops = []

    def layer(segs, n, bias, flags, hvx_slot=0):
        op = [_OP_LAYER, n, buf.fvec(bias), flags, len(segs)] + [0] * 11
        for s, (src, w) in enumerate(segs):
            w_off, kpad = buf.mat(w)
            op[5 + s], op[8 + s], op[11 + s] = src, w_off, kpad
        op[15] = hvx_slot
        ops.append(op)

    def head(wt, bias, plane):
        n_out, k = wt.shape
        ops.append([_OP_HEAD, n_out, buf.fvec(bias), 0, 0, _SRC_ACT, 0, 0, buf.fvec(wt), 0, 0, k,
                    0, 0, plane, 0])

    extra_src = _SRC_LO if shared else _SRC_HI
    plane, hvx_slot = 0, 0
    for m, kp in zip(members, kps):
        layer([(_SRC_LO, kp["w0i"])], m.width, kp["b0"], _FLAG_RELU)
        for i in range(1, m.depth):
            segs = [(_SRC_ACT, kp[f"w{i}"])]
            if (i - 1) in m.skip_layers:
                segs.append((_SRC_LO, kp[f"w{i}i"]))
            layer(segs, m.width, kp[f"b{i}"], _FLAG_RELU)
        head(kp["wpo_t"], kp["bpo"], plane)
        if m.has_views:
            layer([(_SRC_ACT, kp["wf"])], m.width, kp["bf"], 0)
            segs = [(_SRC_ACT, kp["wv0f"])]
            if m.has_extra:
                segs.append((extra_src, kp["wv0i"]))
            flags = _FLAG_RELU | (_FLAG_HVX if m.has_hvx else 0)
            layer(segs, m.views_width, kp["bv0"], flags, hvx_slot)
            hvx_slot += int(m.has_hvx)
            for i in range(1, m.views_depth):
                layer([(_SRC_ACT, kp[f"wv{i}"])], m.views_width, kp[f"bv{i}"], _FLAG_RELU)
            head(kp["wvo_t"], kp["bvo"], plane + m.out_p)
        plane += m.n_planes
    if len(ops) > _MAX_OPS:
        raise ValueError(f"{len(ops)} kernel ops exceed the program's {_MAX_OPS}")

    lay = _layout(members, cd, shared, [op[1] for op in ops if op[4]])
    header = [len(ops), n_rows, members[0].ns, lay["in_lo"], lay["in_hi"], lay["lo_kpad"],
              lay["hi_kpad"], lay["act_ld"], lay["lo_ld"], lay["hi_ld"], lay["slab_ld"],
              lay["slab_rows"], lay["slab_k"]]
    words = np.asarray(header + [w for op in ops for w in op], dtype=np.int32)
    wts, fpar = buf.tensors()
    return words, wts, fpar, _smem(cd, lay)


@dataclasses.dataclass
class BwdPlan:
    """Backward kernel operands and where each gradient lands.

    header: (16,) int32; ops: (n_ops, 24) int32; tasks: (n_tasks, 9) int32.
    The stash holds `stash_cols` column slots of n_rows rows each; partials
    rows are `part_w` wide, dW partials `dw_total`. The ReLU masks take
    `mask_words` int32 words: two per thread of a tile for each of its ReLU
    layers (header[15] of them). grads[mi][key] =
    ("dw" | "part", offset, shape) into the reduced dW or partials vector.
    """

    header: np.ndarray
    ops: np.ndarray
    tasks: np.ndarray
    wts: torch.Tensor
    fpar: torch.Tensor
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


def pack_bwd_program(spec, kp, n_rows: int) -> BwdPlan:
    """Backward kernel operands for a FusedSpec + kp, or an EnsembleSpec + kps.

    The program runs each member's forward (stashing lo/hi and every layer's
    rounded activation; a ReLU layer also packs its mask as bits, and the
    layer that feeds a head forms the head's per-tile dW and db partials)
    and then its backward: per layer, from the top, the f32 cotangent g
    (head contributions added, the layer's ReLU mask bits applied),
    its per-tile column sum (db), round(g) into the stash, and the product
    round(g) @ W^T with W stored (K, round16(N)). The weight pass then forms
    every dW = A^T G from two stash slots, 128 x 128 tiles at a time.
    """
    members, kps, shared = _members_of(spec, kp)
    cd = members[0].cdtype
    bm, _ = _tiling(cd)
    buf = _Buffers(cd, kps[0]["w0i"].device)
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
        for s, (src, mat) in enumerate(f.get("segs", ())):
            w_off, kpad = buf.mat(mat, transpose=f.get("transpose", True))
            w[5 + s], w[8 + s], w[11 + s] = src, w_off, kpad
        w[4] = len(f.get("segs", ()))
        if kind == _F_IN:
            w[5] = f["src"]
        ops.append(w)

    def task(a_slot, a_w, g_slot, g_w, k_in, n_out, key, g):
        off = alloc("dw", k_in * n_out)
        g[key] = ("dw", off, (k_in, n_out))
        for i0 in range(0, k_in, _WTILE):
            for j0 in range(0, n_out, _WTILE):
                tasks.append([a_slot, a_w, g_slot, g_w, k_in, n_out, off, i0, j0])

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
    for m, kp in zip(members, kps):
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
            segs = [(_SRC_LO, kp["w0i"])] if i == 0 else [(_SRC_ACT, kp[f"w{i}"])]
            if i > 0 and (i - 1) in m.skip_layers:
                segs.append((_SRC_LO, kp[f"w{i}i"]))
            h.append(alloc("stash", W))
            hm.append(alloc("mask", 1))
            head = head_partials("wpo_t", "bpo", plane, m.out_p, W) if i == m.depth - 1 else {}
            op(_F_LAYER, segs=segs, n=W, b_off=buf.fvec(kp[f"b{i}"]), flags=_FLAG_RELU,
               out_slot=h[-1], mask_slot=hm[-1], **head)
        hv, hvm = [], []
        my_hvx = -1
        if m.has_views:
            f_slot = alloc("stash", W)
            op(_F_LAYER, segs=[(_SRC_ACT, kp["wf"])], n=W, b_off=buf.fvec(kp["bf"]), flags=0,
               out_slot=f_slot)
            for i in range(m.views_depth):
                if i == 0:
                    segs = [(_SRC_ACT, kp["wv0f"])]
                    if m.has_extra:
                        segs.append((extra[0], kp["wv0i"]))
                    flags = _FLAG_RELU
                    if m.has_hvx:
                        flags |= _FLAG_HVX
                        my_hvx = hvx_slot
                        hvx_slot += 1
                else:
                    segs, flags = [(_SRC_ACT, kp[f"wv{i}"])], _FLAG_RELU
                hv.append(alloc("stash", Wv))
                hvm.append(alloc("mask", 1))
                head = {}
                if i == m.views_depth - 1:
                    head = head_partials("wvo_t", "bvo", plane + m.out_p, m.out_v, Wv)
                op(_F_LAYER, segs=segs, n=Wv, b_off=buf.fvec(kp[f"bv{i}"]), flags=flags,
                   hvx_slot=max(my_hvx, 0), out_slot=hv[-1], mask_slot=hvm[-1], **head)

        # Backward, from the top.
        def back(gn, relu, mask_slot, b_key, zero=False, head=None, prod=None, g32=-1):
            """One B_LAYER; returns its G slot. head = (plane, n_out, wt); prod = W (K, N)."""
            g_slot, pdb = alloc("stash", gn), alloc("part", gn)
            g[b_key] = ("part", pdb, (1, gn))
            f = dict(gn=gn, flags=(_FLAG_RELU if relu else 0) | (_FLAG_ZERO if zero else 0),
                     mask_slot=mask_slot, out_slot=g_slot, part=pdb, g32_slot=g32)
            if head is not None:
                f.update(plane=head[0], head_nout=head[1], head_w_off=buf.fvec(head[2]))
            if prod is not None:
                f.update(segs=[(_SRC_ACT, prod)], transpose=False, n=prod.shape[0])
            op(_B_LAYER, **f)
            return g_slot

        if m.has_views:
            vplane = plane + m.out_p
            for i in range(m.views_depth - 1, -1, -1):
                top = i == m.views_depth - 1
                gs = back(Wv, True, hvm[i], f"bv{i}", zero=top,
                          head=(vplane, m.out_v, kp["wvo_t"]) if top else None,
                          prod=kp[f"wv{i}"] if i else kp["wv0f"],
                          g32=my_hvx if i == 0 else -1)
                if i:
                    task(hv[i - 1], Wv, gs, Wv, Wv, Wv, f"wv{i}", g)
                else:
                    task(f_slot, W, gs, Wv, W, Wv, "wv0f", g)
                    if m.has_extra:
                        task(extra[1], extra[2], gs, Wv, m.in_hi, Wv, "wv0i", g)
            gs = back(W, False, -1, "bf", prod=kp["wf"])
            task(h[-1], W, gs, W, W, W, "wf", g)
        for i in range(m.depth - 1, -1, -1):
            top = i == m.depth - 1
            gs = back(W, True, hm[i], f"b{i}", zero=top and not m.has_views,
                      head=(plane, m.out_p, kp["wpo_t"]) if top else None,
                      prod=kp[f"w{i}"] if i else None)
            if i:
                task(h[i - 1], W, gs, W, W, W, f"w{i}", g)
                if (i - 1) in m.skip_layers:
                    task(lo_slot, lo_kpad, gs, W, m.in_lo, W, f"w{i}i", g)
            else:
                task(lo_slot, lo_kpad, gs, W, m.in_lo, W, "w0i", g)
        grads.append({k: g[k] for k in m.param_keys()})
        plane += m.n_planes

    weighted = [w[1] for w in ops if w[4]]
    lay = _layout(members, cd, shared, weighted)
    header = np.asarray(
        [len(ops), n_rows, m0.ns, lay["in_lo"], lay["in_hi"], lay["lo_kpad"], lay["hi_kpad"],
         lay["act_ld"], lay["lo_ld"], lay["hi_ld"], lay["slab_ld"], lay["slab_rows"],
         lay["slab_k"], sizes["part"], hvx_w, sizes["mask"]], dtype=np.int32)
    n_chunks = max(1, min(-(-_WEIGHT_BLOCKS // max(len(tasks), 1)), -(-n_rows // 256)))
    chunk_rows = -(-(-(-n_rows // n_chunks)) // 32) * 32
    n_chunks = -(-n_rows // chunk_rows)
    wm = 4 if cd == torch.bfloat16 else 2
    wts, fpar = buf.tensors()
    return BwdPlan(
        header=header, ops=np.asarray(ops, dtype=np.int32).reshape(-1, _BOP_WORDS),
        tasks=np.asarray(tasks, dtype=np.int32).reshape(-1, _TASK_WORDS), wts=wts, fpar=fpar,
        stash_cols=sizes["stash"], part_w=sizes["part"], dw_total=sizes["dw"], n_chunks=n_chunks,
        chunk_rows=chunk_rows, hvx_w=hvx_w, n_hvx=hvx_slot,
        smem=_smem(cd, lay, extra=(wm * (256 + 1) + bm) * _MAX_HEAD * 4),
        mask_words=-(-n_rows // bm) * sizes["mask"] * (32 * wm * 4) * 2, grads=grads,
    )


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

    ops = torch.from_numpy(plan.ops).to(dev)
    tasks = torch.from_numpy(plan.tasks).to(dev)
    stash = torch.empty(plan.stash_cols * n, dtype=cd, device=dev)
    g32 = f32(max(plan.n_hvx * n * plan.hvx_w, 1))
    masks = torch.empty(max(plan.mask_words, 2), dtype=torch.int32, device=dev)
    parts, part_out = f32(n_tiles * plan.part_w), f32(plan.part_w)
    dw_part, dw_out = f32(max(plan.n_chunks * plan.dw_total, 1)), f32(max(plan.dw_total, 1))
    dhvx = f32(plan.n_hvx, n // ns, max(plan.hvx_w, 1))
    lib = build.load_library("fused_mlp_bwd")
    args = [1 if cd == torch.bfloat16 else 0, plan.header.ctypes.data_as(ctypes.c_void_p),
            int(plan.header.size), _ptr(ops), _ptr(lo)]
    args += [_ptr(hi)] if entry == "snerf_fused_mlp_bwd" else []
    args += [_ptr(hvx), _ptr(d_planes), _ptr(plan.wts), _ptr(plan.fpar), _ptr(tasks),
             len(plan.tasks), plan.n_chunks, plan.chunk_rows, plan.dw_total,
             plan.n_hvx * (n // ns), _ptr(stash), _ptr(g32), _ptr(masks), _ptr(parts),
             _ptr(part_out), _ptr(dw_part), _ptr(dw_out), _ptr(dhvx), ctypes.c_int(plan.smem),
             _stream(dev)]
    rc = getattr(lib, entry)(*args)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    return unpack_grads(plan, dw_out, part_out), dhvx


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
