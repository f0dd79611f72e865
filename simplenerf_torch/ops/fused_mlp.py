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
holds its lo/hi inputs in shared memory, and walks a program of layers
(`pack_program`) with each layer's transposed weight streaming through a
ring in shared memory that every block reads from L2. The weights are
packed as the ring's shared-memory image, copied by one producer thread
with bulk copies, and two consumer warpgroups multiply with wgmma and fold
the heads into their epilogues: bf16 in 64-deep swizzled slabs, the
activations held in registers as the next layer's A operand and the two
consumers taking turns on the tensor cores a layer at a time, so that
one's epilogue runs under the other's products (csrc/fused_mlp_sm90.cuh);
float32 on the same producer in 3xTF32 with an activation tile
in shared memory (csrc/fused_mlp_tf32_sm90.cuh: 64-row x 32-deep chunks in
a permuted K order, each split on the card into its big and small TF32
images by `tf32_split`, three TF32 products per product). The backward
(`pack_bwd_program`) stashes the rounded activations and cotangents in
device memory and computes dW in a second pass over the stash; sums over
rows are fixed-order reductions, so gradients do not change from run to
run. In bf16 its row pass runs the forward's engine forward and back, on
one program whose weight image holds every backward product's weight
beside the forward's (`_bwd_plan`), the stash leaving by TMA stores
(csrc/fused_mlp_bwd_sm90.cuh). In float32 the forward, run under
autograd, already stores the activations and the ReLU mask words
(`_stash_fwd`, the forward engine's kStash instance), so the row pass
only walks back, on the 3xTF32 core with its stash stored from registers
(csrc/fused_mlp_bwd_tf32_sm90.cuh); a backward called directly launches
that forward first. The bf16 weight pass is bound by the
stash bytes it reads, and reads whole dW panels through TMA boxes into
wgmma, the two panels of a dW in one cluster (`_wgrad_plan`,
csrc/fused_mlp_wgrad_sm90.cuh); the float32 one runs 128 x 128 tiles of
plain FMAs. Both programs come from one list of a member's layers
(`_layers`): the forward's walks it forward, the row pass's forward (bf16)
and then back.

Secondary views (ViP-NeRF's visibility prior; no TPU kernel: the JAX
package evaluates them unfused): `fused_apply(..., sec=(pe2, wdir))`
evaluates the views branch again at each point for k other cameras'
directions, the head's visibility channel only, and returns those k raw
planes after the head planes. In bf16 on the card its forward kernel's hvx
layer also stores its products and bias (`pre`), from which
csrc/fused_mlp_sec.cu computes the pairs (`secondary_fwd`); the backward
runs that file's backward (`secondary_bwd`), whose per-point cotangent the
row pass adds to the hvx layer's g after dhvx's share is taken. Without
`sec` both kernels run their plain instances, as before.

Each wrapper takes the plain version for CPU tensors and launches its
kernel (or raises) for CUDA tensors, and counts its launches:
`fused_apply.launches`, `fused_bwd.launches`,
`fused_apply_ensemble.launches`, `fused_ens_bwd.launches` (and, for the
weight pass and the column sums alone, `wgrad.launches` and
`column_sums.launches`, and `tf32_split.launches`, the float32 weight
images' split, which every float32 launch makes; all of them:
`launch_counts`, with `fused_bwd.own_forward` and
`fused_ens_bwd.own_forward`, the float32 backward calls that launched
their own forward). `pe_operands` builds the kernels' positional-encoding
operands lo and hi in one pass (csrc/field_pe.cu, replacing no TPU kernel;
`pe_operands.launches`, one a fused field call; `secondary_fwd.launches`,
`secondary_bwd.launches`). Under autograd
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
        """The backward's row pass: the forward again and dX (its dW is the
        weight pass's; the float32 row pass reads the forward's stash in
        place of the forward)."""
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


def _views_pre(spec: FusedSpec, kp: dict, f, hi):
    """The first views layer's products and bias, before hvx: (N, Wv) in
    the accumulation type (what the forward kernel stores as `pre` for the
    secondary views)."""
    acc = _mm(f, kp["wv0f"], spec) + kp["bv0"]
    if spec.has_extra:
        acc = acc + _mm(hi, kp["wv0i"], spec)
    return acc


def _views_forward(spec: FusedSpec, kp: dict, h, hi, hvx):
    """Views branch: (feature, [hv_0, ...]); hvx (nr, Wv) per ray or None."""
    f = (_mm(h, kp["wf"], spec) + kp["bf"]).to(spec.cdtype)
    acc = _views_pre(spec, kp, f, hi)
    if hvx is not None:
        acc = acc + hvx.to(spec.acc_dtype).repeat_interleave(spec.ns, dim=0)
    hvs = [torch.relu(acc).to(spec.cdtype)]
    for i in range(1, spec.views_depth):
        hvs.append(torch.relu(_mm(hvs[-1], kp[f"wv{i}"], spec) + kp[f"bv{i}"]).to(spec.cdtype))
    return f, hvs


def fused_apply_reference(spec: FusedSpec, kp: dict, lo, hi, hvx, sec=None) -> tuple:
    """The forward kernel's function in plain PyTorch (same roundings, f32
    heads); with `sec` = (pe2, wdir), the secondary views' k planes after
    the head planes (`secondary_reference`)."""
    hs = _trunk_forward(spec, kp, lo, keep=False)
    planes = _head_planes(spec, hs[-1], kp["wpo_t"], kp["bpo"], spec.out_p)
    if spec.has_views:
        f, hvs = _views_forward(spec, kp, hs[-1], hi, hvx)
        planes += _head_planes(spec, hvs[-1], kp["wvo_t"], kp["bvo"], spec.out_v)
        if sec is not None:
            planes += list(secondary_reference(spec, kp, _views_pre(spec, kp, f, hi), *sec))
    return tuple(planes)


def _sec_head(spec: FusedSpec, kp: dict) -> tuple:
    """(w_vis (Wv,), b_vis ()): the views head's last channel, the visibility
    the secondary views read, in the accumulation type."""
    c = spec.out_v - 1
    return kp["wvo_t"][c].to(spec.acc_dtype), kp["bvo"][0, c].to(spec.acc_dtype)


def _sec_act(spec: FusedSpec, pre, pe2, wdir):
    """The secondary pairs' views-layer pre-activations ((N k), Wv): pre_i +
    pe_ij @ wdir, both operands of the product rounded to the compute type."""
    k = pe2.shape[0] // max(pre.shape[0], 1)
    return pre.to(spec.acc_dtype).repeat_interleave(k, dim=0) + _mm(pe2, wdir, spec)


def secondary_reference(spec: FusedSpec, kp: dict, pre, pe2, wdir) -> torch.Tensor:
    """The secondary-view kernel's function: (k, nr, ns) raw visibility planes.

    pre (N, Wv): the first views layer's products and bias without hvx
    (`_views_pre`); pe2 ((N k), 3+6dv) cdtype: the blocked PE of each
    point's k secondary directions, rows point-major; wdir (3+6dv, Wv): the
    first views layer's dirs rows (`dirs_w`). v_ij = sum_c
    round(relu(pre_ij))[c] w_vis[c] + b_vis with the views head's last
    channel (`_sec_head`): the one channel the prior reads.
    """
    n = pre.shape[0]
    h = torch.relu(_sec_act(spec, pre, pe2, wdir)).to(spec.cdtype).to(spec.acc_dtype)
    w_vis, b_vis = _sec_head(spec, kp)
    v = (h * w_vis).sum(-1) + b_vis
    return v.reshape(n, -1).T.reshape(-1, n // spec.ns, spec.ns)


def secondary_bwd_reference(spec: FusedSpec, kp: dict, pre, pe2, wdir, d_sec) -> tuple:
    """The secondary-view backward kernel's function from the planes'
    cotangents d_sec (k, nr, ns): (sec (N, Wv), dwdir, dw_vis (Wv,), db_vis).

    sec_i = sum_j dv_ij w_vis [pre_ij > 0], the views layer's cotangent the
    row pass adds to its g; dwdir = pe2^T dpre with dpre rounded to the
    compute type, as every dW product rounds its operands; dw_vis, db_vis
    the head row's; float32 sums.
    """
    n = pre.shape[0]
    act = _sec_act(spec, pre, pe2, wdir)
    h = torch.relu(act).to(spec.cdtype).to(spec.acc_dtype)
    w_vis, _ = _sec_head(spec, kp)
    dv = d_sec.to(spec.acc_dtype).reshape(-1, n).T.reshape(-1, 1)
    dpre = dv * w_vis * (act > 0).to(spec.acc_dtype)
    sec = dpre.reshape(n, -1, dpre.shape[-1]).sum(1)
    dwdir = _mm_tn(pe2, dpre, spec)
    return sec, dwdir, (h * dv).sum(0), dv.sum()


def fused_bwd_reference(spec: FusedSpec, kp: dict, lo, hi, hvx, d_planes, sec=None):
    """The backward kernel's function in plain PyTorch: (dkp, dhvx), and
    with `sec` = (pe2, wdir) (dkp, dhvx, dwdir).

    A transcription of the TPU `_bwd_kernel` over all rows at once (not
    autograd through `fused_apply_reference`, which would round in other
    places): every product rounds both operands to the compute dtype and
    accumulates in f32, the ReLU mask is taken on the stored activation,
    head gradients and every db are f32 sums. dkp holds f32 gradients of
    every kernel parameter; dhvx (nr, Wv) is the per-ray sum of the f32
    views-layer-0 cotangent (None without hvx). d_planes: (n_planes, nr, ns)
    or a sequence of (nr, ns) tensors, None for a plane no loss reads; with
    `sec`, the k secondary planes' cotangents follow: their share
    (`secondary_bwd_reference`) joins that cotangent after dhvx is taken,
    and the head's visibility row.
    """
    nr = lo.shape[0] // spec.ns
    ref = torch.empty((nr, spec.ns), device=lo.device, dtype=spec.acc_dtype)
    k = 0 if sec is None else sec[0].shape[0] // max(lo.shape[0], 1)
    dps = _cotangent_list(spec.n_planes + k, d_planes, ref)
    dps, d_sec = dps[: spec.n_planes], dps[spec.n_planes :]
    grads: dict = {}
    dwdir = None

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
        if sec is not None:
            pre = _views_pre(spec, kp, f, hi)
            sg, dwdir, dw_vis, db_vis = secondary_bwd_reference(spec, kp, pre, *sec, torch.stack(d_sec))
            g = g + sg
            last = torch.zeros((spec.out_v, 1), dtype=spec.acc_dtype, device=lo.device)
            last[-1] = 1.0  # the views head's last channel, the visibility
            grads["wvo_t"] = grads["wvo_t"] + last * dw_vis
            grads["bvo"] = grads["bvo"] + last.T * db_vis
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
    dkp = {key: grads[key] for key in spec.param_keys()}
    return (dkp, dhvx) if sec is None else (dkp, dhvx, dwdir)


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
_FLAG_RELU, _FLAG_HVX = 1, 2
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block can use
_F_IN, _F_LAYER, _H_LAYER, _B_LAYER = 0, 1, 2, 3  # the row pass's op kinds (bwd90::Op)
_MAX_HEAD = 4  # head channels one op takes (kMaxHead in the .cu)
# bf16 weight pass: struct wgrad::Job and the constants of fused_mlp_wgrad_sm90.cuh.
_JOB_WORDS = 9
_WGRAD_MAX_MAPS = 128  # tensor maps the kernel's parameter holds (kMaxMaps)
_WBOX = 64  # rows and columns of one TMA box
_WBOX_BYTES = _WBOX * _WBOX * 2
_WGRAD_STAGES = 4
_WGRAD_SMEM = _WGRAD_STAGES * 6 * _WBOX_BYTES + 2 * _WGRAD_STAGES * 8  # two A and four G boxes
# float32 weight pass (csrc/fused_mlp_wgrad_tf32_sm90.cuh, struct
# wgrad32::Job): jobs of up to 128 dW rows by 128 columns, stages of 32
# stash rows, A boxes of 32 columns (4 KB), G boxes of 64 columns of a
# K-major slot (8 KB); a stage holds four A and two G boxes, and two small
# images of two G boxes sit beside the ring.
_JOB32_WORDS = 10
_WGRAD32_DEPTH = 32
_WGRAD32_ABOX = 32
_WGRAD32_GBOX = 64
_WGRAD32_STAGES = 5
_WGRAD32_STAGE = 4 * _WGRAD32_DEPTH * _WGRAD32_ABOX * 4 + 2 * _WGRAD32_DEPTH * _WGRAD32_GBOX * 4
_WGRAD32_SMEM = (_WGRAD32_STAGES * _WGRAD32_STAGE + 2 * 2 * _WGRAD32_DEPTH * _WGRAD32_GBOX * 4
                 + 2 * _WGRAD32_STAGES * 8)
_WGRAD32_THREADS = 288  # two consumer warpgroups and the producer warp
_WGRAD32_MAP = 7  # int64 host parameters of one float32 tensor map (kMapWords)
_STASH_LD_ALIGN = 8  # a float32 stash slot's rows: n_rows rounded up to this (tf32::stash_ld)
_SMS = 132  # streaming multiprocessors of an H100 SXM; the bf16 weight pass runs one CTA on each
_WGRAD_WAVES = (2, 4)  # the weight pass's grid: this many waves of _SMS CTAs, at least and at most
_WGRAD32_WAVES = (2, 6)  # the float32 pass's: its jobs are longer, so a last wave's gap costs more
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


def _stash_ld(n_rows: int, f32: bool = True) -> int:
    """Rows a stash slot is given: n_rows in bf16; in float32 n_rows
    rounded up to 8, so that every slot, and every column of a K-major slot
    (the G slots, which the float32 weight pass reads as wgmma's K-major B),
    starts 32-byte aligned: TMA needs 16, and the row pass's K-major stores
    fill whole 32-byte sectors (csrc/fused_mlp_bwd_tf32_sm90.cuh
    `stash_ld`). Slot s starts at element s * ld."""
    return -(-n_rows // _STASH_LD_ALIGN) * _STASH_LD_ALIGN if f32 else n_rows


def _tiling(cdtype) -> tuple[int, int]:
    """(rows per block, K depth of a weight slab or chunk): bf16 128 x 64,
    float32 128 x 32; a 64-row consumer's K block is 8 KB in both."""
    return (128, 64) if cdtype == torch.bfloat16 else (128, _TF32_DEPTH)


def _members_of(spec, kp):
    """(member specs, their kernel params) of a spec or ensemble."""
    if isinstance(spec, EnsembleSpec):
        return list(spec.members), list(kp)
    return [spec], [kp]


@dataclasses.dataclass(frozen=True)
class _Layer:
    """One layer of a member's forward, as both programs run it: its
    segments ((source, key), ...; the activation segment first), n outputs,
    bias key and flags, the hvx slot it adds (with _FLAG_HVX), and the head
    it feeds: (weight key, bias key, plane, channels) or None."""

    mi: int
    segs: tuple
    n: int
    bias: str
    flags: int
    hvx_slot: int = 0
    head: Optional[tuple] = None


def _layers(spec) -> list:
    """Every member's forward layers in execution order, member after
    member: the trunk with its skip joins (the points head on its last
    layer), the feature layer, the views layers (hvx on the first, the
    views head on the last). An ensemble member's extra input is the shared
    lo tile. Each layer's activation feeds the next layer of its member."""
    members = list(spec.members) if isinstance(spec, EnsembleSpec) else [spec]
    extra = _SRC_LO if isinstance(spec, EnsembleSpec) else _SRC_HI
    out, plane, hvx_slot = [], 0, 0

    def head(wkey, bkey, pl, n_out):
        if n_out > _MAX_HEAD:
            raise ValueError(f"a head of {n_out} channels; the kernel takes {_MAX_HEAD}")
        return wkey, bkey, pl, n_out

    for mi, m in enumerate(members):
        if m.has_views and m.views_depth < 1:
            raise ValueError("a views head needs at least one views layer")
        for i in range(m.depth):
            segs = ((_SRC_LO, "w0i"),) if i == 0 else ((_SRC_ACT, f"w{i}"),)
            if i and (i - 1) in m.skip_layers:
                segs += ((_SRC_LO, f"w{i}i"),)
            top = head("wpo_t", "bpo", plane, m.out_p) if i == m.depth - 1 else None
            out.append(_Layer(mi, segs, m.width, f"b{i}", _FLAG_RELU, head=top))
        if m.has_views:
            out.append(_Layer(mi, ((_SRC_ACT, "wf"),), m.width, "bf", 0))
            for i in range(m.views_depth):
                segs = ((_SRC_ACT, f"wv{i}"),) if i else ((_SRC_ACT, "wv0f"),)
                if i == 0 and m.has_extra:
                    segs += ((extra, "wv0i"),)
                hvx = i == 0 and m.has_hvx
                last = i == m.views_depth - 1
                top = head("wvo_t", "bvo", plane + m.out_p, m.out_v) if last else None
                flags = _FLAG_RELU | (_FLAG_HVX if hvx else 0)
                out.append(_Layer(mi, segs, m.views_width, f"bv{i}", flags, hvx_slot * hvx, top))
                hvx_slot += hvx
        plane += m.n_planes
    return out


class _Sources:
    """The kernel parameters a program's buffer gathers from, (member, key)
    at each use: their flattened values concatenated, with one zero after
    them at `size`."""

    def __init__(self, shapes):
        self.shapes, self.keys, self.size = shapes, [], 0

    def __call__(self, mi: int, key: str) -> int:
        """Member mi's parameter `key` once more: its offset."""
        k, n = self.shapes[mi][key]
        self.keys.append((mi, key))
        self.size += k * n
        return self.size - k * n


def pack_program(spec, kp, n_rows: int):
    """Forward kernel operands: (program words int32 numpy, wts, fpar (f32), smem bytes).

    `spec` is a FusedSpec with its kernel-param dict, or an EnsembleSpec with
    a tuple of them. The program (`sm90_plan`) lists the layers in execution
    order (`_layers`), with the operands each layer reads (the last layer's
    activations, which it then replaces, the lo tile, the hi tile). wts: the
    bf16 slab image, or the float32 chunk image's split (`tf32_split`).
    """
    _, kps = _members_of(spec, kp)
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
_SM90_STAGES = (4, 3, 2)  # float32 ring depths (kMaxStages), the deepest that fits first
_SM90_STAGES_BF16 = (6, 5, 4, 3, 2)  # bf16 (kMaxStagesBf16): no activation tiles beside the ring
_SM90_BARRIERS = 9 * 8  # full and empty per float32 stage (4 + 4) and the heads' mbarrier
_SM90_BARRIERS_BF16 = 13 * 8  # the same for the bf16 ring (6 + 6 + 1)
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
    shapes = [_sm90_shapes(m) for m in members]
    ws, fs = _Sources(shapes), _Sources(shapes)
    w_parts, ops = [], []
    heads, biases, head_biases = [], [], []  # (layer, source base, sizes...) of each
    for layer in _layers(spec):
        mi, n, flags = layer.mi, layer.n, layer.flags
        n_pad = _n_pad(n)
        op = [n, n_pad, 0, flags, len(layer.segs), 0, 0, 0, 0, 0, 0, layer.hvx_slot, 0, 0, 0, 0]
        for s, (src, key) in enumerate(layer.segs):
            k, nn = shapes[mi][key]
            w_parts.append(_slab_index(k, nn, n_pad, ws(mi, key), f32=f32))
            op[5 + s], op[8 + s] = src, _kblocks(k, depth)
        biases.append((len(ops), fs(mi, layer.bias), n, n_pad))
        if layer.head:
            wkey, bkey, plane, n_out = layer.head
            op[12], op[13] = plane, n_out
            heads.append((len(ops), fs(mi, wkey), n_out, n, n_pad))
            head_biases.append((len(ops), fs(mi, bkey), n_out))
        ops.append(op)
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
    w_index[w_index < 0] = ws.size  # the zero after the weights
    f_index[f_index < 0] = fs.size

    in_hi = 0 if shared else m0.in_hi
    lo_kb, hi_kb = _kblocks(m0.in_lo, depth), _kblocks(in_hi, depth)
    # float32 keeps a consumer's activations in a shared-memory tile; bf16
    # in registers (the next layer's wgmma A fragments), so a deeper ring.
    act_kb = max(op[1] for op in ops) // depth if f32 else 0
    depths, barriers = (_SM90_STAGES, _SM90_BARRIERS) if f32 else (_SM90_STAGES_BF16, _SM90_BARRIERS_BF16)
    slot = _TF32_SLOT if f32 else max(op[1] for op in ops) * 128
    hvx_w = max((m.views_width for m in members if m.has_hvx), default=0)
    hvx_rays = 63 // m0.ns + 2 if hvx_w else 0  # rays that 64 consecutive rows can touch

    def smem(stages, rays):
        return (stages * slot + 2 * (act_kb + lo_kb + hi_kb) * _SM90_KBLOCK
                + -(-head_floats * 4 // 16) * 16 + 2 * 4 * (_SM90_BIAS + rays * hvx_w)
                + barriers)

    # The deepest ring first, then hvx rows staged in shared memory if they
    # fit (float32 with a hi tile at the published widths: two 16 KB slots).
    # bf16: consumer 0 reads a layer's slabs before consumer 1 (their
    # turns), so the ring holds the largest layer's slabs, or the turn is
    # handed on after `hand` = stages of them (a skip join wider than the
    # ring: FreeNeRF's 99-wide lo, 4 + 2 slabs beside two 16 KB lo tiles).
    least = 0 if f32 else max(sum(op[8:11]) for op in ops)
    fits = [(s, r) for s in depths for r in (hvx_rays, 0) if smem(s, r) <= _SMEM_LIMIT]
    if not fits:
        layer = f" (a layer of {least} weight slabs)" if least else ""
        raise ValueError(f"a block of {smem(depths[-1], 0)} B of shared memory{layer}; a Hopper "
                         f"block has {_SMEM_LIMIT}")
    stages, rays = next(((s, r) for s, r in fits if s >= least), fits[0])
    hand = stages if stages < least else 0
    header = [len(ops), 0, m0.ns, m0.in_lo, in_hi, lo_kb, hi_kb, act_kb, slot, stages,
              head_floats, rays, _SM90_BIAS + rays * hvx_w, hand]
    words = np.asarray(header + [w for op in ops for w in op], dtype=np.int32)
    words.setflags(write=False)
    return Sm90Plan(words=words, w_src=tuple(ws.keys), w_index=w_index, f_src=tuple(fs.keys),
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

    words: the row pass's program (struct bwd90::Program, n_rows left 0;
    `_bwd_plan`); wts / fpar: its weight image (bf16: every forward op's
    W^T and every backward product's W, (out rows, depth), in 64-deep slabs
    of n_pad rows; float32: the backward products' W, the split of the
    32-deep chunks of `_slab_index`) and its float32 buffer (each forward
    op's bias padded to n_pad, each backward op's head weights [q][n_pad]).
    They are gathered per call by w_index / f_index from the kernel
    parameters that w_src / f_src name ((member, key) each, `_gather`); the
    rest depends on the spec and the row count only and is cached
    (`_bwd_on`), with dev_tasks on the device. row_maps: (stash slot,
    width) of each op whose slot the weight pass reads, in op order (the
    op's `map`; bf16: the row pass's tensor maps; the other ops store no
    stash). tasks: the weight pass's work, (n_jobs, 9) int32 jobs, float32
    (n_jobs, 10) (`_wgrad_plan`). The stash holds `stash_cols` column
    slots of `stash_ld` rows each (n_rows; float32: n_rows rounded up to 8,
    `_stash_ld`; slot s at element s * stash_ld), in float32 the backward
    ops' only: the training forward stores lo (hi) and every layer's
    activation in `act_cols` slots of its own buffer, and the mask words,
    as `fwd_words` (struct tf32::Stash) lays them out. Partials rows are
    `part_w` wide, dW partials `dw_total`. The ReLU masks take
    `mask_words` int32 words: four per consumer thread of a tile for each
    of its ReLU layers (the program's n_masks). grads[mi][key] = ("dw" | "part",
    offset, shape) into the reduced dW or partials vector. `maps` are the
    weight pass's tensor maps (bf16 (n_maps, 4), float32 (n_maps, 7)
    int64) and `wgrad_bytes` the stash bytes its producers issue
    (`WgradPlan`). dws: every dW as (a_slot, a_w, g_slot, g_w, k_in,
    n_out, dw_off). `slices`: the three column sums' slices (partials, dW
    partials, dhvx; `_colsum_slices`), `scratch` the floats their slice
    sums take.
    """

    words: np.ndarray
    row_maps: tuple
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
    w_index: np.ndarray
    f_src: tuple
    f_index: np.ndarray
    stash_ld: int = 0
    act_cols: int = 0
    fwd_words: Optional[np.ndarray] = None
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
    """The weight pass's work (struct wgrad::Job in
    csrc/fused_mlp_wgrad_sm90.cuh, float32 wgrad32::Job in
    fused_mlp_wgrad_tf32_sm90.cuh), for stash slots of n_rows rows.

    jobs: (n_jobs, 9) int32 (float32: (n_jobs, 10), with the first G box
    g0 before n_g), one CTA each, clusters of two consecutive jobs; maps:
    one per slot read, int64 tensor-map parameters. bf16:
    (n_maps, 4), (element offset of the slot in the stash, width, n_rows,
    row stride in bytes), boxes of 64 x 64. float32
    (csrc/fused_mlp_wgrad_tf32_sm90.cuh): (n_maps, 7), (element offset,
    dim 0, dim 1, dim 1's stride in bytes, box 0, box 1, buffer): an A slot
    row-major (width, n_rows) in 32 x 32 boxes of buffer 0 (the backward's:
    the training forward's activation stash), a G slot K-major (n_rows,
    width), 32 rows x 64 columns, of buffer 1 (the row pass's stash); slot
    s at s * `_stash_ld(n_rows)` of its buffer. Each
    chunk of `chunk_rows` rows (a multiple of 64) writes one dW partials
    row. `issued`: the stash bytes the producers ask for (a box's rows and
    columns past the slot left out: the copy engine reads none of them).
    """

    jobs: np.ndarray
    maps: np.ndarray
    n_chunks: int
    chunk_rows: int
    issued: int


def _wgrad_chunks(n_rows: int, per_chunk: int, waves=_WGRAD_WAVES) -> tuple[int, int]:
    """(n_chunks, chunk_rows): rows split into chunks of a multiple of 64
    rows, so that the grid (per_chunk CTAs a chunk, one CTA a SM) is
    `waves` waves of _SMS CTAs, at least and at most: the fewest chunks
    whose last wave is at least _WGRAD_FULL full, else the fullest last
    wave. More chunks than needed only add dW partials to write and sum."""
    best = None
    lo, hi = (-(-w * _SMS // max(per_chunk, 1)) for w in waves)
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


def _wgrad_plan(dws, n_rows: int, f32: bool = False) -> WgradPlan:
    """The weight pass for dW = A[:, :k_in]^T G[:, :n_out] of every
    (a_slot, a_w, g_slot, g_w, k_in, n_out, dw_off) in `dws`, with A and G
    stash slots (column offsets and widths; bf16: a slot is an (n_rows,
    width) array at stash + slot * n_rows; float32: A slots so at acts +
    slot * ld, G slots K-major (width, n_rows) with rows ld apart at stash
    + slot * ld, ld = `_stash_ld(n_rows)`; the two buffers may be one).

    A dW is cut into panels of 128 rows (two consumers of 64: bf16 one A
    box of 64 columns each, float32 two of 32; a panel of <= 64 rows gives
    both consumers its A boxes and half of G's boxes), each a CTA that loads
    all of its boxes. In float32 a panel is also cut into halves of 128
    columns (two G boxes; a consumer's 64 x 128 float32 sums, its partial
    sum and its A fragments fit the 168 registers ptxas gives a thread). The
    kernel runs consecutive jobs (2i, 2i + 1) as a cluster of two, which
    starts them together: the two panels of a dW of more than 128 rows on
    one chunk are such a pair (they read the same G, and the second read
    finds it in L2), and in float32 otherwise the two halves of a panel
    (the same A); every other job is paired with the next one.
    """
    maps, map_of = [], {}
    ld = _stash_ld(n_rows, f32)
    a_box = _WGRAD32_ABOX if f32 else _WBOX

    def map_index(slot, width, g):
        key = (slot, g and f32)  # float32 reads a G slot K-major, by a map of its own
        if key not in map_of:
            map_of[key] = len(maps)
            if not f32:
                maps.append([slot * n_rows, width, n_rows, width * 2])
            elif g:
                maps.append([slot * ld, n_rows, width, ld * 4, _WGRAD32_DEPTH, _WGRAD32_GBOX, 1])
            else:
                maps.append([slot * ld, width, n_rows, width * 4, _WGRAD32_ABOX, _WGRAD32_DEPTH, 0])
        return map_of[key]

    pairs, singles = [], []  # job words without the chunk; pairs: two jobs of one dW each
    for a_slot, a_w, g_slot, g_w, k_in, n_out, off in dws:
        a_map, g_map = map_index(a_slot, a_w, False), map_index(g_slot, g_w, True)
        n_gbox = -(-n_out // _WBOX)
        halves = [(g0, min(2, n_gbox - g0)) for g0 in range(0, n_gbox, 2)] if f32 else [(0, n_gbox)]
        panels = [[a_map, i0, min(128 // a_box, -(-(k_in - i0) // a_box)), g_map]
                  + ([g0] if f32 else []) + [n_g, off, k_in, n_out]
                  for g0, n_g in halves for i0 in range(0, k_in, 2 * _WBOX)]
        (pairs if len(panels) % 2 == 0 else singles).extend(panels)  # pairs share G, else A
    if len(maps) > _WGRAD_MAX_MAPS:
        raise ValueError(f"the weight pass reads {len(maps)} stash slots; its kernel takes at most "
                         f"{_WGRAD_MAX_MAPS} tensor maps")
    n_chunks, chunk_rows = _wgrad_chunks(n_rows, len(pairs) + len(singles),
                                         _WGRAD32_WAVES if f32 else _WGRAD_WAVES)
    jobs, pending = [], []
    for c in range(n_chunks):
        jobs += [[c] + w for w in pairs]  # an even count: each pair is one cluster
        for w in singles:
            pending.append([c] + w)
            if len(pending) == 2:
                jobs += pending
                pending = []
    jobs += pending
    jobs = np.asarray(jobs, dtype=np.int32).reshape(-1, _JOB32_WORDS if f32 else _JOB_WORDS)
    maps = np.asarray(maps, dtype=np.int64).reshape(-1, _WGRAD32_MAP if f32 else 4)
    return WgradPlan(jobs=jobs, maps=maps, n_chunks=n_chunks, chunk_rows=chunk_rows,
                     issued=_wgrad_issued(jobs, maps, n_rows, chunk_rows, f32))


def _wgrad_issued(jobs: np.ndarray, maps: np.ndarray, n_rows: int, chunk_rows: int,
                  f32: bool = False) -> int:
    """Stash bytes the jobs' producers issue, as `produce` in
    csrc/fused_mlp_wgrad_sm90.cuh (float32: fused_mlp_wgrad_tf32_sm90.cuh)
    asks for them: each CTA its A boxes and all of G's. Only a box's part
    inside the slot counts."""
    a_box, esize = (_WGRAD32_ABOX, 4) if f32 else (_WBOX, 2)
    total = 0
    for job in jobs.tolist():
        chunk, a_map, i0, n_a, g_map = job[:5]
        g0, n_g = job[5:7] if f32 else (0, job[5])
        rows = min(n_rows, (chunk + 1) * chunk_rows) - chunk * chunk_rows
        a_w, g_w = int(maps[a_map][1]), int(maps[g_map][2 if f32 else 1])
        cols = ([min(a_box, a_w - i0 - b * a_box) for b in range(n_a)]
                + [min(_WBOX, g_w - (g0 + b) * _WBOX) for b in range(n_g)])
        total += sum(rows * max(0, c) * esize for c in cols)
    return total


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
    members, kps = _members_of(spec, kp)
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
    plan = _bwd_plan(spec, n_rows)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return plan, *(up(a.astype(np.int32)) for a in (plan.w_index, plan.f_index, plan.tasks))


# The row pass: struct bwd90::Program / bwd90::Op in
# csrc/fused_mlp_bwd_sm90.cuh (the float32 row pass reads the same program).
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


def _bwd_plan(spec, n_rows: int) -> BwdPlan:
    """The backward's plan of a FusedSpec or EnsembleSpec at n_rows, without
    wts / fpar; in float32 the 3xTF32 row pass's (K blocks and slabs 32
    deep, 16 KB slots of a chunk's two images; it has no tensor maps, and
    stores the slots of `row_maps` only).

    The bf16 row pass's program stashes lo (and hi), then runs each
    member's layers (`_layers`) forward, stashing every layer's rounded
    activation (a ReLU layer also packs its mask as bits, and the layer
    that feeds a head forms the head's per-tile dW and db partials), and
    then in reverse: per layer the f32 cotangent g = round(g_above) @ W^T,
    W the activation segment of the layer above (zeros at the member's last
    layer), head contributions added, the layer's ReLU mask bits applied,
    its per-tile column sum (db), and round(g) into the stash. The float32
    program runs no forward op: its forward ran under autograd and stored
    lo (hi), every layer's activation and the mask bits (`fwd_words`,
    `_stash_fwd`), so each member's program is a head op per head (its
    partials from the stored activation) and then the layers in reverse.
    The weight pass then forms every dW = A^T G from two stash slots in the
    panels of `_wgrad_plan`. The column sums' slices follow
    `_colsum_slices`.
    """
    members = list(spec.members) if isinstance(spec, EnsembleSpec) else [spec]
    shared = isinstance(spec, EnsembleSpec)
    m0, cd = members[0], members[0].cdtype
    f32 = cd != torch.bfloat16
    bm, depth = _tiling(cd)
    hvx_w = max((m.views_width for m in members if m.has_hvx), default=0)
    if any(m.has_hvx and m.views_width != hvx_w for m in members):
        raise ValueError("the ensemble's hvx members must share one views width")
    shapes = [_sm90_shapes(m) for m in members]
    ws, fs = _Sources(shapes), _Sources(shapes)
    layers = _layers(spec)
    ops, w_parts, f_parts, tasks, grads = [], [], [], [], []
    sizes = dict.fromkeys(("stash", "act", "part", "dw", "mask", "fpar"), 0)
    stored = []  # float32: (activation slot, mask slot) of each forward layer, as the forward stores them

    def alloc(kind, n):
        sizes[kind] += n
        return sizes[kind] - n

    def fvec(idx):
        """Entries of the float32 buffer: their offset."""
        f_parts.append(idx)
        return alloc("fpar", idx.size)

    def slabs(mi, key, back=False):
        """W's image (a backward product reads W (K, N) as its transpose):
        its K blocks."""
        k, n = shapes[mi][key]
        k, n, strides = (n, k, (1, n)) if back else (k, n, (n, 1))
        w_parts.append(_slab_index(k, n, _n_pad(n), ws(mi, key), strides, f32))
        return _kblocks(k, depth)

    def op(kind, n, segs=(), **f):
        """One op of n columns whose products read `segs` ((src, K blocks)
        each), stashed in a new slot unless `f` names its slot: that slot."""
        src, kb = zip(*segs, *[(0, 0)] * (_BWD90_MAX_SEG - len(segs)))
        w = dict.fromkeys(_BWD90_OP, 0)
        w.update(kind=kind, n=n, n_pad=0 if kind == _F_IN else _n_pad(n), nseg=len(segs),
                 src=list(src), kb=list(kb), g32_slot=-1)
        if "out_slot" not in f:
            w["out_slot"] = alloc("stash", n)
        w.update(f)
        ops.append(w)
        return w["out_slot"]

    inputs = {}  # source -> (stash slot, width); float32: of the activation stash
    for src, width in ((_SRC_LO, m0.in_lo), (_SRC_HI, 0 if shared else m0.in_hi)):
        if width:
            kpad = _round16(width)
            slot = (alloc("act", kpad) if f32 else
                    op(_F_IN, kpad, src=[src] + [0] * (_BWD90_MAX_SEG - 1)))
            inputs[src] = (slot, kpad)

    for mi, m in enumerate(members):
        mine, g, fwd = [x for x in layers if x.mi == mi], {}, []  # fwd: (slot, mask) of each
        for layer in mine:
            n, f = layer.n, {}
            if layer.head:
                wkey, bkey, plane, n_out = layer.head
                pw, pb = alloc("part", n_out * n), alloc("part", n_out)
                g[wkey], g[bkey] = ("part", pw, (n_out, n)), ("part", pb, (1, n_out))
                f = dict(plane=plane, head_nout=n_out, part=pw, part2=pb)
            mask = alloc("mask", 1) if layer.flags & _FLAG_RELU else 0
            if f32:  # every activation is read: the next layer's dW or its head's partials
                slot = alloc("act", n)
                stored.append((slot, mask))
            else:
                c = np.arange(_n_pad(n))
                slot = op(_F_LAYER, n, [(src, slabs(mi, key)) for src, key in layer.segs],
                          b_off=fvec(np.where(c < n, fs(mi, layer.bias) + c, -1)), flags=layer.flags,
                          hvx_slot=layer.hvx_slot, mask_slot=mask, **f)
            fwd.append((slot, mask, f))
        if f32:  # the heads' partials from the stored activations, before the walk back
            for (slot, _, f), layer in zip(fwd, mine):
                if f:
                    op(_H_LAYER, layer.n, out_slot=slot, **f)
        for i in range(len(mine) - 1, -1, -1):
            layer, n, f = mine[i], mine[i].n, {}
            segs = []
            if i + 1 < len(mine):  # round(g_above) @ W^T, W the activation segment above
                segs = [(_SRC_ACT, slabs(mi, mine[i + 1].segs[0][1], back=True))]
            if layer.head:
                wkey, _, plane, n_out = layer.head
                c, base = np.arange(_n_pad(n)), fs(mi, wkey)
                f = dict(plane=plane, head_nout=n_out, head_w=fvec(np.concatenate(
                    [np.where(c < n, base + q * n + c, -1) for q in range(n_out)])))
            part = alloc("part", n)
            g[layer.bias] = ("part", part, (1, n))
            g_slot = op(_B_LAYER, n, segs, flags=layer.flags & _FLAG_RELU, mask_slot=fwd[i][1],
                        part=part, g32_slot=layer.hvx_slot if layer.flags & _FLAG_HVX else -1, **f)
            for src, key in layer.segs:
                a_slot, a_w = (fwd[i - 1][0], mine[i - 1].n) if src == _SRC_ACT else inputs[src]
                k_in = shapes[mi][key][0]
                off = alloc("dw", k_in * n)
                g[key] = ("dw", off, (k_in, n))
                tasks.append([a_slot, a_w, g_slot, n, k_in, n, off])
        grads.append({k: g[k] for k in m.param_keys()})

    # the row pass stores the slots the weight pass reads, and no others (float32:
    # its G slots; the forward stores the A slots)
    read = {t[2] for t in tasks} if f32 else {s for t in tasks for s in (t[0], t[2])}
    row_maps = [(w["out_slot"], w["n"]) for w in ops if w["kind"] != _H_LAYER and w["out_slot"] in read]
    map_of = {s: i for i, (s, _) in enumerate(row_maps)}
    for w in ops:
        w["map"] = -1 if w["kind"] == _H_LAYER else map_of.get(w["out_slot"], -1)
    if len(ops) > _BWD90_MAX_OPS:
        raise ValueError(f"{len(ops)} backward ops exceed the row kernel's {_BWD90_MAX_OPS}")
    if len(row_maps) > _WGRAD_MAX_MAPS:
        raise ValueError(f"{len(row_maps)} stash slots written; the row kernel takes "
                         f"{_WGRAD_MAX_MAPS}")
    # float32 holds an activation tile only: no input tile, no staged bias or hvx rows
    in_lo, in_hi = (0, 0) if f32 else (m0.in_lo, 0 if shared else m0.in_hi)
    lo_kb, hi_kb = _kblocks(in_lo, depth), _kblocks(in_hi, depth)
    act_kb = max(w["n_pad"] for w in ops) // depth
    slot = _TF32_SLOT if f32 else max(w["n_pad"] for w in ops if w["nseg"]) * 128
    hvx_rays = 63 // m0.ns + 2 if hvx_w and not f32 else 0  # rays that 64 consecutive rows can touch

    def cst(rays):
        return 0 if f32 else _SM90_BIAS + rays * hvx_w

    def smem(stages, rays):
        return (stages * slot + 2 * (act_kb + lo_kb + hi_kb) * _SM90_KBLOCK
                + 2 * 4 * (cst(rays) + _BWD90_DP) + 4 * (_BWD90_RED + _BWD90_XFER)
                + _BWD90_BARRIERS)

    fits = [(s_, r) for s_ in _BWD90_STAGES for r in (hvx_rays, 0) if smem(s_, r) <= _SMEM_LIMIT]
    if not fits:
        raise ValueError(f"the row kernel needs {smem(_BWD90_STAGES[-1], 0)} B of shared memory")
    stages, rays = fits[0]
    head = dict(n_ops=len(ops), n_rows=0, ns=m0.ns, in_lo=in_lo, in_hi=in_hi, lo_kb=lo_kb,
                hi_kb=hi_kb, act_kb=act_kb, slot_bytes=slot, stages=stages, hvx_rays=rays,
                cst_floats=cst(rays), part_w=sizes["part"], n_masks=sizes["mask"],
                n_maps=len(row_maps), hvx_w=hvx_w)
    words = [head[k] for k in _BWD90_HEADER]
    for w in ops:
        words += [v for k in _BWD90_OP for v in (w[k] if isinstance(w[k], list) else [w[k]])]
    words = np.asarray(words, dtype=np.int32)
    words.setflags(write=False)
    fwd_words = None
    if f32:  # struct tf32::Stash
        slots, masks = [-1] * _MAX_OPS, [0] * _MAX_OPS
        for i, (slot_, mask) in enumerate(stored):
            slots[i], masks[i] = slot_, mask
        lo_slot, lo_n = inputs.get(_SRC_LO, (-1, 0))
        hi_slot, hi_n = inputs.get(_SRC_HI, (-1, 0))
        fwd_words = np.asarray([lo_slot, lo_n, hi_slot, hi_n, sizes["mask"], 0] + slots + masks,
                               dtype=np.int32)
        fwd_words.setflags(write=False)

    n_hvx = sum(m.has_hvx for m in members)
    wp = _wgrad_plan(tasks, n_rows, f32=f32)
    sums = [(1, -(-n_rows // bm), sizes["part"]), (1, wp.n_chunks, sizes["dw"]),
            (n_hvx * (n_rows // m0.ns), m0.ns, hvx_w)]
    w_index, f_index = (np.concatenate(x) if x else np.zeros(0, np.int64) for x in (w_parts, f_parts))
    return BwdPlan(
        words=words, row_maps=tuple(row_maps), tasks=wp.jobs, stash_cols=sizes["stash"],
        part_w=sizes["part"], dw_total=sizes["dw"], n_chunks=wp.n_chunks,
        chunk_rows=wp.chunk_rows, hvx_w=hvx_w, n_hvx=n_hvx, smem=smem(stages, rays),
        mask_words=-(-n_rows // bm) * sizes["mask"] * _BWD90_MASK_THREADS * 4, grads=grads,
        maps=wp.maps, wgrad_bytes=wp.issued, slices=tuple(_colsum_slices(*x)[0] for x in sums),
        scratch=_colsum_scratch(sums), dws=tasks, w_src=tuple(ws.keys),
        w_index=np.where(w_index < 0, ws.size, w_index), f_src=tuple(fs.keys),
        f_index=np.where(f_index < 0, fs.size, f_index), stash_ld=_stash_ld(n_rows, f32),
        act_cols=sizes["act"], fwd_words=fwd_words)


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


def _launch_fwd(spec, kp, lo, hi, hvx, entry: str, pre=None, stash=None) -> torch.Tensor:
    """Run the forward kernel: (n_planes, nr, ns) f32 planes; with `pre`
    (entry snerf_fused_mlp_fwd_pre) the hvx layer's products and bias
    before hvx land there too; with `stash` = (fwd_words, acts, masks)
    (entry snerf_fused_mlp_fwd_stash, float32) what the row pass reads."""
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
        args += [_ptr(hi)] if entry != "snerf_fused_mlp_ens_fwd" else []
        args += [_ptr(hvx), _ptr(wts), _ptr(fpar), _ptr(out)]
        args += [_ptr(pre)] if pre is not None else []
        if stash is not None:
            fwd_words, acts, masks = stash
            args += [fwd_words.ctypes.data_as(ctypes.c_void_p), int(fwd_words.size), _ptr(acts),
                     _ptr(masks)]
        args += [ctypes.c_int(smem), _stream(lo.device)]
        rc = getattr(lib, entry)(*args)
        if rc != 0:
            raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    return out


def _launch_bwd(spec, kp, lo, hi, hvx, d_planes: torch.Tensor, entry: str, sec_g=None, saved=None):
    """Run the backward kernels: (per-member dkp list, dhvx (n_hvx, nr, Wv));
    with `sec_g` (entry snerf_fused_mlp_bwd_sec) the hvx layer's g takes
    the secondary views' cotangent after dhvx's share is stored. float32:
    `saved` = (acts, masks), what the training forward stored
    (`_stash_fwd`)."""
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

    if cd == torch.bfloat16:
        acts, masks = None, torch.empty(max(plan.mask_words, 2), dtype=torch.int32, device=dev)
    else:
        acts, masks = saved
    stash = torch.empty(plan.stash_cols * plan.stash_ld, dtype=cd, device=dev)
    g32 = f32(max(plan.n_hvx * n * plan.hvx_w, 1))
    parts, part_out = f32(n_tiles * plan.part_w), f32(plan.part_w)
    dw_part, dw_out = f32(max(plan.n_chunks * plan.dw_total, 1)), f32(max(plan.dw_total, 1))
    dhvx = f32(plan.n_hvx, n // ns, max(plan.hvx_w, 1))
    scratch = f32(plan.scratch)
    slices = np.asarray(plan.slices, dtype=np.int32)
    words = plan.words.copy()  # the row pass's program
    words[1] = n
    maps = plan.maps
    if cd == torch.bfloat16:  # the row pass's tensor maps, then the weight pass's
        row_maps = [[slot * n, w, n, 2 * w] for slot, w in plan.row_maps]
        maps = np.concatenate([np.asarray(row_maps, dtype=np.int64).reshape(-1, 4), plan.maps])
    lib = build.load_library("fused_mlp_bwd")
    args = [1 if cd == torch.bfloat16 else 0, words.ctypes.data_as(ctypes.c_void_p),
            int(words.size), _ptr(lo)]
    args += [_ptr(hi)] if entry != "snerf_fused_mlp_ens_bwd" else []
    args += [_ptr(hvx), _ptr(d_planes), _ptr(plan.wts), _ptr(plan.fpar), _ptr(plan.dev_tasks),
             len(plan.tasks), plan.n_chunks, plan.chunk_rows, plan.dw_total,
             plan.n_hvx * (n // ns), _ptr(stash)]
    args += [_ptr(acts)] if entry != "snerf_fused_mlp_bwd_sec" else []
    args += [_ptr(g32), _ptr(masks), _ptr(parts),
             _ptr(part_out), _ptr(dw_part), _ptr(dw_out), _ptr(dhvx),
             maps.ctypes.data_as(ctypes.c_void_p), len(maps),
             slices.ctypes.data_as(ctypes.c_void_p), _ptr(scratch), ctypes.c_int(plan.smem)]
    args += [_ptr(sec_g)] if sec_g is not None else []
    args += [_stream(dev)]
    rc = getattr(lib, entry)(*args)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    return unpack_grads(plan, dw_out, part_out), dhvx


def wgrad(slots, dws) -> list:
    """The weight pass alone: [A[:, :k_in]^T G[:, :n_out]] in float32 for
    every (a, g, k_in, n_out) of `dws`, with A = slots[a] and G = slots[g],
    (n_rows, width) bf16 or float32 matrices (width a multiple of 16).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (`_wgrad_plan`'s jobs on a stash of the slots, laid out as the row pass
    lays it out: in float32 each slot read as A row-major and each read as
    G K-major, a slot read both ways twice; then the column sum of its
    partials over the chunks) or raise.
    """
    if slots[0].device.type == "cpu":
        return [slots[a][:, :k].float().T @ slots[g][:, :m].float() for a, g, k, m in dws]
    n, dev, cd = slots[0].shape[0], slots[0].device, slots[0].dtype
    widths = [x.shape[1] for x in slots]
    for x in slots:
        if (x.dtype not in (torch.bfloat16, torch.float32) or x.dtype != cd or x.device != dev
                or x.dim() != 2 or x.shape[0] != n):
            raise ValueError("slots must be (n_rows, width) bf16 or float32 tensors of one type "
                             "on one device")
    if any(w % 16 for w in widths) or not n:
        raise ValueError(f"slot widths {widths} must be multiples of 16, rows > 0")
    f32 = cd == torch.float32
    ld = _stash_ld(n, f32)
    parts, col = [], {}  # the stash's slots, in order: (slot, read as G), at column col[...]

    def place(i, g):
        key = (i, g and f32)
        if key not in col:
            col[key] = sum(widths[j] for j, _ in parts)
            parts.append(key)
        return col[key]

    tasks, offs, total = [], [], 0
    for a, g, k, m in dws:
        if not (0 < k <= widths[a] and 0 < m <= widths[g] and m % 2 == 0):
            raise ValueError(f"dW ({k}, {m}) does not fit slots of widths {widths[a]}, {widths[g]}")
        tasks.append([place(a, False), widths[a], place(g, True), widths[g], k, m, total])
        offs.append(total)
        total += k * m
    stash = torch.zeros(sum(widths[i] for i, _ in parts) * ld, dtype=cd, device=dev)
    for i, kmajor in parts:
        w, c = widths[i], col[(i, kmajor)]
        if kmajor:
            stash[c * ld : (c + w) * ld].view(w, ld)[:, :n] = slots[i].T
        else:
            stash[c * ld : c * ld + n * w].view(n, w)[:] = slots[i]
    dw = _launch_wgrad(stash, n, _wgrad_plan(tasks, n, f32), total)
    wgrad.launches += 1
    return [dw[o : o + k * m].view(k, m) for o, (_, _, k, m) in zip(offs, dws)]


def _launch_wgrad(stash: torch.Tensor, n_rows: int, plan: WgradPlan, dw_total: int) -> torch.Tensor:
    """Run a WgradPlan's jobs on a bf16 or float32 stash, then the column
    sum of their partials: the reduced dW vector (dw_total,) float32."""
    from simplenerf_torch.ops import build

    dev = stash.device
    jobs = torch.from_numpy(plan.jobs).to(dev)
    dw_part = torch.empty(plan.n_chunks * dw_total, dtype=torch.float32, device=dev)
    dw = torch.empty(dw_total, dtype=torch.float32, device=dev)
    slices, _ = _colsum_slices(1, plan.n_chunks, dw_total)
    scratch = torch.empty(_colsum_scratch([(1, plan.n_chunks, dw_total)]), dtype=torch.float32,
                          device=dev)
    rc = build.load_library("fused_mlp_bwd").snerf_wgrad(
        1 if stash.dtype == torch.bfloat16 else 0, _ptr(stash),
        plan.maps.ctypes.data_as(ctypes.c_void_p), len(plan.maps), _ptr(jobs),
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


def pe_operands_reference(pts, d: int, ds: int, cdtype) -> tuple:
    """Plain version of `pe_operands`: the float32 positional encoding,
    cast to cdtype and concatenated."""
    x, s, c = encoding.encode_parts(pts, d)
    x = x.to(cdtype)
    if d == 0:
        return x.contiguous(), None
    lo = torch.cat([x, s[:, : 3 * ds].to(cdtype), c[:, : 3 * ds].to(cdtype)], dim=-1)
    hi = None
    if ds < d:
        hi = torch.cat([s[:, 3 * ds : 3 * d].to(cdtype), c[:, 3 * ds : 3 * d].to(cdtype)], dim=-1)
    return lo, hi


def pe_operands(pts: torch.Tensor, d: int, ds: int, cdtype) -> tuple:
    """The fused kernels' blocked PE operands of points pts (N, 3) float32:
    (lo, hi or None) at cdtype.

    lo = [x | sin f<ds | cos f<ds] (N, 3+6ds); hi = [sin f>=ds | cos f>=ds]
    (N, 6(d-ds)), the high-frequency views-branch extra, where ds < d. An
    ensemble's shared block is ds = d. CPU tensors take the plain version
    (`pe_operands_reference`); CUDA tensors launch the kernel
    (csrc/field_pe.cu `snerf_field_pe`, the same numbers bit for bit) or
    raise.
    """
    if pts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pe_operands runs on CPU or CUDA tensors, got {pts.device}")
    if pts.dtype != torch.float32 or pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError(f"pts: expected (N, 3) float32, got {tuple(pts.shape)} {pts.dtype}")
    if not pts.is_contiguous():
        raise ValueError("pts must be contiguous")
    if not 0 <= ds <= d:
        raise ValueError(f"PE degrees: expected 0 <= ds <= d, got d={d}, ds={ds}")
    if cdtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {cdtype}")
    if pts.device.type == "cpu":
        return pe_operands_reference(pts, d, ds, cdtype)
    from simplenerf_torch.ops import build

    n = pts.shape[0]
    lo = torch.empty((n, 3 + 6 * ds), dtype=cdtype, device=pts.device)
    hi = torch.empty((n, 6 * (d - ds)), dtype=cdtype, device=pts.device) if ds < d else None
    rc = build.load_library("field_pe").snerf_field_pe(
        _ptr(pts), _ptr(lo), _ptr(hi), n, d, ds, 1 if cdtype == torch.bfloat16 else 0,
        _stream(pts.device))
    if rc != 0:
        raise RuntimeError(f"snerf_field_pe kernel launch failed: CUDA error {rc}")
    if n:
        pe_operands.launches += 1
    return lo, hi


pe_operands.launches = 0

_K13, _K415, _K512 = 1.0 / 3.0, 4.0 / 15.0, 5.0 / 12.0  # float32 constants of the frustum moments


def frustum_gaussians(rays_o, rays_d, radii, t) -> tuple:
    """mip-NeRF's Gaussians of the conical frustums between consecutive
    edges t (nr, ns + 1) of rays o, d (nr, 3) of base radius `radii` (nr, 1)
    (`conical_frustum_to_gaussian`, stable form; `lift_gaussian`, diagonal):
    (mean, var), each (nr, ns, 3) float32.

    With mu and h the interval's middle and half width: t_mean = mu + 2 mu
    h^2 / (3 mu^2 + h^2), t_var = h^2 / 3 - 4/15 h^4 (12 mu^2 - h^2) / (3
    mu^2 + h^2)^2, r_var = r^2 (mu^2 / 4 + 5/12 h^2 - 4/15 h^4 / (3 mu^2 +
    h^2)); mean = o + d t_mean, var = t_var d^2 + r_var (1 - d^2 /
    max(|d|^2, 1e-10)). Each product and sum is one float32 operation in
    this order (divisions by a constant as products with its float32
    reciprocal), which the IPE kernel repeats bit for bit."""
    t0, t1 = t[:, :-1], t[:, 1:]
    mu, hw = (t0 + t1) * 0.5, (t1 - t0) * 0.5
    mu2, hw2 = mu * mu, hw * hw
    den = 3.0 * mu2 + hw2
    hw4 = hw2 * hw2
    t_mean = mu + (2.0 * mu * hw2) / den
    t_var = hw2 * _K13 - _K415 * ((hw4 * (12.0 * mu2 - hw2)) / (den * den))
    r_var = (radii * radii) * ((mu2 * 0.25 + _K512 * hw2) - (_K415 * hw4) / den)
    dd = rays_d * rays_d
    mag = ((dd[:, 0] + dd[:, 1]) + dd[:, 2]).clamp(min=1e-10)
    mean = rays_o[:, None, :] + rays_d[:, None, :] * t_mean[..., None]
    var = t_var[..., None] * dd[:, None, :] + r_var[..., None] * (1.0 - dd / mag[:, None])[:, None, :]
    return mean, var


def ipe_operands_reference(rays_o, rays_d, radii, t, deg: int, mask, cdtype) -> torch.Tensor:
    """Plain version of `ipe_operands`: the frustums' Gaussians
    (`frustum_gaussians`), their integrated PE in float32, times the mask,
    cast to cdtype."""
    mean, var = frustum_gaussians(rays_o, rays_d, radii, t)
    mean, var = mean.reshape(-1, 3), var.reshape(-1, 3)
    parts = [mean]
    if deg:
        scale = 2.0 ** torch.arange(deg, dtype=torch.float32, device=mean.device)
        z = (scale[:, None] * mean[:, None, :]).reshape(-1, 3 * deg)
        damp = torch.exp(-0.5 * ((scale * scale)[:, None] * var[:, None, :]).reshape(-1, 3 * deg))
        parts += [torch.sin(z) * damp, torch.cos(z) * damp]
    lo = torch.cat(parts, dim=-1)
    if mask is not None:
        lo = lo * mask
    return lo.to(cdtype).contiguous()


def ipe_operands(rays_o, rays_d, radii, t, deg: int, mask, cdtype) -> torch.Tensor:
    """The points operand lo of the fused field calls of mip-NeRF's field
    (FreeNeRF): the integrated positional encoding of the conical frustums
    between consecutive edges t (nr, ns + 1) of rays o, d (nr, 3) with base
    radii (nr, 1), all float32, as (nr ns, 3 + 6 deg) at cdtype, rows ray
    major: [mean | sin(2^l mean) exp(-4^l var / 2), l < deg | cos(...)
    exp(...)], each column times `mask` (3 + 6 deg float32, FreeNeRF's
    frequency mask) where given. CPU tensors take the plain version
    (`ipe_operands_reference`); CUDA tensors launch the kernel
    (csrc/field_pe.cu `snerf_field_ipe`) or raise. No gradient: the
    frustums hold no parameter."""
    nr = t.shape[0]
    ns = t.shape[1] - 1 if t.dim() == 2 else -1
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ipe_operands runs on CPU or CUDA tensors, got {t.device}")
    shapes = {"rays_o": (rays_o, (nr, 3)), "rays_d": (rays_d, (nr, 3)), "radii": (radii, (nr, 1))}
    if ns < 1:
        raise ValueError(f"t: expected (nr, ns + 1) edges, got {tuple(t.shape)}")
    if mask is not None:
        shapes["mask"] = (mask, (3 + 6 * deg,))
    for name, (x, shape) in {"t": (t, (nr, ns + 1)), **shapes}.items():
        if x.dtype != torch.float32 or tuple(x.shape) != shape or x.device != t.device:
            raise ValueError(f"{name}: expected {shape} float32 on {t.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if cdtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {cdtype}")
    if t.device.type == "cpu":
        return ipe_operands_reference(rays_o, rays_d, radii, t, deg, mask, cdtype)
    from simplenerf_torch.ops import build

    n = nr * ns
    lo = torch.empty((n, 3 + 6 * deg), dtype=cdtype, device=t.device)
    args = [x.contiguous() for x in (rays_o, rays_d, radii, t)]
    m = mask.contiguous() if mask is not None else None
    rc = build.load_library("field_pe").snerf_field_ipe(
        *(_ptr(x) for x in args), _ptr(m), _ptr(lo), n, ns, deg,
        1 if cdtype == torch.bfloat16 else 0, _stream(t.device))
    if rc != 0:
        raise RuntimeError(f"snerf_field_ipe kernel launch failed: CUDA error {rc}")
    if n:
        ipe_operands.launches += 1
    return lo


ipe_operands.launches = 0


def _stacked_cotangents(n_planes: int, d_planes, nr: int, ns: int, device) -> torch.Tensor:
    if isinstance(d_planes, torch.Tensor):
        return d_planes.float().reshape(n_planes, nr, ns).contiguous()
    ref = torch.empty((nr, ns), device=device)
    return torch.stack(_cotangent_list(n_planes, d_planes, ref)).contiguous()


def _zero_grads(kp: dict, keys) -> dict:
    """The gradients of no rows: f32 zeros shaped like each kernel param."""
    return {k: torch.zeros(kp[k].shape, dtype=torch.float32, device=kp[k].device) for k in keys}


def _count_fwd(wrapper, lo):
    """Count a forward launch (none for no rows) on `wrapper`."""
    if lo.shape[0]:
        wrapper.launches += 1


def _stashes(spec, lo) -> bool:
    """Whether the forward of `spec` at lo's rows, under autograd, stores
    what its backward reads (`_stash_fwd`): float32 on CUDA."""
    return lo.shape[0] > 0 and lo.device.type == "cuda" and spec.cdtype == torch.float32


def _stash_fwd(spec, kp, lo, hi, hvx) -> tuple:
    """The float32 training forward (snerf_fused_mlp_fwd_stash; an
    ensemble's hi None): (planes, (acts, masks)), acts the activation stash
    (lo, hi and every layer's activations, `act_cols` slots) and masks the
    ReLU mask words, laid out as `_bwd_plan`'s fwd_words says, so that the
    row pass runs no forward op."""
    n, dev = lo.shape[0], lo.device
    plan = _bwd_on(spec, n, dev)[0]
    acts = torch.empty(plan.act_cols * plan.stash_ld, dtype=torch.float32, device=dev)
    masks = torch.empty(max(plan.mask_words, 2), dtype=torch.int32, device=dev)
    out = _launch_fwd(spec, kp, lo, hi, hvx, "snerf_fused_mlp_fwd_stash",
                      stash=(plan.fwd_words, acts, masks))
    return out, (acts, masks)


def _fwd(spec: FusedSpec, kp: dict, lo, hi, hvx, sec=None, train=False) -> tuple:
    """The forward kernel (CUDA) or its plain version (CPU): (stacked
    planes, pre, stash); with `sec` the k secondary planes follow the head
    planes and pre is the hvx layer's stored pre-activation (CUDA; None on
    the CPU, whose backward recomputes it); with `train` (under autograd)
    in float32 on CUDA stash is what the backward reads (`_stash_fwd`),
    else None."""
    if lo.device.type == "cpu":
        return torch.stack(fused_apply_reference(spec, kp, lo, hi, hvx, sec)), None, None
    _check_operands(spec, lo, hi, hvx)
    if sec is None:
        stash = None
        if train and _stashes(spec, lo):
            out, stash = _stash_fwd(spec, kp, lo, hi, hvx)
        else:
            out = _launch_fwd(spec, kp, lo, hi, hvx, "snerf_fused_mlp_fwd")
        _count_fwd(fused_apply, lo)
        return out, None, stash
    _check_secondary(spec, lo, *sec)
    pre = torch.empty((lo.shape[0], spec.views_width), dtype=torch.float32, device=lo.device)
    out = _launch_fwd(spec, kp, lo, hi, hvx, "snerf_fused_mlp_fwd_pre", pre=pre)
    _count_fwd(fused_apply, lo)
    return torch.cat([out, secondary_fwd(spec, kp, pre, *sec)]), pre, None


def fused_bwd(spec: FusedSpec, kp: dict, lo, hi, hvx, d_planes, sec=None, pre=None, stash=None):
    """The backward of `fused_apply`: (dkp f32, dhvx or None), and with
    `sec` = (pe2, wdir) (dkp, dhvx, dwdir).

    CPU tensors take `fused_bwd_reference`; CUDA tensors launch the kernel
    (or raise). d_planes: (n_planes [+ k], nr, ns) or a sequence with None
    for a plane no loss reads. With `sec` on CUDA: the secondary backward
    (`secondary_bwd`, from `pre`, the forward's stored hvx-layer products,
    which that case requires), then the row pass with its cotangent
    (snerf_fused_mlp_bwd_sec); the head row's share is added to dkp.
    float32 on CUDA: the row pass reads `stash`, what the forward stored
    under autograd (`_fwd(train=True)`); without it (a direct call) this
    launches that forward first and counts it in `fused_bwd.own_forward`.
    """
    _check_device(lo, "fused_bwd")
    if lo.device.type == "cpu":
        return fused_bwd_reference(spec, kp, lo, hi, hvx, d_planes, sec)
    _check_operands(spec, lo, hi, hvx)
    n = lo.shape[0]
    if sec is not None:
        _check_secondary(spec, lo, *sec)
        if pre is None:
            raise ValueError("fused_bwd with secondary views on CUDA needs the forward's pre")
    if n == 0:
        out = (_zero_grads(kp, spec.param_keys()), torch.zeros_like(hvx) if spec.has_hvx else None)
        return out if sec is None else (*out, torch.zeros_like(sec[1], dtype=torch.float32))
    k = 0 if sec is None else sec[0].shape[0] // n
    dp = _stacked_cotangents(spec.n_planes + k, d_planes, n // spec.ns, spec.ns, lo.device)
    if sec is None:
        if stash is None and _stashes(spec, lo):
            stash = _stash_fwd(spec, kp, lo, hi, hvx)[1]
            fused_bwd.own_forward += 1
        (dkp,), dhvx = _launch_bwd(spec, kp, lo, hi, hvx, dp, "snerf_fused_mlp_bwd", saved=stash)
        fused_bwd.launches += 1
        return dkp, dhvx[0] if spec.has_hvx else None
    sec_g, dwdir, dw_vis, db_vis = secondary_bwd(spec, kp, pre, *sec, dp[spec.n_planes :])
    (dkp,), dhvx = _launch_bwd(spec, kp, lo, hi, hvx, dp[: spec.n_planes].contiguous(),
                               "snerf_fused_mlp_bwd_sec", sec_g=sec_g)
    fused_bwd.launches += 1
    dkp["wvo_t"][-1] += dw_vis
    dkp["bvo"][0, -1] += db_vis
    return dkp, dhvx[0], dwdir


class _FusedApply(torch.autograd.Function):
    """fused_apply under autograd: the forward kernel, then the backward
    kernel; pe2 and wdir are the secondary views' operands or None; train:
    a backward will run (the float32 forward then stores what it reads)."""

    @staticmethod
    def forward(ctx, spec, keys, train, lo, hi, hvx, pe2, wdir, *vals):
        ctx.spec, ctx.keys = spec, keys
        sec = None if pe2 is None else (pe2, wdir)
        out, pre, stash = _fwd(spec, dict(zip(keys, vals)), lo, hi, hvx, sec, train=train)
        ctx.save_for_backward(lo, hi, hvx, pe2, wdir, pre, *(stash or (None, None)), *vals)
        return out

    @staticmethod
    def backward(ctx, d_out):
        lo, hi, hvx, pe2, wdir, pre, acts, masks, *vals = ctx.saved_tensors
        kp = dict(zip(ctx.keys, vals))
        stash = None if acts is None else (acts, masks)
        dwdir = None
        if pe2 is None:
            dkp, dhvx = fused_bwd(ctx.spec, kp, lo, hi, hvx, d_out, stash=stash)
        else:
            dkp, dhvx, dwdir = fused_bwd(ctx.spec, kp, lo, hi, hvx, d_out, sec=(pe2, wdir), pre=pre)
        return (None, None, None, None, None, dhvx if ctx.needs_input_grad[5] else None, None,
                dwdir if ctx.needs_input_grad[7] else None, *(dkp[k] for k in ctx.keys))


def _train(*tensors) -> bool:
    """Whether autograd will run a backward through these inputs."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def fused_apply(spec: FusedSpec, kp: dict, lo, hi, hvx, sec=None) -> tuple:
    """Fused field evaluation -> tuple of `spec.n_planes` (N // ns, ns) f32 planes.

    lo: (N, in_lo) cdtype trunk input [x | sin f<ds | cos f<ds]; hi:
    (N, in_hi) cdtype high-frequency views-branch extra, required iff
    spec.has_extra; hvx: (N // ns, Wv) f32 per-ray views-branch addend,
    required iff spec.has_hvx. Points-head channels first, then views-head
    channels: raw linear head outputs.

    sec = (pe2, wdir): secondary views (ViP-NeRF's visibility prior). pe2
    ((N k), 3+6dv) cdtype holds the blocked PE of each point's k other
    cameras' directions, rows point-major; wdir (3+6dv, Wv) the first views
    layer's dirs rows (`dirs_w`). Then k planes of the views head's last
    channel (the visibility) at those directions follow, raw
    (`secondary_reference`); bf16 only on CUDA (`secondary_supported`).

    CPU tensors take the plain versions; CUDA tensors launch the kernels (or
    raise). Differentiable in kp, hvx and wdir (`fused_bwd`); lo, hi and pe2
    get none.
    """
    _check_device(lo, "fused_apply")
    keys = tuple(spec.param_keys())
    pe2, wdir = sec if sec is not None else (None, None)
    vals = [kp[k] for k in keys]
    train = _train(hvx, wdir, *vals)
    return _FusedApply.apply(spec, keys, train, lo, hi, hvx, pe2, wdir, *vals).unbind(0)


def secondary_supported(spec: FusedSpec, device) -> bool:
    """Whether `fused_apply` takes secondary views for `spec` on `device`:
    one views layer with view directions and a visibility channel last in
    its head; on CUDA the bf16 kernels only (float32 goes unfused), and not
    where the forward's plan hands a turn on (`hand`, header word 13): the
    forward has no kPre instance with kSplit."""
    ok = (spec.has_hvx and spec.views_depth == 1 and spec.out_v >= 1
          and spec.views_width <= _SEC_MAX_WV)
    return ok and (torch.device(device).type == "cpu"
                   or (spec.cdtype == torch.bfloat16 and not _sm90_on(spec, torch.device("cpu"))[0].words[13]))


# The secondary-view kernels (csrc/fused_mlp_sec.cu): the widest views
# layer, direction PE and view count they take, a block's warps (each a
# tile of 16 // k points at a time), and their grid, two blocks an SM (the
# backward's rows of partials).
_SEC_MAX_WV = 128
_SEC_MAX_PE = 32
_SEC_MAX_VIEWS = 8
_SEC_WARPS = 4
_SEC_BLOCKS = 2 * _SMS


def _sec_blocks(n: int, k: int) -> int:
    return min(-(-n // (_SEC_WARPS * (16 // k))), _SEC_BLOCKS)


def _check_secondary(spec: FusedSpec, lo, pe2, wdir):
    if not secondary_supported(spec, lo.device):
        raise ValueError(f"no secondary views for this spec on {lo.device}: {spec}")
    n = lo.shape[0]
    pe_w = wdir.shape[0] if wdir is not None else -1
    k = pe2.shape[0] // n if n else 0
    if (pe2.dtype != spec.cdtype or pe2.dim() != 2 or pe2.shape[1] != pe_w or k * n != pe2.shape[0]
            or not 0 < pe_w <= _SEC_MAX_PE or tuple(wdir.shape) != (pe_w, spec.views_width)
            or (n and not 0 < k <= _SEC_MAX_VIEWS)):
        raise ValueError(f"secondary operands: pe2 {tuple(pe2.shape)} {pe2.dtype}, wdir "
                         f"{None if wdir is None else tuple(wdir.shape)} for {n} rows")
    if not pe2.is_contiguous() or pe2.device != lo.device or wdir.device != lo.device:
        raise ValueError(f"pe2 must be contiguous and both operands on {lo.device}")


def _sec_operands(spec: FusedSpec, kp: dict, wdir) -> tuple:
    """The secondary kernels' float32 operands: wdir rounded to the compute
    type, and [w_vis | b_vis]."""
    w_vis, b_vis = _sec_head(spec, kp)
    head = torch.cat([w_vis.float(), b_vis.float().reshape(1)]).contiguous()
    return wdir.to(spec.cdtype).float().contiguous(), head


def secondary_fwd(spec: FusedSpec, kp: dict, pre, pe2, wdir) -> torch.Tensor:
    """The secondary-view forward: (k, nr, ns) raw planes. CPU tensors take
    `secondary_reference`; CUDA tensors launch csrc/fused_mlp_sec.cu
    `snerf_sec_fwd` (or raise)."""
    if pre.device.type == "cpu":
        return secondary_reference(spec, kp, pre, pe2, wdir)
    from simplenerf_torch.ops import build

    n, pe_w = pre.shape[0], wdir.shape[0]
    k = pe2.shape[0] // n
    w, head = _sec_operands(spec, kp, wdir)
    out = torch.empty((k, n // spec.ns, spec.ns), dtype=torch.float32, device=pre.device)
    blocks = _sec_blocks(n, k)
    rc = build.load_library("fused_mlp_sec").snerf_sec_fwd(
        _ptr(pre), _ptr(pe2), _ptr(w), _ptr(head), _ptr(out), n, k, pe_w, spec.views_width, blocks,
        _stream(pre.device))
    if rc != 0:
        raise RuntimeError(f"snerf_sec_fwd kernel launch failed: CUDA error {rc}")
    secondary_fwd.launches += 1
    return out


def secondary_bwd(spec: FusedSpec, kp: dict, pre, pe2, wdir, d_sec) -> tuple:
    """The secondary-view backward from d_sec (k, nr, ns): (sec (N, Wv),
    dwdir, dw_vis, db_vis), as `secondary_bwd_reference`. CUDA: csrc/
    fused_mlp_sec.cu `snerf_sec_bwd`, then the column sum of its blocks'
    partials (`column_sums`)."""
    if pre.device.type == "cpu":
        return secondary_bwd_reference(spec, kp, pre, pe2, wdir, d_sec)
    from simplenerf_torch.ops import build

    n, pe_w, wv = pre.shape[0], wdir.shape[0], spec.views_width
    k = pe2.shape[0] // n
    w, head = _sec_operands(spec, kp, wdir)
    dv = d_sec.float().reshape(k, n).contiguous()
    sec = torch.empty((n, wv), dtype=torch.float32, device=pre.device)
    blocks = _sec_blocks(n, k)
    width = pe_w * wv + wv + 1
    part = torch.empty((1, blocks, width), dtype=torch.float32, device=pre.device)
    rc = build.load_library("fused_mlp_sec").snerf_sec_bwd(
        _ptr(pre), _ptr(pe2), _ptr(w), _ptr(head), _ptr(dv), _ptr(sec), _ptr(part), n, k, pe_w, wv,
        blocks, _stream(pre.device))
    if rc != 0:
        raise RuntimeError(f"snerf_sec_bwd kernel launch failed: CUDA error {rc}")
    secondary_bwd.launches += 1
    sums = column_sums(part)[0]
    return sec, sums[: pe_w * wv].view(pe_w, wv), sums[pe_w * wv : pe_w * wv + wv], sums[-1]


secondary_fwd.launches = 0
secondary_bwd.launches = 0


fused_apply.launches = 0
fused_bwd.launches = 0
fused_bwd.own_forward = 0


def _check_ensemble(ens: EnsembleSpec, lo, hvxs):
    if len(hvxs) != len(ens.hvx_members):
        raise ValueError(f"{len(hvxs)} hvx tensors for {len(ens.hvx_members)} hvx members")
    if len({(m.ns, m.dtype, m.shared_pe_degree) for m in ens.members}) != 1:
        raise ValueError("ensemble members must share ns, dtype and the shared PE degree")
    for m, hvx in zip(ens.members, _member_hvx(ens, hvxs)):
        _check_operands(m, lo, None, hvx)


def _stack_hvx(hvxs):
    return torch.stack(list(hvxs)).contiguous() if hvxs else None


def _ens_fwd(ens: EnsembleSpec, kps, lo, hvxs, train=False) -> tuple:
    """The ensemble's forward kernel (CUDA) or its plain version (CPU):
    (stacked planes, stash), stash as `_fwd`'s."""
    if lo.device.type == "cpu":
        return torch.stack(fused_apply_ensemble_reference(ens, kps, lo, hvxs)), None
    _check_ensemble(ens, lo, hvxs)
    stash = None
    if train and _stashes(ens, lo):
        out, stash = _stash_fwd(ens, kps, lo, None, _stack_hvx(hvxs))
    else:
        out = _launch_fwd(ens, kps, lo, None, _stack_hvx(hvxs), "snerf_fused_mlp_ens_fwd")
    _count_fwd(fused_apply_ensemble, lo)
    return out, stash


def fused_ens_bwd(ens: EnsembleSpec, kps, lo, hvxs, d_planes, stash=None):
    """The backward of `fused_apply_ensemble`: (per-member dkp tuple, dhvx tuple).

    CPU tensors take `fused_ens_bwd_reference`; CUDA tensors launch the
    kernel (or raise). float32 on CUDA: `stash` as `fused_bwd`'s (a call
    without it launches the forward first, counted in
    `fused_ens_bwd.own_forward`).
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
    if stash is None and _stashes(ens, lo):
        stash = _stash_fwd(ens, kps, lo, None, _stack_hvx(hvxs))[1]
        fused_ens_bwd.own_forward += 1
    dkps, dhvx = _launch_bwd(ens, kps, lo, None, _stack_hvx(hvxs), dp, "snerf_fused_mlp_ens_bwd",
                             saved=stash)
    fused_ens_bwd.launches += 1
    return tuple(dkps), tuple(dhvx.unbind(0)[: len(ens.hvx_members)])


class _FusedEnsemble(torch.autograd.Function):
    """fused_apply_ensemble under autograd (train as `_FusedApply`'s)."""

    @staticmethod
    def forward(ctx, ens, keys, n_hvx, train, lo, *flat):
        hvxs, vals = flat[:n_hvx], flat[n_hvx:]
        kps, pos = [], 0
        for ks in keys:
            kps.append(dict(zip(ks, vals[pos : pos + len(ks)])))
            pos += len(ks)
        ctx.ens, ctx.keys, ctx.n_hvx = ens, keys, n_hvx
        out, stash = _ens_fwd(ens, kps, lo, hvxs, train=train)
        ctx.save_for_backward(lo, *(stash or (None, None)), *flat)
        return out

    @staticmethod
    def backward(ctx, d_out):
        lo, acts, masks, *flat = ctx.saved_tensors
        hvxs, vals = flat[: ctx.n_hvx], flat[ctx.n_hvx :]
        kps, pos = [], 0
        for ks in ctx.keys:
            kps.append(dict(zip(ks, vals[pos : pos + len(ks)])))
            pos += len(ks)
        stash = None if acts is None else (acts, masks)
        dkps, dhvxs = fused_ens_bwd(ctx.ens, kps, lo, hvxs, d_out, stash=stash)
        grads = [d if ctx.needs_input_grad[5 + i] else None for i, d in enumerate(dhvxs)]
        for ks, dkp in zip(ctx.keys, dkps):
            grads += [dkp[k] for k in ks]
        return (None, None, None, None, None, *grads)


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
    train = _train(*hvxs, *vals)
    return _FusedEnsemble.apply(ens, keys, len(hvxs), train, lo, *hvxs, *vals).unbind(0)


fused_apply_ensemble.launches = 0
fused_ens_bwd.launches = 0
fused_ens_bwd.own_forward = 0


_COUNTED = (fused_apply, fused_bwd, fused_apply_ensemble, fused_ens_bwd, wgrad, column_sums,
            tf32_split, pe_operands, secondary_fwd, secondary_bwd, ipe_operands)
_OWN_FORWARD = (fused_bwd, fused_ens_bwd)  # float32 backward calls that launched their own forward


def launch_counts() -> dict:
    """Every counting wrapper's `launches`, by the wrapper's name, and as
    `<name>.own_forward` the float32 backward calls that had no stash from
    a forward under autograd and launched that forward themselves."""
    counts = {f.__name__: f.launches for f in _COUNTED}
    counts.update({f"{f.__name__}.own_forward": f.own_forward for f in _OWN_FORWARD})
    return counts


def add_launches(counts: dict):
    """Add `counts` (by `launch_counts`' names) to the wrappers' counters: a
    CUDA graph's replay launches what its capture counted."""
    for f in _COUNTED:
        f.launches += counts.get(f.__name__, 0)
    for f in _OWN_FORWARD:
        f.own_forward += counts.get(f"{f.__name__}.own_forward", 0)
