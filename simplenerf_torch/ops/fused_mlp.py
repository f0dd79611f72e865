"""Fused NeRF field MLP forward: CUDA kernel for Hopper + its plain version.

Replaces the TPU kernel `_fwd_kernel` of simplenerf_tpu/ops/fused_mlp.py
(launched by `_fused_fwd_call` behind `fused_apply`). One launch evaluates
one field MLP over N = nr * ns points: the trunk of `depth` layers with
row-merged skip joins, the points head, and the optional views branch
(feature layer, first views layer on feature + `hi` + per-ray `hvx`, more
views layers, views head). It emits the raw linear head channels as
(nr, ns) float32 planes; noise, ReLU and sigmoids are the caller's epilogue
(`fields.mlp._fused_epilogue`).

What bounds it on an H100: arithmetic. The published 8x256 main MLP does
2 * 589,952 FLOP per point against ~142 bytes of device-memory traffic per
point in bf16 (126 B of `lo` in, 16 B of planes out), some 8,000 FLOP per
byte, far above the ~295 FLOP/byte at which the H100's published bf16
peak and memory rate balance (SXM data sheet, 700 W). The design therefore keeps every activation
on chip: a block owns a tile of rows (128 in bf16), holds its `lo`/`hi`
inputs and one activation tile in shared memory, and runs the whole layer
chain without touching device memory between layers. The weights (about
1.2 MB in bf16) do not fit in one block's 227 KB of shared memory, so
every layer streams its transposed weight through a 3-stage ring of
K-slabs filled by cp.async; all blocks read the same weights, which stay
resident in the 50 MB L2. bf16 products run on the tensor cores
(mma.sync m16n8k16 with ldmatrix fragments, float32 accumulators); the
float32 path is plain FMA (no TF32, which would break float32 parity).
Heads are float32 warp reductions, as the TPU kernel's lane reductions
are. `pack_program` turns the spec into the list of layers and heads the
kernel walks.

`fused_apply` launches the kernel for CUDA tensors and takes
`fused_apply_reference` only for CPU tensors. It has no backward yet: under
autograd with an input that requires grad it raises.
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

    @property
    def cdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def has_views(self) -> bool:
        return self.views_depth > 0 or self.out_v > 0

    @property
    def in_lo(self) -> int:
        """Trunk input channels: [x | sin f<ds | cos f<ds]."""
        return 3 + 6 * self.sigma_pe_degree

    @property
    def in_hi(self) -> int:
        """Views-branch extra channels: [sin f>=ds | cos f>=ds]."""
        return 6 * (self.pe_degree - self.sigma_pe_degree) if self.has_extra else 0

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

    def flops_per_point(self) -> int:
        """Multiply-adds x 2 of one point through every matmul and head."""
        macs = self.in_lo * self.width + (self.depth - 1) * self.width**2
        macs += sum(self.in_lo * self.width for i in range(1, self.depth) if (i - 1) in self.skip_layers)
        macs += self.out_p * self.width
        if self.has_views:
            macs += self.width**2 + (self.width + self.in_hi) * self.views_width
            macs += (self.views_depth - 1) * self.views_width**2 + self.out_v * self.views_width
        return 2 * macs


def make_spec(cfg, ns: int, dtype) -> FusedSpec:
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
    )


def kernel_params(params, cfg) -> dict:
    """Re-slice canonical (reference-layout) params into kernel layout.

    Input joins are row-merged to the blocked [x | sin | cos] order (one
    matmul per join); head weights are transposed to (n_out, W) rows. The
    dirs rows of the first views-branch weight are not included (see
    `dirs_w`: they enter through the per-ray `hvx`).
    """
    from simplenerf_torch.fields.mlp import _extra_rows_perm

    perm_lo = encoding.blocked_to_reference_perm(cfg.sigma_pe_degree)
    p = cfg.points_input_dim
    kp: dict = {}
    w0 = params["pts"][0]
    kp["w0i"] = w0["w"][perm_lo]
    kp["b0"] = w0["b"][None]
    for i in range(1, cfg.points_net_depth):
        layer = params["pts"][i]
        if (i - 1) in cfg.skip_layers:
            kp[f"w{i}i"] = layer["w"][:p][perm_lo]
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
            kp["wv0i"] = wv0["w"][wp : wp + e][_extra_rows_perm(cfg)]
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
# Plain PyTorch version (CPU path, and the oracle the kernel is held against)
# ---------------------------------------------------------------------------


def _mm(a, b, spec: FusedSpec):
    return a.to(spec.cdtype).float() @ b.to(spec.cdtype).float()


def _head_planes(spec: FusedSpec, h, wt, b, n_out):
    """Head channel j: plane_j[r, s] = sum_k h[r*ns+s, k] * wt[j, k] + b[j], in f32."""
    h3 = h.float().reshape(-1, spec.ns, h.shape[-1])
    return [(h3 * wt[j].float()).sum(-1) + b[0, j] for j in range(n_out)]


def fused_apply_reference(spec: FusedSpec, kp: dict, lo, hi, hvx) -> tuple:
    """The kernel's function in plain PyTorch (same roundings, f32 heads)."""
    cd = spec.cdtype
    h = torch.relu(_mm(lo, kp["w0i"], spec) + kp["b0"]).to(cd)
    for i in range(1, spec.depth):
        acc = _mm(h, kp[f"w{i}"], spec)
        if (i - 1) in spec.skip_layers:
            acc = acc + _mm(lo, kp[f"w{i}i"], spec)
        h = torch.relu(acc + kp[f"b{i}"]).to(cd)
    planes = _head_planes(spec, h, kp["wpo_t"], kp["bpo"], spec.out_p)
    if spec.has_views:
        f = (_mm(h, kp["wf"], spec) + kp["bf"]).to(cd)
        acc = _mm(f, kp["wv0f"], spec) + kp["bv0"]
        if spec.has_extra:
            acc = acc + _mm(hi, kp["wv0i"], spec)
        if hvx is not None:
            acc = acc + hvx.float().repeat_interleave(spec.ns, dim=0)
        hv = torch.relu(acc).to(cd)
        for i in range(1, spec.views_depth):
            hv = torch.relu(_mm(hv, kp[f"wv{i}"], spec) + kp[f"bv{i}"]).to(cd)
        planes += _head_planes(spec, hv, kp["wvo_t"], kp["bvo"], spec.out_v)
    return tuple(planes)


# ---------------------------------------------------------------------------
# CUDA kernel launch
# ---------------------------------------------------------------------------

# Program layout shared with csrc/fused_mlp_fwd.cu (struct Program / Op).
_HEADER_WORDS = 13
_OP_WORDS = 16
_MAX_OPS = 40
_OP_LAYER, _OP_HEAD = 0, 1
_SRC_ACT, _SRC_LO, _SRC_HI = 0, 1, 2
_FLAG_RELU, _FLAG_HVX = 1, 2
_STAGES = 3  # weight slabs in flight
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block can use


def _round16(k: int) -> int:
    return -(-k // 16) * 16


def _tiling(cdtype) -> tuple[int, int]:
    """(rows per block, slab depth): bf16 128 x 64, f32 64 x 32 (Traits in the .cu)."""
    return (128, 64) if cdtype == torch.bfloat16 else (64, 32)


def pack_program(spec: FusedSpec, kp: dict, n_rows: int):
    """Kernel operands: (program words int32 numpy, wts (cdtype), fpar (f32), smem bytes).

    Every matmul weight (K, N) is stored transposed and zero-padded to
    (N, round16(K)) in one cdtype buffer; biases and the f32 head weights
    go to one float32 buffer. The program lists the layers and heads in
    execution order, with the tiles each layer reads (the activation tile,
    which it then overwrites, the lo tile, the hi tile).
    """
    cd = spec.cdtype
    device = kp["w0i"].device
    mats, fvals = [], []
    sizes = {"w": 0, "f": 0}

    def mat(w):
        k, n = w.shape
        kpad = _round16(k)
        wt = torch.zeros((n, kpad), dtype=cd, device=device)
        wt[:, :k] = w.t().to(cd)
        off = sizes["w"]
        mats.append(wt.reshape(-1))
        sizes["w"] += n * kpad
        return off, kpad

    def fvec(v):
        v = v.reshape(-1).float()
        off = sizes["f"]
        fvals.append(v)
        sizes["f"] += v.numel()
        return off

    ops = []

    def layer(segs, n, bias, flags):
        op = [_OP_LAYER, n, fvec(bias), flags, len(segs)] + [0] * 11
        for s, (src, w) in enumerate(segs):
            w_off, kpad = mat(w)
            op[5 + s], op[8 + s], op[11 + s] = src, w_off, kpad
        ops.append(op)

    def head(wt, bias, plane):
        n_out, k = wt.shape
        ops.append([_OP_HEAD, n_out, fvec(bias), 0, 1, _SRC_ACT, 0, 0, fvec(wt), 0, 0, k, 0, 0,
                    plane, 0])

    act = _SRC_ACT
    layer([(_SRC_LO, kp["w0i"])], spec.width, kp["b0"], _FLAG_RELU)
    for i in range(1, spec.depth):
        segs = [(act, kp[f"w{i}"])]
        if (i - 1) in spec.skip_layers:
            segs.append((_SRC_LO, kp[f"w{i}i"]))
        layer(segs, spec.width, kp[f"b{i}"], _FLAG_RELU)
    head(kp["wpo_t"], kp["bpo"], 0)
    if spec.has_views:
        layer([(act, kp["wf"])], spec.width, kp["bf"], 0)
        segs = [(act, kp["wv0f"])]
        if spec.has_extra:
            segs.append((_SRC_HI, kp["wv0i"]))
        layer(segs, spec.views_width, kp["bv0"], _FLAG_RELU | (_FLAG_HVX if spec.has_hvx else 0))
        for i in range(1, spec.views_depth):
            layer([(act, kp[f"wv{i}"])], spec.views_width, kp[f"bv{i}"], _FLAG_RELU)
        head(kp["wvo_t"], kp["bvo"], spec.out_p)
    if len(ops) > _MAX_OPS:
        raise ValueError(f"{len(ops)} kernel ops exceed the program's {_MAX_OPS}")

    pad = 8 if cd == torch.bfloat16 else 4  # 16 bytes: conflict-free fragment reads
    bm, slab_k = _tiling(cd)
    act_w = max(spec.width, spec.views_width if spec.has_views else 0)
    lo_kpad = _round16(spec.in_lo)
    hi_kpad = _round16(spec.in_hi) if spec.in_hi else 0
    act_ld, lo_ld = act_w + pad, lo_kpad + pad
    hi_ld = hi_kpad + pad if hi_kpad else 0
    slab_ld = slab_k + pad
    slab_rows = max(op[1] for op in ops if op[0] == _OP_LAYER)
    header = [len(ops), n_rows, spec.ns, spec.in_lo, spec.in_hi, lo_kpad, hi_kpad,
              act_ld, lo_ld, hi_ld, slab_ld, slab_rows, slab_k]
    words = np.asarray(header + [w for op in ops for w in op], dtype=np.int32)
    esize = 2 if cd == torch.bfloat16 else 4
    smem = esize * (bm * (act_ld + lo_ld + hi_ld) + _STAGES * slab_rows * slab_ld)
    return words, torch.cat(mats).contiguous(), torch.cat(fvals).contiguous(), smem


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
    if spec.has_extra:
        expect.append(("hi", hi, (n, spec.in_hi), spec.cdtype))
    if spec.has_hvx:
        expect.append(("hvx", hvx, (n // spec.ns, spec.views_width), torch.float32))
    for name, t, shape, dt in expect:
        if t is None or tuple(t.shape) != shape or t.dtype != dt:
            got = None if t is None else (tuple(t.shape), t.dtype)
            raise ValueError(f"{name}: expected {shape} {dt}, got {got}")
        if not t.is_cuda or t.device != lo.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {lo.device}")


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def fused_apply(spec: FusedSpec, kp: dict, lo, hi, hvx) -> tuple:
    """Fused field evaluation -> tuple of `spec.n_planes` (N // ns, ns) f32 planes.

    lo: (N, in_lo) cdtype trunk input [x | sin f<ds | cos f<ds]; hi:
    (N, in_hi) cdtype high-frequency views-branch extra, required iff
    spec.has_extra; hvx: (N // ns, Wv) f32 per-ray views-branch addend,
    required iff spec.has_hvx. Points-head channels first, then views-head
    channels: raw linear head outputs.

    CPU tensors take `fused_apply_reference`; CUDA tensors launch the
    kernel (or raise).
    """
    if lo.device.type == "cpu":
        return fused_apply_reference(spec, kp, lo, hi, hvx)
    if lo.device.type != "cuda":
        raise ValueError(f"fused_apply runs on CPU or CUDA tensors, got {lo.device}")
    tensors = [lo, hi, hvx, *kp.values()]
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "fused_apply has no backward kernel yet; it comes with the training slice"
        )
    _check_operands(spec, lo, hi, hvx)
    n = lo.shape[0]
    words, wts, fpar, smem = pack_program(spec, kp, n)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"kernel needs {smem} B of shared memory, more than {_SMEM_LIMIT}")
    out = torch.empty((spec.n_planes, n // spec.ns, spec.ns), dtype=torch.float32, device=lo.device)
    if n:
        from simplenerf_torch.ops import build

        lib = build.load_library("fused_mlp_fwd")
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        rc = lib.snerf_fused_mlp_fwd(
            1 if spec.cdtype == torch.bfloat16 else 0,
            words.ctypes.data_as(ctypes.c_void_p), int(words.size),
            _ptr(lo), _ptr(hi), _ptr(hvx), _ptr(wts), _ptr(fpar), _ptr(out),
            ctypes.c_int(smem), ctypes.c_void_p(stream),
        )
        if rc != 0:
            raise RuntimeError(f"fused_mlp_fwd kernel launch failed: CUDA error {rc}")
        fused_apply.launches += 1
    return tuple(out.unbind(0))


fused_apply.launches = 0
