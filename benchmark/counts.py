"""Operations and bytes of the work the configuration requires, and the peaks.

Counted from the configuration's shapes, once, whatever an implementation
does: no recomputation, no padding, no intermediates (stash slots). A
field MLP's kernel op (`fused_apply`, one member of `fused_apply_ensemble`)
computes per point the trunk (the skip join included), the heads and the
views branch; the view directions' part of the first views layer is a
per-ray input (`hvx`) made outside it. Its backward (`fused_bwd`,
`fused_ens_bwd`) gets no activations among its inputs, so it requires the
forward again, dW, and dX except into its PE inputs. A step's model FLOPs
are the forward, dX and dW of every MLP, counted once, with the per-ray
directions' product. A product is 2 FLOPs.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: bf16 989 TFLOP/s, TF32 494.7 TFLOP/s;
# HBM3 3.35 TB/s. A float32 configuration's products run on the TF32 peak.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 494.7e12}
PEAK_BYTES = 3.35e12
OPERAND_BYTES = {"bfloat16": 2, "float32": 4}


def mlp_dims(mlp: dict) -> dict:
    d = mlp["points_positional_encoding_degree"]
    ds = mlp.get("points_sigma_positional_encoding_degree")
    ds = d if ds is None else ds
    view_dep = bool(mlp["view_dependent_rgb"] or mlp.get("predict_visibility", False))
    return {
        "depth": mlp["points_net_depth"], "width": mlp["points_net_width"],
        "vdepth": mlp["views_net_depth"] if view_dep else 0, "vwidth": mlp["views_net_width"],
        "lo": 3 + 6 * ds, "hi": 6 * (d - ds) if view_dep else 0,
        "dirs": 3 + 6 * mlp["views_positional_encoding_degree"] if (view_dep and mlp["use_view_dirs"]) else 0,
        "out_p": 1 if mlp["view_dependent_rgb"] else 4,
        "out_v": ((3 if mlp["view_dependent_rgb"] else 0) + (1 if mlp.get("predict_visibility") else 0))
        if view_dep else 0,
        "view_dep": view_dep,
    }


def _input_macs(m: dict) -> int:
    """Products against the op's PE inputs (the first layer, the skip join,
    the views branch's high-frequency rows): no dX is required there."""
    return 2 * m["lo"] * m["width"] + m["hi"] * m["vwidth"]


def fwd_macs(mlp: dict) -> int:
    """Multiply-adds of one point through the op (skip join after layer 4)."""
    m = mlp_dims(mlp)
    w, vw = m["width"], m["vwidth"]
    macs = m["lo"] * w + (m["depth"] - 1) * w * w + m["lo"] * w + m["out_p"] * w
    if m["view_dep"]:
        macs += w * w + (w + m["hi"]) * vw + (m["vdepth"] - 1) * vw * vw + m["out_v"] * vw
    return macs


def param_count(mlp: dict) -> int:
    """Parameters the kernel op reads: all but the first views layer's
    direction rows, which enter through `hvx`."""
    m = mlp_dims(mlp)
    w, vw = m["width"], m["vwidth"]
    n = (m["lo"] + 1) * w + (m["depth"] - 1) * (w * w + w) + m["lo"] * w + (w + 1) * m["out_p"]
    if m["view_dep"]:
        n += (w * w + w) + (w + m["hi"] + 1) * vw
        n += (m["vdepth"] - 1) * (vw * vw + vw) + (vw + 1) * m["out_v"]
    return n


def fwd_op(mlps: list, n_rays: int, ns: int, dtype: str) -> dict:
    """FLOPs and bytes of one forward op over `mlps` sharing their points:
    inputs (PE block, the high-frequency block per member that has one,
    hvx, f32 parameters) read once, f32 head planes written once."""
    n = n_rays * ns
    cb = OPERAND_BYTES[dtype]
    dims = [mlp_dims(m) for m in mlps]
    flops = 2 * n * sum(fwd_macs(m) for m in mlps)
    # One PE block (an ensemble's members share it): the widest member's.
    nbytes = n * max(d["lo"] + d["hi"] for d in dims) * cb
    nbytes += sum(n_rays * d["vwidth"] * 4 for d in dims if d["dirs"])
    nbytes += sum(4 * param_count(m) for m in mlps)
    nbytes += sum(n * (d["out_p"] + d["out_v"]) * 4 for d in dims)
    return {"flops": flops, "bytes": nbytes}


def bwd_op(mlps: list, n_rays: int, ns: int, dtype: str) -> dict:
    """FLOPs and bytes of the backward op: the forward again, dW, dX except
    into the PE inputs; reads the forward's inputs and the planes'
    gradients (as many bytes as the forward's planes), writes the
    parameters' and hvx's gradients."""
    n = n_rays * ns
    f = fwd_op(mlps, n_rays, ns, dtype)
    dims = [mlp_dims(m) for m in mlps]
    flops = 2 * n * sum(3 * fwd_macs(m) - _input_macs(d) for m, d in zip(mlps, dims))
    grads = sum(4 * param_count(m) for m in mlps)
    grads += sum(n_rays * d["vwidth"] * 4 for d in dims if d["dirs"])
    return {"flops": flops, "bytes": f["bytes"] + grads}


def bound_s(op: dict, dtype: str) -> float:
    """The least time the op's work takes on the card: the larger of its
    FLOPs at the dtype's peak and its bytes at HBM's rate."""
    return max(op["flops"] / PEAK_FLOPS[dtype], op["bytes"] / PEAK_BYTES)


def _dirs_macs(mlp: dict) -> int:
    m = mlp_dims(mlp)
    return m["dirs"] * m["vwidth"]


def train_step_flops(mlps: dict, n_rays: int) -> float:
    """Model FLOPs of one train step: every MLP's forward, dW and dX (none
    into its PE inputs), once; coarse members at the coarse samples, the
    fine MLP at coarse + fine samples."""
    ns_c = mlps["coarse"]["num_samples"]
    ns_f = ns_c + mlps["fine"]["num_samples"]
    total = 0
    for name, mlp in mlps.items():
        ns = ns_f if name == "fine" else ns_c
        d = mlp_dims(mlp)
        per_point = 3 * fwd_macs(mlp) - _input_macs(d)
        total += 2 * (n_rays * ns * per_point + 2 * n_rays * _dirs_macs(mlp))
    return float(total)


def frame_flops(mlps: dict, n_rays: int) -> float:
    """Model FLOPs of one eval frame: the coarse and fine main MLPs' forward."""
    ns_c = mlps["coarse"]["num_samples"]
    ns_f = ns_c + mlps["fine"]["num_samples"]
    total = 0
    for name, ns in (("coarse", ns_c), ("fine", ns_f)):
        total += 2 * n_rays * (ns * fwd_macs(mlps[name]) + _dirs_macs(mlps[name]))
    return float(total)
