"""Operations and bytes of ViP-NeRF's secondary views, in the convention of
`counts.py` (the work the configuration requires, counted once).

Each (point, other view) pair evaluates the first views layer again on the
point's feature and that view's direction, and the visibility row of the
views head: the feature's share of the layer is the point's own (a sum,
formed once), so a pair requires the direction rows' products (dirs x
vwidth) and the head row (vwidth) forward. Its backward requires them
again, their dW (the direction rows and the head row) and dX into the
layer's activation (the head row), none into the direction's PE. The
pairs' inputs are the directions' PE at the compute type; their outputs,
one float32 plane per view. A step renders every ray of the batch at the
k = train frames - 1 other views, at both levels.
"""

from __future__ import annotations

from benchmark import counts, scene


def pair_macs(mlp: dict) -> int:
    """Forward multiply-adds of one secondary pair: 27 x 128 + 128 = 3,584
    at the published widths."""
    m = counts.mlp_dims(mlp)
    return m["dirs"] * m["vwidth"] + m["vwidth"]


def fwd_op(mlp: dict, n_rays: int, ns: int, k: int, dtype: str) -> dict:
    """`counts.fwd_op` of one MLP with its k secondary views: the pairs'
    products, their PE read once and their planes written once."""
    n, m = n_rays * ns, counts.mlp_dims(mlp)
    f = counts.fwd_op([mlp], n_rays, ns, dtype)
    return {"flops": f["flops"] + 2 * n * k * pair_macs(mlp),
            "bytes": f["bytes"] + n * k * (m["dirs"] * counts.OPERAND_BYTES[dtype] + 4)}


def bwd_op(mlp: dict, n_rays: int, ns: int, k: int, dtype: str) -> dict:
    """`counts.bwd_op` with the pairs' backward: their forward again, dW of
    the direction and head rows, dX of the head row; their PE and the
    planes' gradients read, the direction rows' gradient written."""
    n, m = n_rays * ns, counts.mlp_dims(mlp)
    b = counts.bwd_op([mlp], n_rays, ns, dtype)
    macs = 3 * pair_macs(mlp) - m["dirs"] * m["vwidth"]
    return {"flops": b["flops"] + 2 * n * k * macs,
            "bytes": b["bytes"] + n * k * (m["dirs"] * counts.OPERAND_BYTES[dtype] + 4)
            + 4 * m["dirs"] * m["vwidth"]}


def train_step_flops(mlps: dict, n_rays: int, k: int) -> float:
    """`counts.train_step_flops` and every pair's forward, dW and dX."""
    ns_c = mlps["coarse"]["num_samples"]
    ns_f = ns_c + mlps["fine"]["num_samples"]
    total = counts.train_step_flops(mlps, n_rays)
    for name, ns in (("coarse", ns_c), ("fine", ns_f)):
        m = counts.mlp_dims(mlps[name])
        total += 2 * n_rays * ns * k * (3 * pair_macs(mlps[name]) - m["dirs"] * m["vwidth"])
    return float(total)


def step_counts(cell) -> dict:
    """A ViP-NeRF cell's counts for the training readers (`kinds/train.py`'s
    keys): rays a step, model FLOPs, and the bound seconds of the two
    levels' forward ops and backward ops with their secondary views."""
    cfg = cell.config["train_configs"]
    mlps = scene.model_mlps(cfg)
    dl = cfg["data_loader"]
    nr = dl["num_rays"] + dl["sparse_depth"]["num_rays"]
    k = cell.config["assumed"]["train_frames"] - 1
    ns_c = mlps["coarse"]["num_samples"]
    ns_f = ns_c + mlps["fine"]["num_samples"]
    dt = cell.dtype
    levels = (("coarse", ns_c), ("fine", ns_f))
    return {
        "rays_per_step": nr,
        "step_flops": train_step_flops(mlps, nr, k),
        "fwd_bound_s": sum(counts.bound_s(fwd_op(mlps[n], nr, ns, k, dt), dt) for n, ns in levels),
        "bwd_bound_s": sum(counts.bound_s(bwd_op(mlps[n], nr, ns, k, dt), dt) for n, ns in levels),
    }
