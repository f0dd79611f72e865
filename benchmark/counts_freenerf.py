"""Operations and bytes of a FreeNeRF train step, in the convention of
`counts.py` (the work the configuration requires, counted once).

mip-NeRF evaluates one MLP at both levels, each at the configuration's
num_samples intervals a ray: a step is two forward ops and two backward
ops of that MLP (`counts.fwd_op`, `counts.bwd_op` with its 3 + 6 x 16 =
99-wide points operand at both joins), and the per-ray direction product
at each level. The IPE kernel (`fused_mlp.ipe_operands`) is bound by bytes:
per level it writes lo once (n x (3 + 6 L) elements at the compute type)
and reads each ray's o, d and radius (7 floats) and its num_samples + 1
edges once, and the mask (3 + 6 L floats).
"""

from __future__ import annotations

from benchmark import counts


def ipe_bytes(mlp: dict, n_rays: int, dtype: str) -> int:
    """Bytes one level's IPE kernel requires."""
    ns, w = mlp["num_samples"], 3 + 6 * mlp["points_positional_encoding_degree"]
    return (n_rays * ns * w * counts.OPERAND_BYTES[dtype] + n_rays * (7 + ns + 1) * 4 + 4 * w)


def train_step_flops(mlp: dict, n_rays: int) -> float:
    """Model FLOPs of one step: both levels' forward, dW and dX (none into
    the PE inputs) of the one MLP, with the direction products."""
    m = counts.mlp_dims(mlp)
    per_point = 3 * counts.fwd_macs(mlp) - counts._input_macs(m)
    level = 2 * (n_rays * mlp["num_samples"] * per_point + 2 * n_rays * counts._dirs_macs(mlp))
    return float(2 * level)


def step_counts(cell) -> dict:
    """A FreeNeRF cell's counts for the training readers (`kinds/train.py`'s
    keys) and the IPE kernel's bound seconds a step (`ipe_bound_s`)."""
    cfg = cell.config["train_configs"]
    mlp = cfg["model"]["mlp"]
    nr, ns, dt = cfg["data_loader"]["num_rays"], mlp["num_samples"], cell.dtype
    return {
        "rays_per_step": nr,
        "step_flops": train_step_flops(mlp, nr),
        "fwd_bound_s": 2 * counts.bound_s(counts.fwd_op([mlp], nr, ns, dt), dt),
        "bwd_bound_s": 2 * counts.bound_s(counts.bwd_op([mlp], nr, ns, dt), dt),
        "ipe_bound_s": 2 * ipe_bytes(mlp, nr, dt) / counts.PEAK_BYTES,
    }
