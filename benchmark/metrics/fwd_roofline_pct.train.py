"""Bound time of the fine fused_apply plus the trio's fused_apply_ensemble
(counts.fwd_op, counts.bound_s) over their op-scoped device time per step."""
from benchmark.metrics._common import op_s


def read(ctx):
    t = op_s(ctx, "fused_apply", "fused_apply_ensemble")
    return None if not t else 100.0 * ctx["counts"]["fwd_bound_s"] / t
