"""Bound time of fused_bwd plus fused_ens_bwd (counts.bwd_op) over their
op-scoped device time per step."""
from benchmark.metrics._common import op_s


def read(ctx):
    t = op_s(ctx, "fused_bwd", "fused_ens_bwd")
    return None if not t else 100.0 * ctx["counts"]["bwd_bound_s"] / t
