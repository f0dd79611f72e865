"""Bound time of a frame's fused_apply calls at the render's chunk shapes
over their op-scoped device time per frame."""
from benchmark.metrics._common import op_s


def read(ctx):
    t = op_s(ctx, "fused_apply")
    return None if not t else 100.0 * ctx["counts"]["fwd_bound_s"] / t
