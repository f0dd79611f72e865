"""Helpers the per-layer readers share."""

ENTRIES = ("fused_apply", "fused_apply_ensemble", "fused_bwd", "fused_ens_bwd")


def op_s(ctx, *entries):
    """Device seconds per unit (step or frame) of the kernels launched in
    `entries`, or None where the trace has none of them."""
    ops = ctx.get("ops")
    if not ops or not any(ops["us"].get(e) for e in entries):
        return None
    return sum(ops["us"].get(e, 0.0) for e in entries) * 1e-6 / ops["units"]


def idle_pct(ctx):
    w = ctx.get("window")
    if not w or w["window_s"] <= 0 or w["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - w["busy_s"] / w["window_s"])


def mean_ms(ctx, key):
    v = (ctx.get("spans") or {}).get(key)
    return 1e3 * sum(v) / len(v) if v else None
