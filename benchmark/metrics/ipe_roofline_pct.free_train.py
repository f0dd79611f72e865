"""Bound time of the step's two IPE kernel launches (counts_freenerf: the
bytes they require at HBM's rate) over the device time of the kernels named
`field_ipe_kernel` per eager step of the traced run; None where the trace
has none."""


def read(ctx):
    ipe = ctx.get("ipe")
    if not ipe or not ipe["us"] or "ipe_bound_s" not in ctx.get("counts", {}):
        return None
    return 100.0 * ctx["counts"]["ipe_bound_s"] / (ipe["us"] * 1e-6 / ipe["units"])
