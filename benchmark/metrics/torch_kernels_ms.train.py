"""Device ms per unit of every kernel the four kernel entry points did not
launch (gather, sampling, compositing, losses, Adam; PE and glue)."""
from benchmark.metrics._common import ENTRIES, op_s


def read(ctx):
    ops = ctx.get("ops")
    if not ops or not ops["us"].get("all"):
        return None
    return 1e3 * (ops["us"]["all"] * 1e-6 / ops["units"] - (op_s(ctx, *ENTRIES) or 0.0))
