"""The step's model FLOPs (counts.train_step_flops) times the steps of the
traced graph window, over the window's time and the dtype's peak."""


def read(ctx):
    w = ctx.get("window")
    if not w or not w.get("steps"):
        return None
    return 100.0 * ctx["counts"]["step_flops"] * w["steps"] / (w["window_s"] * ctx["peak_flops"])
