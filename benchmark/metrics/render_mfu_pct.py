"""A frame's forward FLOPs (counts.frame_flops) times the frames of the
traced window, over the window's time and the dtype's peak."""


def read(ctx):
    w = ctx.get("window")
    if not w or not w.get("frames"):
        return None
    return 100.0 * ctx["counts"]["frame_flops"] * w["frames"] / (w["window_s"] * ctx["peak_flops"])
