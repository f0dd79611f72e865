"""Device ms a frame of the join of the chunks' outputs (`frame.join`:
`torch.cat` and the trim in `render_in_chunks`): median a frame."""
from benchmark.metrics._spans import device_sum


def read(ctx):
    return device_sum("frame", "frame.join")
