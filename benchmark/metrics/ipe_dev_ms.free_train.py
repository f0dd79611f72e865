"""Device ms of the `field.ipe` spans (each level's frustum Gaussians, mask
and IPE operand kernel) in the most recent CUDA graph replay, summed over
the step's two levels; None where the program has no such span."""
from benchmark.metrics._spans import replay_ms


def read(ctx):
    return replay_ms("field.ipe")
