"""Device ms of the `field.secondary` spans (each level's secondary
directions and their PE operand) in the most recent CUDA graph replay,
summed over the step's levels; None where the program has no such span."""
from benchmark.metrics._spans import replay_ms


def read(ctx):
    return replay_ms("field.secondary")
