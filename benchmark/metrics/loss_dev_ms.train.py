"""Device ms of the step body's `step.losses` span in the most recent
CUDA graph replay (its markers, external events that each replay records)."""
from benchmark.metrics._spans import replay_ms


def read(ctx):
    return replay_ms("step.losses")
