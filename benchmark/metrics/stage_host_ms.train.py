"""Host ms a step in the stage (`train.stage`: ray indices, loss weights,
Adam scalars, draws, the input copy), less its wait for the previous
copy out of the pinned buffer (`train.stage.wait`): median a step."""
from benchmark.metrics._spans import per_unit, host_ms


def read(ctx):
    return per_unit("train.stage", lambda r, inner: host_ms(r) - sum(
        host_ms(k) for k in inner if k.name == "train.stage.wait"))
