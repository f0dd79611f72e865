"""Share of the traced window in which no device operation ran."""
from benchmark.metrics._common import idle_pct


def read(ctx):
    return idle_pct(ctx)
