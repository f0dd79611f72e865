"""Host ms a frame in its rays (`frame.rays`: `create_test_data`), median a
frame."""
from benchmark.metrics._spans import host_less


def read(ctx):
    return host_less("frame", "frame.rays")
