"""Host ms per frame in create_test_data plus retrieve_inference_outputs
(the latter timed from a device synchronisation, so it holds no wait)."""
from benchmark.metrics._common import mean_ms


def read(ctx):
    return mean_ms(ctx, "frame_host_s")
