"""Host ms a frame in the read back (`frame.fetch`:
`retrieve_inference_outputs`), less its wait for the frame's device work
(`frame.fetch.wait`, the first device-to-host read): median a frame."""
from benchmark.metrics._spans import host_less


def read(ctx):
    return host_less("frame", "frame.fetch", "frame.fetch.wait")
