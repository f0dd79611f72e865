"""Device ms a frame of the field's PE and kernel operands (`field.encode`,
each MLP call of each chunk), summed a frame: median a frame."""
from benchmark.metrics._spans import device_sum


def read(ctx):
    return device_sum("frame", "field.encode")
