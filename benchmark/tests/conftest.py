"""Tiny versions of the benchmark's cells for CPU tests: the cell's own
files with the widths, rays, samples and scene shrunk in memory."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SEED = 2**31 + 12345  # above 32 signed bits, as the driver's seeds are


def tiny(cell):
    tc = cell.config["train_configs"]
    dl = tc["data_loader"]
    dl["num_rays"], dl["sparse_depth"]["num_rays"] = 64, 32
    model = tc["model"]
    mlps = [model["coarse_mlp"], model["fine_mlp"], model["points_augmentation"]["coarse_mlp"],
            model["views_augmentation"]["coarse_mlp"]]
    for m in mlps:
        m["points_net_width"], m["views_net_width"] = 32, 16
        m["num_samples"] = 8
    model["fine_mlp"]["num_samples"] = 16
    cell.config["assumed"].update(height=24, width=32, focal=26.0, sparse_points_per_frame=60)
    tr = cell.traffic
    if tr["kind"] == "render":
        tr.update(chunk=256, check_frames=2, check_pixels=300, span_frames=2, trace_frames=2, label_frames=1)
    else:
        tr["steps_per_call"] = min(tr["steps_per_call"], 2)
        tr["trace_steps"] = tr["label_steps"] = 2 * tr["steps_per_call"]
        tr["op_steps"] = 1
    return cell


@pytest.fixture
def tiny_cell():
    from benchmark import harness

    return lambda name: tiny(harness.Cell(name))


@pytest.fixture
def run_tiny():
    """Run a tiny cell on the CPU for a short window; the result dict."""
    import time

    import torch

    from benchmark import harness

    def go(cell, traced=False, seconds=0.5):
        return harness.run(cell, SEED, seconds, traced, torch.device("cpu"), time.perf_counter(),
                           forbid=False)

    return go
