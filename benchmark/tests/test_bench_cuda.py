"""On the card: one short run of every cell through the command the driver
runs. Marked `cuda`; it skips where there is no card (decided in the test).

    python -m pytest benchmark/tests -m cuda
"""

import json
import subprocess
import sys

import pytest

from benchmark import harness

CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed", "77",
                          "--seconds", "3", "--trace", "0"], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    if harness.Cell(name).traffic["kind"] == "train":  # the compared steps were graph replays
        assert '"replayed": true' in out.stdout
