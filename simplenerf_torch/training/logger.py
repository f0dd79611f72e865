"""Training log: a JSONL scalar stream.

Port of the JSONL part of simplenerf_tpu/training/logger.py: one
{"iter", "time", losses..., "lr", "rays_per_s"} object per line in
<log_dir>/scalars.jsonl. TensorBoard events and `save_plots` are not
ported yet.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class TrainLogger:
    def __init__(self, log_dir: Path):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.jsonl = open(self.log_dir / "scalars.jsonl", "a", buffering=1)
        self._t0 = time.time()

    def log_scalars(self, iteration: int, scalars: dict):
        row = {"iter": iteration, "time": round(time.time() - self._t0, 3)}
        row.update({k: float(v) for k, v in scalars.items()})
        self.jsonl.write(json.dumps(row) + "\n")

    def close(self):
        self.jsonl.close()
