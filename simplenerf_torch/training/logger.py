"""Training log: a JSONL scalar stream, TensorBoard events and plots.

Port of simplenerf_tpu/training/logger.py: one {"iter", "time", losses...,
"lr", "rays_per_s"} object per line in <log_dir>/scalars.jsonl, always;
TensorBoard event files beside it when `torch.utils.tensorboard` imports;
`save_plots` draws every logged scalar to a PNG with matplotlib. Both
packages are imported only here, when used. Without matplotlib
`save_plots` says so in one line and returns, where the JAX package raises
ImportError (a documented divergence: the card machine has no matplotlib,
and a finished training run should not fail over its plots).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional


class TrainLogger:
    def __init__(self, log_dir: Path):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.jsonl = open(self.log_dir / "scalars.jsonl", "a", buffering=1)
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            pass
        else:
            self.tb = SummaryWriter(str(self.log_dir))
        self._t0 = time.time()

    def log_scalars(self, iteration: int, scalars: dict):
        row = {"iter": iteration, "time": round(time.time() - self._t0, 3)}
        row.update({k: float(v) for k, v in scalars.items()})
        self.jsonl.write(json.dumps(row) + "\n")
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, float(v), iteration)

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()

    def save_plots(self, plots_dir: Optional[Path] = None):
        """Draw every logged scalar against the iteration to
        <plots_dir or log_dir/plots>/<key>.png ('/' in a key becomes '_')."""
        try:
            import matplotlib
        except ImportError:
            print(f"save_plots: matplotlib is not installed; plots of {self.log_dir} skipped",
                  flush=True)
            return
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plots_dir = Path(plots_dir or (self.log_dir / "plots"))
        plots_dir.mkdir(parents=True, exist_ok=True)
        with open(self.log_dir / "scalars.jsonl") as f:
            rows = [json.loads(line) for line in f]
        keys = {k for row in rows for k in row if k not in ("iter", "time")}
        for key in sorted(keys):
            xs, ys = zip(*[(r["iter"], r[key]) for r in rows if key in r])
            plt.figure(figsize=(8, 4))
            plt.plot(xs, ys)
            plt.title(key)
            plt.xlabel("iteration")
            plt.grid(True, alpha=0.3)
            plt.savefig(plots_dir / f"{key.replace('/', '_')}.png", dpi=80)
            plt.close()
