"""Tracing and per-step timing.

Port of simplenerf_tpu/utils/profiling.py. `trace` captures a
torch.profiler window (the trainer's `profiling` config block) and writes
it as a Chrome trace; `StepTimer` keeps rolling step-time statistics on
the host clock between completions. On the card the caller ticks after
work that ends in a synchronisation (the trainer reads its loss values at
log boundaries).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from pathlib import Path
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: Path, device=None):
    """Profile the body with torch.profiler and write the Chrome trace
    `<logdir>/trace_<pid>_<ns>.json` (open it in Perfetto or chrome://tracing).

    CPU and CUDA activities when `device` is a CUDA device, CPU alone
    otherwise. A profiler that cannot start raises: unlike the JAX
    package's `trace`, which passes silently, so that a trace never lacks
    the device without a word.
    """
    from torch.profiler import ProfilerActivity, profile

    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    cuda = torch.device(device).type == "cuda" if device is not None else False
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(logdir / f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Call `tick(steps)` once per completed run of `steps` steps; `stats()`
    gives mean/p50/p90/max step milliseconds, steps/s and rays/s over the
    retained window."""

    def __init__(self, window: int = 512, rays_per_step: int = 0):
        self.window = window
        self.rays_per_step = rays_per_step
        self._last: Optional[float] = None
        self._samples: list[float] = []  # per-step seconds

    def reset(self) -> None:
        self._last = None
        self._samples.clear()

    def tick(self, steps: int = 1) -> Optional[float]:
        """Record a completion; returns per-step seconds for this tick."""
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return None
        dt = (now - self._last) / max(steps, 1)
        self._last = now
        self._samples.extend([dt] * max(steps, 1))
        if len(self._samples) > self.window:
            del self._samples[: len(self._samples) - self.window]
        return dt

    def stats(self) -> dict:
        if not self._samples:
            return {}
        s = sorted(self._samples)
        n = len(s)
        mean = sum(s) / n
        out = {
            "step_ms_mean": mean * 1e3,
            "step_ms_p50": s[n // 2] * 1e3,
            "step_ms_p90": s[min(n - 1, (9 * n) // 10)] * 1e3,
            "step_ms_max": s[-1] * 1e3,
            "steps_per_s": 1.0 / mean,
        }
        if self.rays_per_step:
            out["rays_per_s"] = self.rays_per_step / mean
        return out

    def dump(self, path: Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.stats(), indent=2))
