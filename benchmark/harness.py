"""The general driver of one cell: set-up, warm-up, a measured window, the
check that decides `correct`, and the result line.

A cell of BENCHMARK.json names a configuration and a traffic mix; the
harness reads `configs/<config>.json`, `traffic/<traffic>.json` and
`limits/<cell>.json`, drives the kind of traffic the traffic file names
through `kinds/<kind>.py` (kinds/__init__.py gives its functions), and
reads each per-layer metric the cell reports with `metrics/<metric>.py`.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from benchmark import counts
from benchmark import trace as trace_lib

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "simplenerf_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of BENCHMARK.json's workloads with its files."""

    def __init__(self, name: str, bench: dict | None = None, root: Path = ROOT):
        bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.entry, self.bench = name, entry, bench
        self.config = load_json(HERE / "configs" / f"{entry['config']}.json")
        self.traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
        self.limits = load_json(HERE / "limits" / f"{name}.json")
        self.dtype = self.config["train_configs"]["model"]["compute_dtype"]

    def end_to_end(self) -> list:
        """The end-to-end metrics this cell reports: those without a
        `workloads` key and those that list it."""
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> list:
        """The per-layer metrics that list this cell under `workloads`."""
        return [m for m in self.bench["per_layer"] if self.name in m["workloads"]]

    def kind(self):
        """The module that drives this cell's kind of traffic."""
        return importlib.import_module(f"benchmark.kinds.{self.traffic['kind']}")


def read_metric(name: str, ctx: dict):
    """The per-layer metric `name`'s reader, metrics/<name>.py: read(ctx)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def log(*parts):
    print(*parts, flush=True)


def device_info(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}


def smi(fields="name,power.limit,clocks.sm,clocks.max.sm,power.draw,temperature.gpu") -> str:
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        return r.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --------------------------------------------------------------------------
# Profiling


def profiled(device, body, label: str, out_dir: Path, host: bool = True) -> tuple:
    """Run body() under torch.profiler; (the Chrome trace's complete events,
    the host seconds from start to a device synchronisation). With `host`,
    CPU ops are recorded too, inside a span `label`; without, the device
    alone, so that recording the host's ops does not slow the host."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else []
    if host or not acts:
        acts = [ProfilerActivity.CPU] + acts
    with profile(activities=acts) as prof:
        with record_function(label) if host else contextlib.nullcontext():
            t0 = time.perf_counter()
            body()
            sync(device)
            seconds = time.perf_counter() - t0
    path = out_dir / f"{label.replace(':', '_')}.json"
    prof.export_chrome_trace(str(path))
    events = trace_lib.load(path)
    path.unlink()
    return events, seconds


def window_summary(events, seconds: float) -> dict:
    """Busy seconds of the device over a profiled window of `seconds` (the
    host's clock) that the profiler covered whole, and its top device ops."""
    dev = trace_lib.device_events(events)
    span = (min(float(e["ts"]) for e in dev), max(float(e["ts"]) + float(e["dur"]) for e in dev)) \
        if dev else (0.0, 0.0)
    return {"window_s": seconds, "busy_s": trace_lib.busy_us(dev, span) * 1e-6,
            "device_ops": trace_lib.top_ops(dev)}


def gap_labels(events, label: str) -> list:
    """The longest idle gaps of a window profiled with the host's ops,
    each with what the host was doing."""
    win = trace_lib.span(events, label)
    return trace_lib.idle_gaps(events, trace_lib.device_events(events, win), win)


class Timed:
    """A wrapper that adds each call's host seconds to `times`; given a
    `device`, the device is synchronised before the clock starts."""

    def __init__(self, fn, times: list, device=None):
        self.fn, self.times, self.device = fn, times, device

    def __call__(self, *a, **k):
        if self.device is not None:
            sync(self.device)
        t0 = time.perf_counter()
        out = self.fn(*a, **k)
        self.times.append(time.perf_counter() - t0)
        return out


# --------------------------------------------------------------------------
# One run


def judge(numbers: dict, limits: dict) -> tuple:
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name, math.inf)
        good = math.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks


def forbidden_modules() -> list:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
        forbid: bool = True) -> dict:
    """One run of a cell; returns the result dict, printing earlier lines.
    With `forbid`, JAX or the JAX package loaded by the window's close is
    an error."""
    workdir = Path(tempfile.mkdtemp(prefix="snerf_bench_"))
    try:
        return _run(cell, seed, seconds, traced, device, t_start, workdir, forbid)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(cell, seed, seconds, traced, device, t_start, workdir, forbid):
    kind = cell.kind()
    log(f"cell {cell.name} seed {seed} seconds {seconds} trace {int(traced)}")
    if device.type == "cuda":
        log("card before:", smi())
        torch.cuda.reset_peak_memory_stats(device)
    st = kind.setup(cell, seed, device, workdir)
    setup_s = time.perf_counter() - t_start
    metrics = {}
    if not traced:
        attempted, value, lines = kind.window(st, cell, seconds, device)
        for line in lines:
            log(line)
        if device.type == "cuda":
            log("card after:", smi())
        values = {cell.traffic["metric"]: value, "setup_s": setup_s}
        for m in cell.end_to_end():
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ctx = {"cell": cell.name, "dtype": cell.dtype, "peak_flops": counts.PEAK_FLOPS[cell.dtype]}
        ctx.update(kind.traced(st, cell, device, workdir))
        attempted = ctx["attempted"]
        for m in cell.per_layer():
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = device_info(device)
    if device.type == "cuda":
        dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    if traced:
        dev["busy_s"], dev["window_s"] = ctx["window"]["busy_s"], ctx["window"]["window_s"]
    bad = forbidden_modules()
    if forbid and bad:
        raise SystemExit(f"forbidden modules loaded: {bad}")
    # The check: after the window, with the program's state freed.
    kind.release(st)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    verdict = kind.check(st, cell, seed, device)
    log(f"check took {time.perf_counter() - t_check:.2f} s:", json.dumps(verdict, default=str)[:4000])
    ok, checks = judge(verdict["numbers"], cell.limits)
    result = {"correct": ok, "attempted": attempted, "failed": 0 if ok else 1,
              "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = {"device_ops": ctx["window"]["device_ops"],
                               "idle_gaps": ctx["window"]["idle_gaps"]}
    result["checks"] = checks
    return result
