"""The port's tracing: spans on the torch.profiler clock, device markers that
a CUDA graph replays, and a torch.profiler window.

Port of simplenerf_tpu/utils/profiling.py, whose `trace` is `trace` here.

Spans. `span(name, device=None)` is a context manager. It is off by
default, and then one flag check returns a shared no-op object: no clock
read, no `record_function`. It is on while a torch.profiler runs (the
Trainer's `profiling` window, any caller's profiler), after `enable()`,
and while a CUDA graph is captured (`capturing`). An on span

- appends SpanRecord(name, parent, thread, t0_ns, t1_ns, device_ms) to a
  buffer of MAX_SPANS records (later spans are only counted: `dropped()`),
  stamped with `time.time_ns()`, the clock of torch.profiler's Chrome trace
  (an event's `ts` x 1000 + the trace's `baseTimeNanoseconds`);
- enters `record_function(name)` while a profiler runs, so the span lies in
  the trace beside the kernels it launched;
- given a CUDA `device`, records a timing event pair on the device's current
  stream. On the CPU a span's device time is its host time: the work ran in
  the call.

Graph markers. Inside `capturing()` the event pair of a CUDA span is a pair
of external events, which the capture turns into graph nodes that every
replay records again. `StepGraph` keeps them (a `Markers`) and reports each
replay (`replayed`); `replay_ms()` reads the device ms per span name of the
most recent replay. Events are read lazily: `records()`, `device_ms()` and
`replay_ms()` wait for the events they read.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional

import torch

MAX_SPANS = 1 << 16


class SpanRecord(NamedTuple):
    name: str
    parent: Optional[str]
    thread: int
    t0_ns: int
    t1_ns: int
    device_ms: Optional[float]


class Markers:
    """A captured graph's device spans: name -> [(start, end)] external
    event pairs, and how often the graph was replayed."""

    def __init__(self):
        self.pairs: dict[str, list] = {}
        self.replays = 0

    def ms(self) -> dict:
        """Device ms per span name of the most recent replay (a name's uses
        in the graph summed); {} before the first."""
        return _pairs_ms(self.pairs) if self.replays else {}


if hasattr(torch.autograd.profiler, "_is_profiler_enabled"):
    def profiler_running() -> bool:
        return torch.autograd.profiler._is_profiler_enabled
else:  # where torch keeps the flag only in C++
    profiler_running = torch._C._autograd._profiler_enabled

_forced = False  # enable() / disable()
_markers: Optional[Markers] = None  # the graph being captured
_on = False  # _forced or a capture
_records: list = []  # [name, parent, thread, t0, t1, device]: device None, ms, or events
_dropped = 0
_latest: dict = {}  # span name -> its latest device time: ms, or [(start, end)] events
_replay: Optional[Markers] = None  # the graph replayed last


class _Local(threading.local):
    def __init__(self):
        self.stack: list = []  # the names of this thread's open spans


_local = _Local()


class _Off:
    """The span while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, device=None):
    """A span `name`, timed on `device` too (a torch.device or its name)
    where one is given."""
    if not (_on or profiler_running()):
        return _OFF
    return _Span(name, device)


class _Span:
    __slots__ = ("name", "device", "parent", "t0_ns", "t1_ns", "_rf", "_start", "_stream", "_cpu")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9

    def __enter__(self):
        stack = _local.stack
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        # Stamped before the profiler's own mark, whose first use in a
        # process takes a millisecond after its stamp.
        self.t0_ns = time.time_ns()
        self._rf = None
        if profiler_running():
            self._rf = torch.autograd.profiler.record_function(self.name)
            self._rf.__enter__()
        self._start = self._stream = None
        kind = torch.device(self.device).type if self.device is not None else None
        self._cpu = kind == "cpu"
        if kind == "cuda":
            self._stream = torch.cuda.current_stream(self.device)
            self._start = _event()
            self._start.record(self._stream)
        return self

    def __exit__(self, *exc):
        self.t1_ns = time.time_ns()
        dev = None
        if self._start is not None:
            end = _event()
            end.record(self._stream)
            if _markers is not None:
                _markers.pairs.setdefault(self.name, []).append((self._start, end))
            else:
                dev = (self._start, end)
                _latest[self.name] = [dev]
        elif self._cpu:
            dev = (self.t1_ns - self.t0_ns) * 1e-6
            _latest[self.name] = dev
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _local.stack.pop()
        _append([self.name, self.parent, threading.get_ident(), self.t0_ns, self.t1_ns, dev])
        return False


def _event() -> torch.cuda.Event:
    """A timing event; external inside a capture, so the graph records it."""
    if _markers is not None:
        return torch.cuda.Event(enable_timing=True, external=True)
    return torch.cuda.Event(enable_timing=True)


def _append(rec: list):
    global _dropped
    if len(_records) < MAX_SPANS:
        _records.append(rec)
    else:
        _dropped += 1


def _pairs_ms(pairs: dict) -> dict:
    out = {}
    for name, evs in pairs.items():
        evs[-1][1].synchronize()
        out[name] = sum(s.elapsed_time(e) for s, e in evs)
    return out


# --------------------------------------------------------------------------
# Switches and readers


def _update():
    global _on
    _on = _forced or _markers is not None


def enable():
    """Record spans whether or not a profiler runs."""
    global _forced
    _forced = True
    _update()


def disable():
    global _forced
    _forced = False
    _update()


def enabled() -> bool:
    """Whether a span opened now records."""
    return _on or profiler_running()


@contextlib.contextmanager
def capturing():
    """Spans on for a graph capture; CUDA spans inside become the graph's
    markers, which the context yields (a `Markers`)."""
    global _markers
    prev, markers = _markers, Markers()
    _markers = markers
    _update()
    try:
        yield markers
    finally:
        _markers = prev
        _update()


def replayed(markers: Markers):
    """Note a replay of the graph whose markers these are."""
    global _replay
    markers.replays += 1
    _replay = markers
    _latest.update(markers.pairs)


def replay_ms() -> dict:
    """Device ms per span name of the most recent graph replay; {} if none."""
    return _replay.ms() if _replay is not None else {}


def device_ms(prefix: str = "", clear: bool = False) -> dict:
    """The latest device ms of each span name that starts with `prefix`,
    from an eager span or a graph replay (a replay's uses of a name
    summed); with `clear`, those names are forgotten after the read."""
    names = [n for n in _latest if n.startswith(prefix)]
    out = {}
    for n in names:
        v = _latest.pop(n) if clear else _latest[n]
        out[n] = v if isinstance(v, float) else _pairs_ms({n: v})[n]
    return out


def records() -> list:
    """Every span recorded since the last `reset()`, in the order they ended."""
    for rec in _records:
        if isinstance(rec[5], tuple):
            rec[5] = _pairs_ms({"": [rec[5]]})[""]
    return [SpanRecord(*rec) for rec in _records]


def dropped() -> int:
    """Spans not recorded because the buffer was full."""
    return _dropped


def reset():
    """Forget every record, the dropped count and the latest device times."""
    global _dropped, _replay
    _records.clear()
    _latest.clear()
    _dropped = 0
    _replay = None


# --------------------------------------------------------------------------
# A torch.profiler window


@contextlib.contextmanager
def trace(logdir: Path, device=None):
    """Profile the body with torch.profiler and write the Chrome trace
    `<logdir>/trace_<pid>_<ns>.json` (open it in Perfetto or chrome://tracing).
    Spans record while it runs and lie in the trace as user annotations.

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
