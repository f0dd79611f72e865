"""Readers of the program's own spans (`simplenerf_torch.utils.profiling`),
read after a cell's traced run: the tracer records while a profiler runs,
so the traced windows fill it. Each reading is a median per unit (a step's
`train.stage`, a frame's `frame`), or the most recent graph replay's device
markers. A program without that tracer, or a run that recorded none of the
spans read, gives None."""

from __future__ import annotations

import bisect
import math
import statistics


def tracer():
    """The program's tracer, or None where it has no span records."""
    try:
        from simplenerf_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, a) for a in ("records", "replay_ms")):
        return None
    return profiling


def replay_ms(name: str):
    """Device ms of span `name` in the most recent graph replay."""
    prof = tracer()
    v = prof.replay_ms().get(name) if prof is not None else None
    return v if v is not None and math.isfinite(v) else None


def host_ms(rec) -> float:
    return (rec.t1_ns - rec.t0_ns) * 1e-6


def per_unit(root: str, value):
    """The median over the spans named `root` of value(root span, the spans
    inside it on its thread), leaving out the units where value gives None."""
    prof = tracer()
    if prof is None:
        return None
    recs = sorted(prof.records(), key=lambda r: r.t0_ns)
    starts = [r.t0_ns for r in recs]
    got = []
    for r in recs:
        if r.name != root:
            continue
        inner = [k for k in recs[bisect.bisect_left(starts, r.t0_ns):
                                 bisect.bisect_right(starts, r.t1_ns)]
                 if k is not r and k.thread == r.thread and k.t1_ns <= r.t1_ns]
        v = value(r, inner)
        if v is not None:
            got.append(v)
    return statistics.median(got) if got else None


def host_less(root: str, part: str, less: str | None = None):
    """Median per `root` of the host ms of its spans `part`, less those of
    their spans `less` where given."""
    def value(_, inner):
        parts = [k for k in inner if k.name == part]
        if not parts:
            return None
        return sum(host_ms(k) for k in parts) - sum(host_ms(k) for k in inner if k.name == less)
    return per_unit(root, value)


def device_sum(root: str, part: str):
    """Median per `root` of the summed device ms of its spans `part`."""
    def value(_, inner):
        ms = [k.device_ms for k in inner if k.name == part and k.device_ms is not None]
        return sum(ms) if ms else None
    return per_unit(root, value)
