"""Reduction of a torch.profiler Chrome trace to the harness's numbers.

- device busy time: the union of kernel, memcpy and memset intervals
  inside a window span;
- the device operations that took most time, by name;
- the longest idle gaps of the device, each labelled with the innermost
  CPU op or span the main thread was in at the gap's middle;
- op-scoped device time: every kernel whose launch (the runtime or driver
  call that shares its correlation id) lies inside a CPU op of an entry
  point counts toward that entry point, whatever the kernel's name.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")

def entry_of(name: str):
    """The kernel entry point whose CPU op `name` is, or None: the autograd
    Functions `_FusedApply` (fused_apply) and `_FusedEnsemble`
    (fused_apply_ensemble), and their backward nodes (fused_bwd,
    fused_ens_bwd)."""
    if "_FusedApplyBackward" in name:
        return "fused_bwd"
    if "_FusedEnsembleBackward" in name:
        return "fused_ens_bwd"
    return {"_FusedApply": "fused_apply", "_FusedEnsemble": "fused_apply_ensemble"}.get(name)


def load(path) -> list:
    with open(path) as f:
        data = json.load(f)
    return [e for e in data.get("traceEvents", data) if e.get("ph") == "X"]


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def span(events, name):
    """(start, end) in us of the first host span called `name`."""
    for e in events:
        if e.get("cat") in HOST_CATS and e["name"] == name:
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    return None


def device_events(events, window=None):
    out = [e for e in events if e.get("cat") in DEVICE_CATS]
    if window is not None:
        s, t = window
        out = [e for e in out if float(e["ts"]) + float(e["dur"]) > s and float(e["ts"]) < t]
    return out


def busy_us(dev, window):
    s, t = window
    clipped = [(max(float(e["ts"]), s), min(float(e["ts"]) + float(e["dur"]), t)) for e in dev]
    return sum(e - b for b, e in _union([c for c in clipped if c[1] > c[0]]))


def top_ops(dev, k=10):
    tot = defaultdict(float)
    for e in dev:
        tot[e["name"]] += float(e["dur"]) * 1e-6
    return [[n[:200], v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def _host_tid(events, window):
    """The thread of the window span (the main thread)."""
    s, t = window
    for e in events:
        if e.get("cat") in HOST_CATS and float(e["ts"]) == s:
            return e.get("tid")
    return None


def idle_gaps(events, dev, window, k=10):
    """The `k` longest gaps in which no device operation ran, each with the
    innermost host op or span of the main thread at its middle; where that
    is the window's own span (the host ran Python between ops), the last
    op that ended before the middle, as "after <op>"."""
    s, t = window
    busy = _union([(max(float(e["ts"]), s), min(float(e["ts"]) + float(e["dur"]), t)) for e in dev])
    gaps, cur = [], s
    for b, e in busy:
        if b > cur:
            gaps.append((cur, b))
        cur = max(cur, e)
    if t > cur:
        gaps.append((cur, t))
    gaps.sort(key=lambda g: -(g[1] - g[0]))
    tid = _host_tid(events, window)
    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("tid") == tid]
    out = []
    for b, e in gaps[:k]:
        mid = 0.5 * (b + e)
        inner, best, last, last_end = "host idle", None, None, None
        for h in host:
            hs, he = float(h["ts"]), float(h["ts"]) + float(h["dur"])
            if hs <= mid <= he and (best is None or he - hs < best):
                inner, best = h["name"], he - hs
            elif he < mid and (last_end is None or he > last_end):
                last, last_end = h["name"], he
        if best == t - s and last is not None:
            inner = f"after {last}"
        out.append([inner[:200], (e - b) * 1e-6])
    return out


def op_scoped_us(events) -> dict:
    """Device time (us) of the kernels launched inside each entry point's
    CPU ops, and of all kernels: {"fused_apply": ..., ..., "all": ...}."""
    scopes = defaultdict(list)  # tid -> [(start, end, entry)]
    for e in events:
        if e.get("cat") in HOST_CATS:
            entry = entry_of(e["name"])
            if entry is not None:
                scopes[e.get("tid")].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), entry))
    starts = {tid: [s for s, _, _ in sorted(v)] for tid, v in scopes.items()}
    ordered = {tid: sorted(v) for tid, v in scopes.items()}
    launch_entry = {}
    for e in events:
        if e.get("cat") not in LAUNCH_CATS:
            continue
        corr = (e.get("args") or {}).get("correlation")
        tid = e.get("tid")
        if corr is None or tid not in ordered:
            continue
        ts = float(e["ts"])
        i = bisect.bisect_right(starts[tid], ts)
        for j in range(i - 1, max(i - 5, -1), -1):  # the innermost scopes first
            s, t, entry = ordered[tid][j]
            if s <= ts <= t:
                launch_entry[corr] = entry
                break
    out = defaultdict(float)
    for e in events:
        if e.get("cat") != "kernel":
            continue
        out["all"] += float(e["dur"])
        entry = launch_entry.get((e.get("args") or {}).get("correlation"))
        if entry is not None:
            out[entry] += float(e["dur"])
    return dict(out)
