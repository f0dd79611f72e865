"""The trace reduction on a hand-made Chrome trace."""

import pytest

from benchmark import trace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 0}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    ev("user_annotation", "bench::window", 0, 100),
    ev("cpu_op", "_FusedApply", 10, 5),
    ev("cuda_runtime", "cudaLaunchKernel", 11, 1, corr=1),
    ev("cpu_op", "aten::add", 20, 2),
    ev("cuda_runtime", "cudaLaunchKernel", 21, 1, corr=2),
    ev("cpu_op", "autograd::engine::evaluate_function: _FusedEnsembleBackward", 40, 10, tid=2),
    ev("cuda_driver", "cuLaunchKernelEx", 41, 1, tid=2, corr=3),
    ev("kernel", "fwd_kernel_renamed", 12, 10, tid=7, corr=1),
    ev("kernel", "add_kernel", 30, 5, tid=7, corr=2),
    ev("kernel", "bwd_kernel", 50, 20, tid=7, corr=3),
    ev("gpu_memcpy", "Memcpy HtoD", 60, 20, tid=7),
]


def test_entry_names():
    assert trace.entry_of("_FusedApply") == "fused_apply"
    assert trace.entry_of("_FusedEnsemble") == "fused_apply_ensemble"
    assert trace.entry_of("autograd::engine::evaluate_function: _FusedApplyBackward") == "fused_bwd"
    assert trace.entry_of("_FusedEnsembleBackward") == "fused_ens_bwd"
    assert trace.entry_of("aten::mm") is None


def test_op_scoped_time_follows_the_launch_not_the_name():
    us = trace.op_scoped_us(EVENTS)
    assert us == {"all": 35.0, "fused_apply": 10.0, "fused_ens_bwd": 20.0}


def test_busy_gaps_and_top_ops():
    win = trace.span(EVENTS, "bench::window")
    dev = trace.device_events(EVENTS, win)
    assert trace.busy_us(dev, win) == 10 + 5 + 30  # 12-22, 30-35, 50-80
    gaps = trace.idle_gaps(EVENTS, dev, win)
    assert gaps[0][0] == "after aten::add"  # 80-100: only the window span covers it
    assert gaps[1][0] == "after aten::add"  # 35-50
    assert [g[1] for g in gaps] == pytest.approx([20e-6, 15e-6, 12e-6, 8e-6])
    assert trace.top_ops(dev)[0] == ["bwd_kernel", pytest.approx(20e-6)]
