"""The port's tracer (`simplenerf_torch.utils.profiling`) and the benchmark's
readers of its spans.

CPU:
- off (the default) a span is one shared no-op object and enters no
  `record_function`; `enable()` records; the buffer is bounded;
- under torch.profiler spans nest with their parents, lie in the Chrome
  trace as user annotations, and are stamped on its clock (`ts` x 1000 +
  `baseTimeNanoseconds`, within 1 ms);
- an eager `Trainer.train_one_iter` and a `Tester.predict_frame` on the
  tiny synthetic preset emit the span names of their layers, in order; a
  CPU span's device time is its host time;
- each span reader of `benchmark/metrics/` gives None on an empty tracer
  and the median per unit on a hand-made span log.

Card (`cuda` marker; skips without a CUDA device): the markers of a
captured train step are external events, re-timed by each replay, and
together cover the replay. This file imports no JAX, so on the card it runs
with `python -m pytest tests/test_torch_port_tracing.py -m cuda --noconftest
-p no:cacheprovider`.
"""

import json
import math

import pytest

torch = pytest.importorskip("torch")

from simplenerf_torch.utils import profiling

STEP_SPANS = ("step.forward", "step.losses", "step.backward", "step.adam")


@pytest.fixture(autouse=True)
def clean_tracer():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _names(recs, among=None):
    return [r.name for r in recs if among is None or r.name in among]


# ---------------------------------------------------------------------------
# The tracer on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", [None, "cpu"], ids=["host", "cpu_device"])
def test_off_records_nothing_and_enters_no_record_function(monkeypatch, device):
    entered = []
    real = torch.autograd.profiler.record_function

    def counting(*a, **k):
        entered.append(a)
        return real(*a, **k)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    assert not profiling.enabled()
    for _ in range(3):
        with profiling.span("outer", device=device) as s, profiling.span("inner"):
            pass
        assert s is profiling.span("other")  # the shared no-op object
    assert profiling.records() == [] and entered == [] and profiling.device_ms() == {}
    profiling.enable()
    with profiling.span("outer", device=device):
        pass
    assert _names(profiling.records()) == ["outer"] and entered == []


def test_enable_bounds_the_buffer_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 4)
    profiling.enable()
    for i in range(6):
        with profiling.span(f"s{i}"):
            pass
    assert _names(profiling.records()) == ["s0", "s1", "s2", "s3"] and profiling.dropped() == 2
    profiling.reset()
    assert profiling.records() == [] and profiling.dropped() == 0


def test_a_cpu_span_times_the_device_by_the_host():
    profiling.enable()
    with profiling.span("step.forward", device=torch.device("cpu")):
        torch.ones(64, 64).sum()
    (rec,) = profiling.records()
    assert rec.device_ms == pytest.approx((rec.t1_ns - rec.t0_ns) * 1e-6)
    assert profiling.device_ms("step.", clear=True) == {"step.forward": rec.device_ms}
    assert profiling.device_ms("step.") == {}


NESTED = {"outer": None, "mid": "outer", "inner": "mid"}


@pytest.fixture(scope="module")
def profiled_spans(tmp_path_factory):
    """Three nested spans under torch.profiler: their records and the trace."""
    profiling.reset()
    path = tmp_path_factory.mktemp("trace")
    with profiling.trace(path):
        assert profiling.enabled()
        with profiling.span("outer"):
            with profiling.span("mid"):
                with profiling.span("inner"):
                    torch.ones(8).sum()
            torch.ones(8).sum()
    assert not profiling.enabled()
    recs = {r.name: r for r in profiling.records()}
    (f,) = path.glob("trace_*.json")
    trace = json.loads(f.read_text())
    profiling.reset()
    return recs, trace


@pytest.mark.parametrize("name", list(NESTED))
def test_spans_nest_in_the_profiler_trace_on_its_clock(profiled_spans, name):
    recs, trace = profiled_spans
    assert recs[name].parent == NESTED[name]
    events = [e for e in trace["traceEvents"]
              if e.get("name") == name and e.get("cat") == "user_annotation"]
    assert len(events) == 1
    base = int(trace.get("baseTimeNanoseconds", 0))
    t0 = float(events[0]["ts"]) * 1000 + base
    assert abs(t0 - recs[name].t0_ns) < 1e6, (t0, recs[name].t0_ns)
    assert recs[name].t0_ns <= recs[name].t1_ns


# ---------------------------------------------------------------------------
# Span sites on the tiny synthetic preset
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from simplenerf_torch.data.factory import get_data_loader
    from simplenerf_torch.data.preprocessor import ScenePreprocessor
    from simplenerf_torch.data.synthetic import generate_scene
    from simplenerf_torch.drivers import presets
    from simplenerf_torch.training import tester, trainer

    root = tmp_path_factory.mktemp("db")
    generate_scene(root, num_frames=4, h=16, w=24, num_train=3, seed=0)
    cfg = presets.tiny_synthetic_config(num_rays=16, sparse_depth_rays=8, num_samples_coarse=4,
                                        num_samples_fine=8)
    cfg["model"]["fused_mlp"] = "on"
    cfg["resume_training"] = False
    raw = get_data_loader(cfg, root, "train").load_data()
    pp = ScenePreprocessor(cfg, "train", raw, device="cpu", seed=0)
    t = trainer.Trainer(cfg, tmp_path_factory.mktemp("run"), pp)
    te = tester.Tester(cfg, pp.get_model_configs(), device="cpu", chunk=256)
    te.params = t.params
    return t, te, raw["nerf_data"]


def test_train_one_iter_emits_the_stage_and_step_spans_in_order(tiny):
    t, _, _ = tiny
    profiling.enable()
    t.train_one_iter(0)
    recs = profiling.records()
    tops = ("train.stage",) + STEP_SPANS
    assert _names(recs, tops) == list(tops)
    parents = {r.name: r.parent for r in recs}
    assert parents["train.stage.indices"] == parents["train.stage.draws"] == "train.stage"
    assert all(parents[n] is None for n in tops)
    assert {r.parent for r in recs if r.name == "field.encode"} == {"step.forward"}
    # The four step spans follow each other and carry their device (CPU) time.
    steps = [r for r in recs if r.name in STEP_SPANS]
    assert all(a.t1_ns <= b.t0_ns for a, b in zip(steps, steps[1:]))
    assert all(r.device_ms is not None and r.device_ms >= 0 for r in steps)
    assert set(profiling.device_ms("step.")) == set(STEP_SPANS)


def test_predict_frame_emits_the_frame_spans_in_order(tiny):
    _, te, frames = tiny
    profiling.enable()
    te.predict_frame(frames["extrinsics"][1], intrinsic=frames["intrinsics"][1])
    recs = profiling.records()
    order = ["frame.rays", "frame.chunks", "frame.join", "frame.fetch.wait", "frame.fetch", "frame"]
    assert _names(recs, order) == order
    parents = {r.name: r.parent for r in recs}
    assert {parents[n] for n in order[:3] + order[4:5]} == {"frame"}
    assert parents["frame.fetch.wait"] == "frame.fetch" and parents["frame"] is None
    assert {r.parent for r in recs if r.name == "field.encode"} == {"frame.chunks"}
    assert all(r.device_ms is not None for r in recs if r.name in ("field.encode", "frame.join"))


# ---------------------------------------------------------------------------
# The benchmark's span readers
# ---------------------------------------------------------------------------

MS = 1_000_000


def _rec(name, parent, t0_ms, t1_ms, device_ms=None, thread=1):
    return profiling.SpanRecord(name, parent, thread, int(t0_ms * MS), int(t1_ms * MS), device_ms)


def _hand_made_log():
    """Three steps and three frames, with a thread of other work between."""
    recs = []
    for i, (stage, wait) in enumerate([(1.0, 0.25), (2.0, 0.5), (4.0, 0.0)]):
        t = 100.0 * i
        recs.append(_rec("train.stage.indices", "train.stage", t + 0.1, t + 0.2))
        if wait:
            recs.append(_rec("train.stage.wait", "train.stage", t + 0.3, t + 0.3 + wait))
        recs.append(_rec("train.stage", None, t, t + stage))
        recs.append(_rec("train.stage.wait", None, t + 0.1, t + 0.9, thread=2))  # not inside
    for i, (rays, fetch, wait, encs, join) in enumerate(
            [(3.0, 5.0, 1.0, (1.0, 2.0), 4.0), (6.0, 9.0, 2.0, (2.0, 2.0), 5.0),
             (9.0, 12.0, 3.0, (3.0, 4.0), 9.0)]):
        t = 1000.0 + 100.0 * i
        recs.append(_rec("frame.rays", "frame", t, t + rays))
        for j, e in enumerate(encs):
            recs.append(_rec("field.encode", "frame.chunks", t + 20 + j, t + 20.5 + j, device_ms=e))
        recs.append(_rec("frame.join", "frame", t + 30, t + 31, device_ms=join))
        recs.append(_rec("frame.fetch.wait", "frame.fetch", t + 40, t + 40 + wait))
        recs.append(_rec("frame.fetch", "frame", t + 40, t + 40 + fetch))
        recs.append(_rec("frame", None, t, t + 60))
    return recs


READINGS = {
    # stage less wait: 0.75, 1.5, 4.0
    "stage_host_ms.train": 1.5,
    "rays_host_ms.render": 6.0,
    # fetch less wait: 4, 7, 9
    "fetch_host_ms.render": 7.0,
    # encode sums: 3, 4, 7
    "encode_dev_ms.render": 4.0,
    "join_dev_ms.render": 5.0,
    "forward_dev_ms.train": 5.5,
    "loss_dev_ms.train": 1.25,
    "backward_dev_ms.train": 17.0,
    "adam_dev_ms.train": 0.75,
}
REPLAY = {"step.forward": 5.5, "step.losses": 1.25, "step.backward": 17.0, "step.adam": 0.75,
          "field.encode": 0.5}


@pytest.mark.parametrize("metric", list(READINGS))
def test_span_readers_give_none_empty_and_the_median_of_a_log(monkeypatch, metric):
    from benchmark import harness

    ctx = {"cell": "any"}
    assert harness.read_metric(metric, ctx) is None
    monkeypatch.setattr(profiling, "records", _hand_made_log)
    monkeypatch.setattr(profiling, "replay_ms", lambda: dict(REPLAY))
    got = harness.read_metric(metric, ctx)
    assert got == pytest.approx(READINGS[metric], abs=1e-9)


def test_span_readers_give_none_without_the_tracer(monkeypatch):
    from benchmark import harness

    monkeypatch.delattr(profiling, "records")
    assert all(harness.read_metric(m, {}) is None for m in READINGS)


# ---------------------------------------------------------------------------
# On the card: a captured step's markers
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _graph_trainer(tmp_path):
    from simplenerf_torch.data.factory import get_data_loader
    from simplenerf_torch.data.preprocessor import ScenePreprocessor
    from simplenerf_torch.data.synthetic import generate_scene
    from simplenerf_torch.drivers import presets
    from simplenerf_torch.training.trainer import Trainer

    generate_scene(tmp_path / "db", num_frames=5, h=24, w=32, num_train=3, seed=3)
    cfg = presets.tiny_synthetic_config(num_rays=1024, sparse_depth_rays=512,
                                        consistency_start_iter=2, compute_dtype="bfloat16")
    cfg["resume_training"] = False
    raw = get_data_loader(cfg, tmp_path / "db", "train").load_data()
    return Trainer(cfg, tmp_path / "run", ScenePreprocessor(cfg, "train", raw, device="cuda"))


@pytest.mark.cuda
def test_graph_markers_are_external_and_retimed_by_each_replay(cuda_device, tmp_path):
    t = _graph_trainer(tmp_path)
    t.train_many(0, 2)  # warm-up step, capture, one replay
    markers = t._graph.markers
    assert set(STEP_SPANS) <= set(markers.pairs) and markers.replays == 1
    readings = []
    for it in (2, 4, 6):
        before = torch.cuda.Event(enable_timing=True)
        before.record()
        t.train_many(it, 2)  # two replays
        torch.cuda.synchronize()
        ms = profiling.replay_ms()
        # Recorded by this call's last replay, after `before`: an event
        # recorded only at the capture would read before it.
        start = markers.pairs["step.forward"][0][0]
        assert before.elapsed_time(start) > 0
        assert all(math.isfinite(v) and v > 0 for v in ms.values()), ms
        readings.append(ms)
    print(torch.__version__, readings)
    assert readings[0] != readings[1] or readings[1] != readings[2]


@pytest.mark.cuda
def test_graph_markers_cover_the_replay(cuda_device, tmp_path):
    t = _graph_trainer(tmp_path)
    t.train_many(0, 2)
    graph = t._graph
    for _ in range(3):
        graph.replay()
    whole = []
    parts = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        ms = profiling.replay_ms()
        whole.append(a.elapsed_time(b))
        parts.append(sum(ms[n] for n in STEP_SPANS))
    print("markers", parts, "replay", whole)
    for p, w in zip(parts, whole):
        assert abs(p - w) <= 0.03 * w, (p, w)
