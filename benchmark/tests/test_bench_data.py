"""The benchmark is data: every cell, configuration, traffic mix, limit and
per-layer metric is a file found by its name, and BENCHMARK.json keeps to
the contract's shapes."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in [c["why"] for c in BENCH["configs"] + BENCH["workloads"]] + [
            m["layer"] for m in BENCH["per_layer"]] + [c["source"] for c in BENCH["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_entry_keys_and_bounds():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (harness.ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in names and m["moves"] != "setup_s"


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_are_found_by_name(name):
    cell = harness.Cell(name)
    e2e = [m["name"] for m in cell.end_to_end()]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer()
    for m in cell.per_layer():
        assert m["moves"] in e2e, (name, m["name"])
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
    assert cell.limits and cell.traffic["metric"] in e2e
    kind = cell.kind()
    for fn in ("setup", "window", "traced", "release", "check"):
        assert callable(getattr(kind, fn)), (cell.traffic["kind"], fn)


def test_every_per_layer_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        assert harness.read_metric(m["name"], {}) is None, m["name"]


def test_config_files_hold_the_published_recipe():
    from simplenerf_torch.drivers.llff import build_configs

    for c in BENCH["configs"]:
        cfg = harness.load_json(harness.ROOT / c["file"])
        dtype = cfg["train_configs"]["model"]["compute_dtype"]
        want, _ = build_configs(views=3, scenes=None, iters=100000, compute_dtype=dtype, seed=0)
        assert cfg["train_configs"] == json.loads(json.dumps(want)), c["name"]


def test_adding_a_cell_and_a_metric_needs_no_edit(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    traffic = dict(harness.load_json(harness.HERE / "traffic" / "train.json"), steps_per_call=10)
    (tmp_path / "benchmark" / "traffic" / "train10.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark" / "limits" / "simplenerf_f32.train10.json").write_text('{"loss_gap": 1}')
    (tmp_path / "benchmark" / "metrics" / "new_metric.train10.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    bench["workloads"].append({"name": "simplenerf_f32.train10", "config": "simplenerf_f32",
                               "traffic": "train10", "chips": 1, "why": "a later cell"})
    bench["per_layer"].append({"name": "new_metric.train10", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "Harness",
                               "moves": "train_rays_per_s", "workloads": ["simplenerf_f32.train10"]})
    bench["end_to_end"][0]["workloads"].append("simplenerf_f32.train10")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys; sys.path.insert(0, '.'); from benchmark import harness; "
            "c = harness.Cell('simplenerf_f32.train10'); "
            "print(c.traffic['steps_per_call'], [m['name'] for m in c.per_layer()][-1], "
            "harness.read_metric('new_metric.train10', {}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["10", "new_metric.train10", "42.0"]


TOY_KIND = """
def setup(cell, seed, device, workdir):
    return {"seed": seed}

def window(st, cell, seconds, device):
    return 7, 3.5, ["toy window"]

def traced(st, cell, device, workdir):
    return {"attempted": 7, "window": {"window_s": 1.0, "busy_s": 0.5, "device_ops": [],
                                       "idle_gaps": []}}

def release(st):
    pass

def check(st, cell, seed, device):
    return {"numbers": {"toy_gap": 0.0}}
"""


def test_adding_a_kind_of_traffic_needs_no_edit(tmp_path):
    """A traffic file naming a new kind, and kinds/<kind>.py, run a cell."""
    shutil.copytree(harness.HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    (tmp_path / "benchmark" / "kinds" / "toy.py").write_text(TOY_KIND)
    (tmp_path / "benchmark" / "traffic" / "toy.json").write_text('{"kind": "toy", "metric": "toy_rate"}')
    (tmp_path / "benchmark" / "limits" / "simplenerf_f32.toy.json").write_text('{"toy_gap": 0.1}')
    bench["workloads"].append({"name": "simplenerf_f32.toy", "config": "simplenerf_f32",
                               "traffic": "toy", "chips": 1, "why": "a later kind of traffic"})
    bench["end_to_end"].append({"name": "toy_rate", "unit": "1/s", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["simplenerf_f32.toy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, json, time, torch; sys.path.insert(0, '.'); from benchmark import harness; "
            "r = harness.run(harness.Cell('simplenerf_f32.toy'), 5, 1.0, False, torch.device('cpu'), "
            "time.perf_counter(), forbid=False); print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["attempted"] == 7
    assert res["metrics"]["toy_rate"]["value"] == 3.5 and "setup_s" in res["metrics"]


def test_run_refuses_without_the_program(tmp_path):
    """A checkout with only BENCHMARK.json and benchmark/ exits non-zero
    and prints no result."""
    shutil.copytree(harness.HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
