"""The reference agrees with the port's CPU path at a tiny size: a whole
run of each kind of cell on the CPU, the program's readings against the
reference's. The limits are set for the card at the cell's own size; at a
tiny size a bf16 product sums few terms and the port's CPU path rounds its
backward otherwise than its kernels, so bf16 is held to tolerances of its
own here, float32 to its limits."""

import pytest

TIGHT = {  # CPU at a tiny size: float32 to rounding, bf16 to its rounding
    "simplenerf_f32.train": {"loss1_gap": 1e-5, "grad_gap": 1e-4, "grad_gap_median": 1e-5,
                             "delta_gap": 1e-4},
    "simplenerf_bf16.train": {"grad_gap": 5e-2, "grad_gap_median": 5e-3, "delta_gap": 5e-2},
    "simplenerf_bf16.render": {"image_mae": 0.1, "depth_ndc_max": 1e-4},
}


@pytest.mark.parametrize("name", sorted(TIGHT))
def test_reference_agrees_with_the_port_on_the_cpu(name, tiny_cell, run_tiny):
    res = run_tiny(tiny_cell(name))
    assert res["attempted"] > 0
    for key, tight in TIGHT[name].items():
        assert res["checks"][key]["value"] <= tight, (key, res["checks"][key])
    assert list(res)[-1] == "checks"
    if name == "simplenerf_f32.train":
        assert res["correct"] is True and res["failed"] == 0


@pytest.mark.parametrize("name", ["simplenerf_bf16.train", "simplenerf_bf16.render"])
def test_traced_run_reports_its_per_layer_metrics(name, tiny_cell, run_tiny):
    """On the CPU the device readers find no kernel; the host's readings
    are there, and only metrics that list the cell."""
    cell = tiny_cell(name)
    res = run_tiny(cell, traced=True)
    listed = {m["name"] for m in cell.per_layer()}
    assert res["metrics"] and set(res["metrics"]) <= listed
    if name.endswith(".render"):
        assert "frame_host_ms.render" in res["metrics"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    assert res["correct"] is True or name == "simplenerf_bf16.train", res["checks"]
