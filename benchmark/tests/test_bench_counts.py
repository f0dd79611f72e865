"""The FLOP and byte counts against hand counts at a tiny shape."""

import pytest

from benchmark import counts

MLP = {"points_net_depth": 8, "views_net_depth": 1, "points_net_width": 4, "views_net_width": 2,
       "points_positional_encoding_degree": 1, "views_positional_encoding_degree": 1,
       "use_view_dirs": True, "view_dependent_rgb": True, "predict_visibility": False,
       "num_samples": 2}
AUG = dict(MLP, points_sigma_positional_encoding_degree=0)
LAMB = dict(MLP, use_view_dirs=False, view_dependent_rgb=False)


def test_forward_macs_by_hand():
    # lo 9 -> 4; six 4x4 layers and layer 5 with 9 skip rows; sigma 4x1;
    # feature 4x4; views 4x2 (dirs outside); rgb 2x3.
    assert counts.fwd_macs(MLP) == 9 * 4 + 7 * 16 + 9 * 4 + 4 + 16 + 4 * 2 + 2 * 3
    # sigma PE 0: lo 3, the 6 high channels go to the views layer.
    assert counts.fwd_macs(AUG) == 3 * 4 + 7 * 16 + 3 * 4 + 4 + 16 + (4 + 6) * 2 + 2 * 3
    # Lambertian: points head of 4, no views branch.
    assert counts.fwd_macs(LAMB) == 9 * 4 + 7 * 16 + 9 * 4 + 4 * 4


def test_param_counts_by_hand():
    base = (9 + 1) * 4 + 7 * (16 + 4) + 9 * 4 + (4 + 1) * 1 + (16 + 4)
    assert counts.param_count(MLP) == base + (4 + 1) * 2 + (2 + 1) * 3  # no dirs rows


@pytest.mark.parametrize("dtype,cb", [("bfloat16", 2), ("float32", 4)])
def test_op_bytes_and_flops_by_hand(dtype, cb):
    nr, ns = 5, 2
    n = nr * ns
    f = counts.fwd_op([MLP], nr, ns, dtype)
    assert f["flops"] == 2 * n * counts.fwd_macs(MLP)
    want = n * 9 * cb + nr * 2 * 4 + 4 * counts.param_count(MLP) + n * 4 * 4
    assert f["bytes"] == want
    b = counts.bwd_op([MLP], nr, ns, dtype)
    assert b["flops"] == 2 * n * (3 * counts.fwd_macs(MLP) - (2 * 9 * 4))
    assert b["bytes"] == want + 4 * counts.param_count(MLP) + nr * 2 * 4
    e = counts.fwd_op([MLP, AUG, LAMB], nr, ns, dtype)  # one shared PE block of 9 channels
    assert e["bytes"] == (n * 9 * cb + 2 * nr * 2 * 4
                          + 4 * sum(counts.param_count(m) for m in (MLP, AUG, LAMB))
                          + n * (4 + 4 + 4) * 4)


def test_bound_takes_the_larger_time():
    op = {"flops": 989e12, "bytes": 3.35e12 / 2}
    assert counts.bound_s(op, "bfloat16") == pytest.approx(1.0)
    assert counts.bound_s(op, "float32") == pytest.approx(989 / 494.7)


def test_step_and_frame_flops_by_hand():
    mlps = {"coarse": MLP, "fine": dict(MLP, num_samples=3), "points_aug_coarse": AUG,
            "views_aug_coarse": LAMB}
    nr = 7
    per = lambda m: 3 * counts.fwd_macs(m) - counts._input_macs(counts.mlp_dims(m))  # noqa: E731
    dirs = 9 * 2
    want = 2 * (nr * 2 * per(MLP) + 2 * nr * dirs) + 2 * (nr * 5 * per(MLP) + 2 * nr * dirs)
    want += 2 * nr * 2 * per(AUG) + 2 * (nr * 2 * per(LAMB))
    want += 2 * 2 * nr * dirs  # AUG has view dirs too
    assert counts.train_step_flops(mlps, nr) == want
    assert counts.frame_flops(mlps, nr) == 2 * nr * (2 * counts.fwd_macs(MLP) + dirs) + 2 * nr * (
        5 * counts.fwd_macs(MLP) + dirs)
