"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Card-only: every test here carries the `cuda` marker and skips (inside the
`cuda_device` fixture, never at import) where no CUDA device exists. This
file imports no JAX, so on a machine without JAX it runs with

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerances, max abs error on the raw head planes: float32 products on the
card accumulate in another order than the plain version's matmul, hence
1e-5. In bf16 an order difference can flip one bf16 rounding of an
activation (2^-8 relative) and the flips propagate through the layers,
hence 2e-3. Each is a few times the largest error these cases read on the
card, which `-s` prints, and well below what a broken kernel reads (see
tools/probe_fused_mlp.py).

Gradients (backward kernels): every dW, db and dhvx as ||got - want|| /
||want||, GRAD_TOL per dtype and group (weights: dW and db; dhvx), the
measure of chip_smoke.py. Besides the order of the row sums, an activation
within rounding of 0 can take the other side of the ReLU in the two
versions, which moves one row's term of a sum by its full size; a norm
over the whole tensor keeps one such term small. The limits are
chip_smoke.py's: these cases read at most 1.2e-6 (float32) and 5.9e-3
(bf16) on the card, chip_smoke.py's published-width cases up to 9.8e-4 and
5.6e-3, and a kernel that drops a ragged last tile of rows reads 2.5e-2
and more (tools/probe_fused_mlp_bwd.py; PERF.md).
"""

import pytest
import torch

from simplenerf_torch.fields import mlp
from simplenerf_torch.ops import fused_mlp

pytestmark = pytest.mark.cuda

SMALL = dict(
    points_net_depth=4, views_net_depth=1, points_net_width=64, views_net_width=64,
    points_pe_degree=10, views_pe_degree=4, use_view_dirs=True, view_dependent_rgb=True,
    skip_layers=(2,),
)
CASES = {
    "main": {},
    "points_aug": dict(points_sigma_pe_degree=3),
    "lambertian": dict(use_view_dirs=False, view_dependent_rgb=False),
    "visibility": dict(predict_visibility=True),
    "two_skips": dict(points_net_depth=5, skip_layers=(1, 3)),
    "published": dict(points_net_depth=8, points_net_width=256, views_net_width=128,
                      skip_layers=(4,)),
}
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}
GRAD_TOL = {torch.float32: {"weights": 3e-3, "dhvx": 1e-3},
            torch.bfloat16: {"weights": 1.2e-2, "dhvx": 8e-3}}
TRIO = ("main", "points_aug", "lambertian")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(cfg, nr, ns, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = mlp.init(g, cfg, device=device)
    pts = torch.randn((nr * ns, 3), generator=g).to(device)
    dirs = torch.nn.functional.normalize(torch.randn((nr, 3), generator=g), dim=-1).to(device)
    return mlp.fused_operands(params, cfg, pts, dirs, ns, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("ns", [5, 64, 192])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain(cuda_device, name, ns, dtype):
    cfg = mlp.MLPConfig(**{**SMALL, **CASES[name]})
    nr = 6 if ns == 5 else 37  # ray counts that no block size divides
    spec, kp, lo, hi, hvx = _operands(cfg, nr, ns, dtype, cuda_device)
    before = fused_mlp.fused_apply.launches
    got = fused_mlp.fused_apply(spec, kp, lo, hi, hvx)
    torch.cuda.synchronize()
    assert fused_mlp.fused_apply.launches == before + 1
    want = fused_mlp.fused_apply_reference(spec, kp, lo, hi, hvx)
    assert len(got) == len(want) == spec.n_planes
    for j, (a, b) in enumerate(zip(got, want)):
        assert a.shape == (nr, ns)
        err = (a - b).abs().max().item()
        print(f"{name} ns={ns} {dtype} plane {j}: max abs err {err:.3e}, plane up to "
              f"{b.abs().max().item():.3e}")
        assert err <= TOL[dtype], f"{name} plane {j}: max abs err {err}"


def _norm_err(got, want) -> float:
    err = (got.double() - want.double()).norm().nan_to_num(float("inf")).item()
    return err / max(want.double().norm().item(), 1e-30)


def _grad_errors(label, got: dict, want: dict, dtype):
    for k in want:
        err = _norm_err(got[k], want[k])
        tol = GRAD_TOL[dtype]["dhvx" if "dhvx" in k else "weights"]
        print(f"{label} {dtype} {k}: norm err {err:.3e}")
        assert err <= tol, f"{label} {k}: norm err {err}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("ns", [5, 64, 192])
@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_kernel_matches_plain(cuda_device, name, ns, dtype):
    cfg = mlp.MLPConfig(**{**SMALL, **CASES[name]})
    nr = 6 if ns == 5 else 37
    spec, kp, lo, hi, hvx = _operands(cfg, nr, ns, dtype, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    d_planes = torch.randn((spec.n_planes, nr, ns), generator=g, device=cuda_device)
    before = fused_mlp.fused_bwd.launches
    dkp, dhvx = fused_mlp.fused_bwd(spec, kp, lo, hi, hvx, d_planes)
    torch.cuda.synchronize()
    assert fused_mlp.fused_bwd.launches == before + 1
    want, want_hvx = fused_mlp.fused_bwd_reference(spec, kp, lo, hi, hvx, d_planes)
    assert list(dkp) == spec.param_keys()
    for k in want:
        assert dkp[k].shape == kp[k].shape and dkp[k].dtype == torch.float32, k
    if spec.has_hvx:
        dkp["dhvx"], want["dhvx"] = dhvx, want_hvx
    _grad_errors(f"bwd {name} ns={ns}", dkp, want, dtype)
    # Twice on the same inputs: the fixed-order sums give the same bits.
    again, _ = fused_mlp.fused_bwd(spec, kp, lo, hi, hvx, d_planes)
    assert all(torch.equal(again[k], dkp[k]) for k in again)


def _ensemble(nr, ns, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    members = []
    for name in TRIO:
        cfg = mlp.MLPConfig(**{**SMALL, **CASES[name]})
        members.append((mlp.init(g, cfg, device=device), cfg))
    pts = torch.randn((nr * ns, 3), generator=g).to(device)
    dirs = torch.nn.functional.normalize(torch.randn((nr, 3), generator=g), dim=-1).to(device)
    return mlp.ensemble_operands(members, pts, dirs, ns, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("ns", [5, 64])
def test_ensemble_kernels_match_plain(cuda_device, ns, dtype):
    nr = 6 if ns == 5 else 37
    ens, kps, lo, hvxs = _ensemble(nr, ns, dtype, cuda_device)
    before = fused_mlp.fused_apply_ensemble.launches
    got = fused_mlp.fused_apply_ensemble(ens, kps, lo, hvxs)
    torch.cuda.synchronize()
    assert fused_mlp.fused_apply_ensemble.launches == before + 1
    want = fused_mlp.fused_apply_ensemble_reference(ens, kps, lo, hvxs)
    assert len(got) == len(want) == ens.n_planes
    for j, (a, b) in enumerate(zip(got, want)):
        err = (a - b).abs().max().item()
        print(f"ensemble ns={ns} {dtype} plane {j}: max abs err {err:.3e}")
        assert err <= TOL[dtype], f"plane {j}: max abs err {err}"
    g = torch.Generator(device=cuda_device).manual_seed(2)
    d_planes = torch.randn((ens.n_planes, nr, ns), generator=g, device=cuda_device)
    before = fused_mlp.fused_ens_bwd.launches
    dkps, dhvxs = fused_mlp.fused_ens_bwd(ens, kps, lo, hvxs, d_planes)
    torch.cuda.synchronize()
    assert fused_mlp.fused_ens_bwd.launches == before + 1
    want_kps, want_hvxs = fused_mlp.fused_ens_bwd_reference(ens, kps, lo, hvxs, d_planes)
    for name, dkp, wkp in zip(TRIO, dkps, want_kps):
        _grad_errors(f"ens bwd {name} ns={ns}", dkp, wkp, dtype)
    assert len(dhvxs) == len(want_hvxs) == len(ens.hvx_members)
    for a, b in zip(dhvxs, want_hvxs):
        _grad_errors(f"ens bwd ns={ns}", {"dhvx": a}, {"dhvx": b}, dtype)


def test_autograd_runs_both_kernels(cuda_device):
    """fused_apply under autograd: the forward kernel, then the backward one."""
    cfg = mlp.MLPConfig(**SMALL)
    spec, kp, lo, hi, hvx = _operands(cfg, 6, 5, torch.float32, cuda_device)
    kp = {k: v.clone().requires_grad_() for k, v in kp.items()}
    f0, b0 = fused_mlp.fused_apply.launches, fused_mlp.fused_bwd.launches
    planes = fused_mlp.fused_apply(spec, kp, lo, hi, hvx)
    planes[0].sum().backward()  # the other planes get no cotangent
    torch.cuda.synchronize()
    assert (fused_mlp.fused_apply.launches, fused_mlp.fused_bwd.launches) == (f0 + 1, b0 + 1)
    ones = torch.ones_like(planes[0])
    want, _ = fused_mlp.fused_bwd_reference(
        spec, {k: v.detach() for k, v in kp.items()}, lo, hi, hvx,
        [ones] + [None] * (spec.n_planes - 1))
    _grad_errors("autograd", {k: v.grad for k, v in kp.items()}, want, torch.float32)


def test_backward_kernels_with_no_rows(cuda_device):
    """0 rows: zero gradients shaped like the params, no launch."""
    cfg = mlp.MLPConfig(**SMALL)
    spec, kp, lo, hi, hvx = _operands(cfg, 0, 5, torch.float32, cuda_device)
    before = fused_mlp.fused_bwd.launches
    dkp, dhvx = fused_mlp.fused_bwd(spec, kp, lo, hi, hvx, torch.zeros((spec.n_planes, 0, 5),
                                                                       device=cuda_device))
    assert fused_mlp.fused_bwd.launches == before
    assert all(dkp[k].shape == kp[k].shape and not dkp[k].any() for k in spec.param_keys())
    assert dhvx.shape == (0, spec.views_width)
    ens, kps, lo, hvxs = _ensemble(0, 5, torch.float32, cuda_device)
    before = fused_mlp.fused_ens_bwd.launches
    dkps, dhvxs = fused_mlp.fused_ens_bwd(ens, kps, lo, hvxs,
                                          torch.zeros((ens.n_planes, 0, 5), device=cuda_device))
    assert fused_mlp.fused_ens_bwd.launches == before
    assert len(dkps) == len(TRIO) and len(dhvxs) == len(ens.hvx_members)
    for m, dkp, kp in zip(ens.members, dkps, kps):
        assert all(dkp[k].shape == kp[k].shape and not dkp[k].any() for k in m.param_keys())


def test_sampling_draws_with_a_card_generator(cuda_device):
    from simplenerf_torch.render import sampling

    near = torch.full((7, 1), 0.5, device=cuda_device)
    far = torch.full((7, 1), 4.0, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    z = sampling.stratified_z_vals(near, far, 16, perturb=True, generator=g)
    weights = torch.rand((7, 16), device=cuda_device)
    fine = sampling.fine_z_vals(z, weights, 24, perturb=True, generator=g)
    assert z.is_cuda and fine.is_cuda and fine.shape == (7, 40)
    g2 = torch.Generator(device=cuda_device).manual_seed(3)
    torch.testing.assert_close(sampling.stratified_z_vals(near, far, 16, perturb=True, generator=g2), z)
