"""The port's CUDA kernel against its plain PyTorch version, on the card.

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


def test_kernel_refuses_grad(cuda_device):
    cfg = mlp.MLPConfig(**SMALL)
    spec, kp, lo, hi, hvx = _operands(cfg, 4, 8, torch.float32, cuda_device)
    kp = {k: v.requires_grad_() for k, v in kp.items()}
    with pytest.raises(NotImplementedError):
        fused_mlp.fused_apply(spec, kp, lo, hi, hvx)
