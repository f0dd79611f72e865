"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Card-only: every test here carries the `cuda` marker and skips (inside the
`cuda_device` fixture, never at import) where no CUDA device exists. This
file imports no JAX, so on a machine without JAX it runs with

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerances, max abs error on the raw head planes: float32 products on the
card (3xTF32 on the tensor cores) accumulate in another order and with
other roundings than the plain version's matmul, hence 1e-5. In bf16 an order difference can flip one bf16 rounding of an
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
chip_smoke.py's (readings: PERF.md), and a kernel that drops a ragged last
tile of rows reads 2.5e-2 and more (tools/probe_fused_mlp_bwd.py). The
float32 kernels are also held to chip_smoke.py's float64 yardstick: their
error against the plain version in float64 at most YARDSTICK times the
float32 plain version's; test_backward_kernel_matches_plain holds float32
against the plain version in float64, since at its few thousand rows the
float32 plain version's own ReLU flips exceed GRAD_TOL.

The PE operand pass (`fused_mlp.pe_operands`) equals its plain version,
the float32 sin / cos / cast / cat chain, bit for bit: the same exact
product, the same accurate sin and cos, the same rounding to bfloat16.

Training steps as one CUDA graph (`Trainer.train_many`, tiny preset with
draws on, f32 and bf16): K replayed steps against K loop steps, a resumed
graph run against an uninterrupted one and a recapture after `set_params`
against a fresh Trainer, each parameters, Adam's mu, nu and count (and loss
values) no further from the reference than a second reference run is, both
printed (the two are expected equal to the bit); the capture's stash inside
the graph's memory pool; the launch counters at one launch of each kernel
per replayed step.
"""

import dataclasses

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
YARDSTICK = 4.0  # chip_smoke.YARDSTICK
DTYPES = dict(argnames="dtype", argvalues=[torch.float32, torch.bfloat16], ids=["f32", "bf16"])


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
@pytest.mark.parametrize("ns", [1, 5, 64, 192])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain(cuda_device, name, ns, dtype):
    """ns = 1 at the published width reads hvx from global memory in the
    bf16 kernel (its rows do not fit beside the ring); the others stage it."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("widths", [(48, 64), (160, 128), (64, 80)],
                         ids=["trunk48", "trunk160", "views80"])
def test_kernel_pads_widths(cuda_device, widths, dtype):
    """Widths that the bf16 engine pads to a wgmma width (48 -> 64,
    160 -> 256, views 80 -> 128): the padded columns stay out of every
    plane."""
    width, views_width = widths
    cfg = mlp.MLPConfig(**{**SMALL, "points_net_width": width, "views_net_width": views_width})
    nr, ns = 37, 64
    spec, kp, lo, hi, hvx = _operands(cfg, nr, ns, dtype, cuda_device)
    before = fused_mlp.fused_apply.launches
    got = fused_mlp.fused_apply(spec, kp, lo, hi, hvx)
    torch.cuda.synchronize()
    assert fused_mlp.fused_apply.launches == before + 1
    want = fused_mlp.fused_apply_reference(spec, kp, lo, hi, hvx)
    for j, (a, b) in enumerate(zip(got, want)):
        err = (a - b).abs().max().item()
        print(f"widths {widths} {dtype} plane {j}: max abs err {err:.3e}")
        assert err <= TOL[dtype], f"widths {widths} plane {j}: max abs err {err}"


# The bf16 forward's engine (activations in registers, the consumers in
# ping-pong) on the published programs: the fine and coarse MLP, the coarse
# trio and ViP-NeRF's MLP through its kPre instance (secondary views, k =
# 2), at a render chunk (65,536 rays; ViP-NeRF, which renders no secondary
# views outside training, at its training step's 4096) and at 37 rays,
# whose rows are no multiple of a block's 128 and whose blocks start inside
# rays; with the hvx rows staged in shared memory, as the plan gives them,
# and read from global memory.
PINGPONG = {"fine": 192, "coarse": 64, "trio": 64, "vipnerf": 192}


def _hvx_from_global(monkeypatch):
    """The forward's plans without staged hvx rows: the epilogue reads hvx
    from global memory (the plan's choice where the rows do not fit)."""
    real = fused_mlp._sm90_on

    def unstaged(spec, dev):
        plan, w_index, f_index = real(spec, dev)
        words = plan.words.copy()
        assert words[11] > 0  # every published program stages them
        shrink = 2 * 4 * (int(words[12]) - fused_mlp._SM90_BIAS)
        words[11], words[12] = 0, fused_mlp._SM90_BIAS
        return dataclasses.replace(plan, words=words, smem=plan.smem - shrink), w_index, f_index

    monkeypatch.setattr(fused_mlp, "_sm90_on", unstaged)


@pytest.mark.parametrize("staged", [True, False], ids=["staged", "global"])
@pytest.mark.parametrize("rays", ["chunk", "ragged"])
@pytest.mark.parametrize("program", list(PINGPONG))
def test_pingpong_engine_matches_plain(cuda_device, monkeypatch, program, rays, staged):
    ns = PINGPONG[program]
    nr = 37 if rays == "ragged" else 4096 if program == "vipnerf" else 65536
    if not staged:
        _hvx_from_global(monkeypatch)
    published = mlp.MLPConfig(**{**SMALL, **CASES["published"]})
    before = fused_mlp.launch_counts()
    if program == "trio":
        g = torch.Generator().manual_seed(nr)
        cfgs = [mlp.MLPConfig(**{**SMALL, **CASES["published"], **CASES[n]}) for n in TRIO]
        members = [(mlp.init(g, c, device=cuda_device), c) for c in cfgs]
        pts = torch.randn((nr * ns, 3), generator=g).to(cuda_device)
        dirs = torch.nn.functional.normalize(torch.randn((nr, 3), generator=g), dim=-1).to(cuda_device)
        ens, kps, lo, hvxs = mlp.ensemble_operands(members, pts, dirs, ns, torch.bfloat16)
        got = fused_mlp.fused_apply_ensemble(ens, kps, lo, hvxs)
        wrapper = "fused_apply_ensemble"
        torch.cuda.synchronize()
        want = fused_mlp.fused_apply_ensemble_reference(ens, kps, lo, hvxs)
    elif program == "vipnerf":
        cfg = mlp.MLPConfig(**{**SMALL, **SEC_CASES["published"]})
        (spec, kp, lo, hi, hvx), sec = _sec_operands(cfg, nr, ns, 2, cuda_device, seed=nr)
        got = fused_mlp.fused_apply(spec, kp, lo, hi, hvx, sec=sec)
        wrapper = "fused_apply"
        torch.cuda.synchronize()
        want = fused_mlp.fused_apply_reference(spec, kp, lo, hi, hvx, sec)
    else:
        spec, kp, lo, hi, hvx = _operands(published, nr, ns, torch.bfloat16, cuda_device, seed=nr)
        got = fused_mlp.fused_apply(spec, kp, lo, hi, hvx)
        wrapper = "fused_apply"
        torch.cuda.synchronize()
        want = fused_mlp.fused_apply_reference(spec, kp, lo, hi, hvx)
    after = fused_mlp.launch_counts()
    assert after[wrapper] - before[wrapper] == 1
    assert len(got) == len(want)
    for j, (a, b) in enumerate(zip(got, want)):
        assert a.shape == (nr, ns)
        err = (a - b).abs().max().item()
        print(f"ping-pong {program} {nr}x{ns} hvx {'staged' if staged else 'global'} plane {j}: "
              f"max abs err {err:.3e}")
        assert err <= TOL[torch.bfloat16], f"plane {j}: max abs err {err}"


def _double(x):
    if isinstance(x, dict):
        return {k: _double(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_double(v) for v in x)
    return x.double() if isinstance(x, torch.Tensor) else x


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
    """bf16 against the plain version in bf16; float32 against the plain
    version evaluated in float64. The float32 plain version rounds in its
    own order, so an activation within rounding of 0 can fall on the other
    side of its ReLU there, and with a few thousand rows one such row is
    over GRAD_TOL: at 37 x 64 at the published widths it is 9.2e-3 from
    float64 where the 3xTF32 kernel is 1.4e-6 (PERF.md, PR 12)."""
    cfg = mlp.MLPConfig(**{**SMALL, **CASES[name]})
    nr = 6 if ns == 5 else 37
    spec, kp, lo, hi, hvx = _operands(cfg, nr, ns, dtype, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    d_planes = torch.randn((spec.n_planes, nr, ns), generator=g, device=cuda_device)
    before = fused_mlp.fused_bwd.launches
    dkp, dhvx = fused_mlp.fused_bwd(spec, kp, lo, hi, hvx, d_planes)
    torch.cuda.synchronize()
    assert fused_mlp.fused_bwd.launches == before + 1
    plain = (spec, kp, lo, hi, hvx, d_planes)
    if dtype == torch.float32:
        plain = (fused_mlp.with_dtype(spec, "float64"), *_double(plain[1:]))
    want, want_hvx = fused_mlp.fused_bwd_reference(*plain)
    assert list(dkp) == spec.param_keys()
    for k in want:
        assert dkp[k].shape == kp[k].shape and dkp[k].dtype == torch.float32, k
    if spec.has_hvx:
        dkp["dhvx"], want["dhvx"] = dhvx, want_hvx
    _grad_errors(f"bwd {name} ns={ns}", dkp, want, dtype)
    # Twice on the same inputs: the fixed-order sums give the same bits.
    again, again_hvx = fused_mlp.fused_bwd(spec, kp, lo, hi, hvx, d_planes)
    assert all(torch.equal(again[k], dkp[k]) for k in again)
    if spec.has_hvx:
        assert torch.equal(again_hvx, dhvx)


def _ensemble(nr, ns, dtype, device, seed=0, trio=TRIO):
    g = torch.Generator().manual_seed(seed)
    members = []
    for name in trio:
        cfg = mlp.MLPConfig(**{**SMALL, **CASES[name]})
        members.append((mlp.init(g, cfg, device=device), cfg))
    pts = torch.randn((nr * ns, 3), generator=g).to(device)
    dirs = torch.nn.functional.normalize(torch.randn((nr, 3), generator=g), dim=-1).to(device)
    return mlp.ensemble_operands(members, pts, dirs, ns, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("ns", [5, 64])
def test_ensemble_kernels_match_plain(cuda_device, ns, dtype):
    _check_ensemble(TRIO, ns, dtype, cuda_device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("ns", [5, 64])
def test_visibility_trio_kernels_match_plain(cuda_device, ns, dtype):
    """The coarse trio with a visibility head on its main member: a views
    head of 4 channels beside the points-augmentation member's 3."""
    trio = ("visibility", "points_aug", "lambertian")
    ens = _ensemble(1, ns, dtype, cuda_device, trio=trio)[0]
    assert [m.out_v for m in ens.members] == [4, 3, 0]
    _check_ensemble(trio, ns, dtype, cuda_device)


def _check_ensemble(trio, ns, dtype, cuda_device):
    """Both ensemble kernels of `trio` against their plain versions."""
    nr = 6 if ns == 5 else 37
    ens, kps, lo, hvxs = _ensemble(nr, ns, dtype, cuda_device, trio=trio)
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
    for name, dkp, wkp in zip(trio, dkps, want_kps):
        _grad_errors(f"ens bwd {name} ns={ns}", dkp, wkp, dtype)
    assert len(dhvxs) == len(want_hvxs) == len(ens.hvx_members)
    for a, b in zip(dhvxs, want_hvxs):
        _grad_errors(f"ens bwd ns={ns}", {"dhvx": a}, {"dhvx": b}, dtype)
    again, again_hvx = fused_mlp.fused_ens_bwd(ens, kps, lo, hvxs, d_planes)
    for a, b in zip(again, dkps):
        assert all(torch.equal(a[k], b[k]) for k in b)
    assert all(torch.equal(a, b) for a, b in zip(again_hvx, dhvxs))


def _check_bwd(label, spec, kp, lo, hi, hvx, nr, ns, dtype, device, seed=1):
    """One backward launch against the plain backward, then a second launch
    on the same inputs, which must give the same bits."""
    g = torch.Generator(device=device).manual_seed(seed)
    d_planes = torch.randn((spec.n_planes, nr, ns), generator=g, device=device)
    before = fused_mlp.fused_bwd.launches
    dkp, dhvx = fused_mlp.fused_bwd(spec, kp, lo, hi, hvx, d_planes)
    torch.cuda.synchronize()
    assert fused_mlp.fused_bwd.launches == before + 1
    want, want_hvx = fused_mlp.fused_bwd_reference(spec, kp, lo, hi, hvx, d_planes)
    got = dict(dkp)
    if spec.has_hvx:
        got["dhvx"], want["dhvx"] = dhvx, want_hvx
    _grad_errors(label, got, want, dtype)
    again, again_hvx = fused_mlp.fused_bwd(spec, kp, lo, hi, hvx, d_planes)
    assert all(torch.equal(again[k], dkp[k]) for k in dkp), "two launches differ"
    if spec.has_hvx:
        assert torch.equal(again_hvx, dhvx), "two launches differ in dhvx"


# The row passes (bf16 fused_mlp_bwd_rows_sm90_kernel, float32
# fused_mlp_bwd_rows_tf32_kernel): 128-row blocks of two 64-row consumers,
# so row counts that leave a block's second consumer ragged or empty, one
# sample per ray (each row its own hvx row), the widths their wgmma pads
# (48 -> 64, 160 -> 256, views 80 -> 128), the published widths at the
# per-rank shapes of two-rank training (2048 rays), the trio.
@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("rows", [37, 1037, 5000])
@pytest.mark.parametrize("name", ["main", "published"])
def test_bwd_row_pass_ragged_rows(cuda_device, name, rows, dtype):
    cfg = mlp.MLPConfig(**{**SMALL, **CASES[name]})
    spec, kp, lo, hi, hvx = _operands(cfg, rows, 1, dtype, cuda_device, seed=rows)
    _check_bwd(f"rows {name} {rows} x 1", spec, kp, lo, hi, hvx, rows, 1, dtype, cuda_device)


@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("widths", [(48, 64), (160, 128), (64, 80)],
                         ids=["trunk48", "trunk160", "views80"])
def test_bwd_row_pass_pads_widths(cuda_device, widths, dtype):
    width, views_width = widths
    cfg = mlp.MLPConfig(**{**SMALL, "points_net_width": width, "views_net_width": views_width})
    nr, ns = 37, 64
    spec, kp, lo, hi, hvx = _operands(cfg, nr, ns, dtype, cuda_device)
    _check_bwd(f"rows widths {widths}", spec, kp, lo, hi, hvx, nr, ns, dtype, cuda_device)


@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("name", ["published", "visibility"])
def test_bwd_row_pass_two_rank_fine_shape(cuda_device, name, dtype):
    """A rank's fine backward in two-rank training: 2048 rays x 192."""
    published = CASES["published"]
    cfg = mlp.MLPConfig(**{**SMALL, **published, **CASES[name]})
    spec, kp, lo, hi, hvx = _operands(cfg, 2048, 192, dtype, cuda_device)
    _check_bwd(f"rows {name} 2048 x 192", spec, kp, lo, hi, hvx, 2048, 192, dtype, cuda_device)


@pytest.mark.parametrize("ns", [64, 192])
@pytest.mark.parametrize("name", ["published", "visibility"])
def test_f32_kernels_against_the_float64_yardstick(cuda_device, name, ns):
    """The float32 forward and backward (3xTF32) against the plain version
    in float64: each no further than YARDSTICK times the float32 plain
    version (true float32 products) is; planes as max abs error, gradients
    as the worst norm error; at the training step's 4096 rays: a
    gradient's error is mostly its rows' ReLU flips (activations within
    rounding of 0), whose count fewer rows leave to chance."""
    cfg = mlp.MLPConfig(**{**SMALL, **CASES["published"], **CASES[name]})
    nr = 4096
    ops = _operands(cfg, nr, ns, torch.float32, cuda_device, seed=nr)
    spec = ops[0]
    ops64 = (fused_mlp.with_dtype(spec, "float64"), *_double(ops[1:]))
    got, plain = fused_mlp.fused_apply(*ops), fused_mlp.fused_apply_reference(*ops)
    exact = fused_mlp.fused_apply_reference(*ops64)
    k_err = max((a.double() - b).abs().max().item() for a, b in zip(got, exact))
    p_err = max((a.double() - b).abs().max().item() for a, b in zip(plain, exact))
    print(f"yardstick {name} {nr} x {ns} planes: kernel {k_err:.3e}, plain {p_err:.3e}")
    assert k_err <= YARDSTICK * p_err
    g = torch.Generator(device=cuda_device).manual_seed(nr)
    d_planes = torch.randn((spec.n_planes, nr, ns), generator=g, device=cuda_device)
    (dkp, dhvx), (want, want_hvx) = (fused_mlp.fused_bwd(*ops, d_planes),
                                     fused_mlp.fused_bwd_reference(*ops, d_planes))
    w64, w64_hvx = fused_mlp.fused_bwd_reference(*ops64, d_planes.double())
    if spec.has_hvx:
        dkp, want, w64 = {**dkp, "dhvx": dhvx}, {**want, "dhvx": want_hvx}, {**w64, "dhvx": w64_hvx}
    k_err = max(_norm_err(dkp[k], w64[k]) for k in w64)
    p_err = max(_norm_err(want[k], w64[k]) for k in w64)
    print(f"yardstick {name} {nr} x {ns} gradients: kernel {k_err:.3e}, plain {p_err:.3e}")
    assert k_err <= YARDSTICK * p_err


@pytest.mark.parametrize("chunks", [1, 37, 577])
def test_tf32_split_matches_plain(cuda_device, chunks):
    """The split kernel gives the plain version's big and small images to
    the bit, and counts its launch."""
    g = torch.Generator(device=cuda_device).manual_seed(chunks)
    image = torch.randn(chunks * fused_mlp._TF32_CHUNK_FLOATS, generator=g, device=cuda_device)
    image *= torch.exp2(torch.randint(-20, 20, image.shape, generator=g, device=cuda_device))
    before = fused_mlp.tf32_split.launches
    got = fused_mlp.tf32_split(image)
    torch.cuda.synchronize()
    assert fused_mlp.tf32_split.launches == before + 1
    assert torch.equal(got.cpu(), fused_mlp.tf32_split(image.cpu()))


def _pe_points(n: int, device, seed: int = 0) -> torch.Tensor:
    """Points as the renderer makes them (NDC-like, a few units at most)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return 1.5 * torch.randn((n, 3), generator=g, device=device)


def _pe_equal(name: str, got, want) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape and got.is_contiguous()
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    differ = int((got.view(bits) != want.view(bits)).sum())
    print(f"pe {name}: {differ} of {want.numel()} elements differ")
    assert differ == 0


PE_CASES = {
    # the render chunk shapes (coarse 64, fine 192 samples), a ragged last chunk
    "render_coarse": (65_536 * 64, 10, 10),
    "render_fine": (65_536 * 192, 10, 10),
    "render_ragged": (47_872 * 192, 10, 10),
    "not_whole_tiles": (1037, 10, 10),
    # the step's trio block and fine shapes with the points-augmentation hi
    "trio_hi": (4096 * 64, 10, 3),
    "fine_hi": (4096 * 192, 10, 3),
    "small_hi": (37, 10, 3),
    "views_degree": (1037, 4, 4),
    "no_octaves": (1037, 0, 0),
}


@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("case", list(PE_CASES))
def test_pe_operands_kernel_matches_plain_to_the_bit(cuda_device, case, dtype):
    """lo and hi from the one-pass kernel equal the float32 sin / cos /
    cast / cat chain on the card bit for bit, and the launch is counted."""
    n, d, ds = PE_CASES[case]
    pts = _pe_points(n, cuda_device, seed=n)
    before = fused_mlp.pe_operands.launches
    lo, hi = fused_mlp.pe_operands(pts, d, ds, dtype)
    torch.cuda.synchronize()
    assert fused_mlp.pe_operands.launches == before + 1
    want_lo, want_hi = fused_mlp.pe_operands_reference(pts, d, ds, dtype)
    _pe_equal(f"{case} {dtype} lo", lo, want_lo)
    if ds < d:
        _pe_equal(f"{case} {dtype} hi", hi, want_hi)
    else:
        assert hi is None


@pytest.mark.parametrize(**DTYPES)
def test_pe_operands_graph_replay_equals_eager(cuda_device, dtype):
    """A captured-and-replayed launch writes the eager call's bytes, and the
    capture counts its launch."""
    pts = _pe_points(4096 * 64 + 5, cuda_device, seed=11)
    eager_lo, eager_hi = fused_mlp.pe_operands(pts, 10, 3, dtype)
    static = pts.clone()
    static.zero_()
    torch.cuda.synchronize()
    before = fused_mlp.pe_operands.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        lo, hi = fused_mlp.pe_operands(static, 10, 3, dtype)
    assert fused_mlp.pe_operands.launches == before + 1
    static.copy_(pts)
    graph.replay()
    torch.cuda.synchronize()
    _pe_equal(f"graph {dtype} lo", lo, eager_lo)
    _pe_equal(f"graph {dtype} hi", hi, eager_hi)


def test_pe_operands_count_one_launch_per_fused_field_call(cuda_device):
    """Each fused field call, single or ensemble, builds its PE in one launch."""
    cfg = mlp.MLPConfig(**{**SMALL, **CASES["points_aug"]})
    g = torch.Generator().manual_seed(0)
    params = mlp.init(g, cfg, device=cuda_device)
    nr, ns = 37, 64
    pts = _pe_points(nr * ns, cuda_device)
    dirs = torch.nn.functional.normalize(_pe_points(nr, cuda_device, seed=1), dim=-1)
    before = fused_mlp.launch_counts()
    mlp.apply_fused(params, cfg, pts, view_dirs=dirs, view_dirs_tile=ns, dtype=torch.bfloat16)
    members = [(mlp.init(g, c, device=cuda_device), c)
               for c in (mlp.MLPConfig(**{**SMALL, **CASES[name]}) for name in TRIO)]
    mlp.apply_fused_ensemble(members, pts, view_dirs=dirs, view_dirs_tile=ns, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    after = fused_mlp.launch_counts()
    assert {k: after[k] - before[k] for k in ("pe_operands", "fused_apply",
                                              "fused_apply_ensemble")} == {
        "pe_operands": 2, "fused_apply": 1, "fused_apply_ensemble": 1}


@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("trio", [TRIO, ("visibility", "points_aug", "lambertian")],
                         ids=["trio", "visibility_trio"])
def test_bwd_row_pass_two_rank_trio_shape(cuda_device, trio, dtype):
    """A rank's coarse trio backward in two-rank training at the published
    widths: 2048 rays x 64, each member's gradients and dhvx."""
    g = torch.Generator().manual_seed(7)
    members = []
    for name in trio:
        cfg = mlp.MLPConfig(**{**SMALL, **CASES["published"], **CASES[name]})
        members.append((mlp.init(g, cfg, device=cuda_device), cfg))
    nr, ns = 2048, 64
    pts = torch.randn((nr * ns, 3), generator=g).to(cuda_device)
    dirs = torch.nn.functional.normalize(torch.randn((nr, 3), generator=g), dim=-1).to(cuda_device)
    ens, kps, lo, hvxs = mlp.ensemble_operands(members, pts, dirs, ns, dtype)
    gd = torch.Generator(device=cuda_device).manual_seed(8)
    d_planes = torch.randn((ens.n_planes, nr, ns), generator=gd, device=cuda_device)
    dkps, dhvxs = fused_mlp.fused_ens_bwd(ens, kps, lo, hvxs, d_planes)
    want_kps, want_hvxs = fused_mlp.fused_ens_bwd_reference(ens, kps, lo, hvxs, d_planes)
    for name, dkp, wkp in zip(trio, dkps, want_kps):
        _grad_errors(f"rows trio {name} 2048 x 64", dkp, wkp, dtype)
    for a, b in zip(dhvxs, want_hvxs):
        _grad_errors("rows trio 2048 x 64", {"dhvx": a}, {"dhvx": b}, dtype)
    again, again_hvx = fused_mlp.fused_ens_bwd(ens, kps, lo, hvxs, d_planes)
    for a, b in zip(again, dkps):
        assert all(torch.equal(a[k], b[k]) for k in b), "two launches differ"
    assert all(torch.equal(a, b) for a, b in zip(again_hvx, dhvxs))


# The bf16 weight pass alone (fused_mlp.wgrad): slots of these widths, and
# dW = A[:, :k_in]^T G[:, :n_out] over them. "lo" is 64 wide with k_in 63
# (w0i, a skip's w{i}i); a 256-wide pair of A and G with a lo dW on the same
# G is a skip join; 48 and 144 pad G to one and three boxes.
WGRAD_CASES = {
    "published skip": ([64, 256, 256], [(1, 2, 256, 256), (0, 2, 63, 256), (0, 1, 63, 256)]),
    "views": ([256, 128, 64], [(0, 1, 256, 128), (2, 1, 63, 128)]),
    "width 48": ([48, 48, 64], [(0, 1, 48, 48), (2, 1, 63, 48)]),
    "width 144": ([144, 144, 64], [(0, 1, 144, 144), (2, 0, 63, 144), (1, 1, 144, 144)]),
}
# Float32 sums of the same bf16 products in another order: max abs error
# over the largest |value| of each dW.
WGRAD_TOL = 1e-5


def _slots(widths, n, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((n, w), generator=g, device=device).to(torch.bfloat16) for w in widths]


@pytest.mark.parametrize("n", [37, 5000, 66_368])
@pytest.mark.parametrize("case", sorted(WGRAD_CASES))
def test_wgrad_matches_plain(cuda_device, case, n):
    """37 rows: fewer than one 64-row stage; 5000 and 66,368: a ragged last
    stage, and chunks of which the last is short."""
    widths, dws = WGRAD_CASES[case]
    slots = _slots(widths, n, cuda_device, seed=n)
    before = fused_mlp.wgrad.launches
    got = fused_mlp.wgrad(slots, dws)
    torch.cuda.synchronize()
    assert fused_mlp.wgrad.launches == before + 1
    want = fused_mlp.wgrad([x.cpu() for x in slots], dws)
    for (a, g, k, m), x, y in zip(dws, got, want):
        err = (x.cpu() - y).abs().max().item() / max(y.abs().max().item(), 1e-30)
        print(f"wgrad {case} n={n} dW ({k}, {m}): max abs err / largest {err:.3e}")
        assert x.shape == (k, m) and err <= WGRAD_TOL, f"dW ({k}, {m}) of slots {a}, {g}: {err}"
    again = fused_mlp.wgrad(slots, dws)
    assert all(torch.equal(x, y) for x, y in zip(again, got)), "two launches differ"


@pytest.mark.parametrize("n", [37, 5000, 66_368])
@pytest.mark.parametrize("case", sorted(WGRAD_CASES))
def test_wgrad_f32_against_the_float64_yardstick(cuda_device, case, n):
    """The float32 weight pass (3xTF32, G K-major) on float32 slots of the
    same shapes against the plain version evaluated in float64: the worst
    ||got - want|| / ||want|| at most YARDSTICK times the float32 plain
    version's (float32 torch.matmul, no TF32); 37 rows: fewer than one
    32-row stage; 5000 and 66,368: ragged stages and chunks, rows no
    multiple of the stash's 8-row padding. Two launches give the same bits."""
    widths, dws = WGRAD_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(n + 1)
    slots = [torch.randn((n, w), generator=g, device=cuda_device) for w in widths]
    before = fused_mlp.wgrad.launches
    got = fused_mlp.wgrad(slots, dws)
    torch.cuda.synchronize()
    assert fused_mlp.wgrad.launches == before + 1
    k_err = p_err = 0.0
    for (a, gs, k, m), x in zip(dws, got):
        exact = slots[a][:, :k].double().T @ slots[gs][:, :m].double()
        assert x.shape == (k, m) and x.dtype == torch.float32
        k_err = max(k_err, _norm_err(x, exact))
        p_err = max(p_err, _norm_err(slots[a][:, :k].T @ slots[gs][:, :m], exact))
    print(f"wgrad float32 {case} n={n}: kernel {k_err:.3e}, plain {p_err:.3e} from float64")
    assert k_err <= YARDSTICK * p_err
    again = fused_mlp.wgrad(slots, dws)
    assert all(torch.equal(x, y) for x, y in zip(again, got)), "two launches differ"


@pytest.mark.parametrize("shape", [(1, 6181, 3076), (1, 2048, 9228), (1, 23, 589_312),
                                   (4096, 192, 128), (3, 191, 130), (2, 1, 12), (5, 40, 7)])
def test_column_sums_match_torch_sum(cuda_device, shape):
    """The step's partials, dW-partials and dhvx shapes (some made ragged),
    a column count no 16-byte load divides, one row: each column's error
    against torch.sum within 1e-5 of its sum of |x|, and the same bits on
    a second launch."""
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=cuda_device)
    before = fused_mlp.column_sums.launches
    got = fused_mlp.column_sums(x)
    torch.cuda.synchronize()
    assert fused_mlp.column_sums.launches == before + 1
    want = x.double().sum(1)
    err = ((got.double() - want).abs() / x.double().abs().sum(1).clamp_min(1e-30)).max().item()
    print(f"column sums {shape}: largest error / sum |x| {err:.3e}")
    assert got.shape == (shape[0], shape[2]) and err <= 1e-5
    assert torch.equal(fused_mlp.column_sums(x), got), "two launches differ"


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


AUTOGRAD_CASES = {"published": 192, "main": 5, "trio": 64}


@pytest.mark.parametrize("rays", [37, 1037])
@pytest.mark.parametrize("case", sorted(AUTOGRAD_CASES))
def test_f32_autograd_equals_the_direct_backward_to_the_bit(cuda_device, case, rays):
    """Under autograd the float32 forward stores the activations and mask
    words and the backward reads them (no forward of its own); a direct
    backward call launches that forward itself. Both give the same
    gradients, bit for bit, single MLP and trio, ragged rows included."""
    ns = AUTOGRAD_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(rays)
    if case == "trio":
        ens, kps, lo, hvxs = _ensemble(rays, ns, torch.float32, cuda_device)
        kps = [{k: v.clone().requires_grad_() for k, v in kp.items()} for kp in kps]
        hvxs = [h.clone().requires_grad_() for h in hvxs]
        names = [(i, k) for i, kp in enumerate(kps) for k in kp] + [("hvx", i) for i in range(len(hvxs))]
        leaves = [v for kp in kps for v in kp.values()] + hvxs
        d = torch.randn((ens.n_planes, rays, ns), generator=g, device=cuda_device)
        before = fused_mlp.launch_counts()
        planes = fused_mlp.fused_apply_ensemble(ens, kps, lo, hvxs)
        got = torch.autograd.grad((torch.stack(planes) * d).sum(), leaves)
        mid = fused_mlp.launch_counts()
        detached = [{k: v.detach() for k, v in kp.items()} for kp in kps]
        dkps, dhvxs = fused_mlp.fused_ens_bwd(ens, detached, lo, [h.detach() for h in hvxs], d)
        want = [dkps[i][k] if i != "hvx" else dhvxs[k] for i, k in names]
        key = "fused_ens_bwd.own_forward"
    else:
        cfg = mlp.MLPConfig(**{**SMALL, **CASES.get(case, {}), **(
            dict(points_net_depth=8, points_net_width=256, views_net_width=128, skip_layers=(4,))
            if case == "published" else {})})
        spec, kp, lo, hi, hvx = _operands(cfg, rays, ns, torch.float32, cuda_device)
        kp = {k: v.clone().requires_grad_() for k, v in kp.items()}
        hvx = hvx.clone().requires_grad_()
        names = [*kp, "hvx"]
        leaves = [*kp.values(), hvx]
        d = torch.randn((spec.n_planes, rays, ns), generator=g, device=cuda_device)
        before = fused_mlp.launch_counts()
        planes = fused_mlp.fused_apply(spec, kp, lo, hi, hvx)
        got = torch.autograd.grad((torch.stack(planes) * d).sum(), leaves)
        mid = fused_mlp.launch_counts()
        dkp, dhvx = fused_mlp.fused_bwd(spec, {k: v.detach() for k, v in kp.items()}, lo, hi,
                                        hvx.detach(), d)
        want = [dkp[k] if k != "hvx" else dhvx for k in names]
        key = "fused_bwd.own_forward"
    torch.cuda.synchronize()
    after = fused_mlp.launch_counts()
    assert mid[key] == before[key] and after[key] == mid[key] + 1
    assert len(got) == len(want) == len(names)
    for name, a, b in zip(names, got, want):
        assert torch.equal(a, b), f"{name} differs: {float((a - b).abs().max()):.3e}"


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


# One training step's gradients through the kernels against the plain
# versions, every parameter as ||got - want|| / ||want||: chip_smoke.py's
# step limits. The fine samples depend on the coarse weights, so the two
# runs' inputs drift apart with the coarse kernels' rounding.
STEP_TOL = {torch.float32: 5e-4, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_visibility_training_step_gradients_match_plain(cuda_device, tmp_path, monkeypatch, dtype):
    """A training step with visibility heads on the coarse and fine main
    MLPs and the dense-depth and visibility losses on their prior data:
    the visibility head's weights among the gradients."""
    from simplenerf_torch.data.factory import get_data_loader
    from simplenerf_torch.data.preprocessor import ScenePreprocessor
    from simplenerf_torch.data.synthetic import generate_scene, write_scene_priors
    from simplenerf_torch.drivers import presets
    from simplenerf_torch.training.trainer import Trainer

    gt = generate_scene(tmp_path / "db", num_frames=5, h=24, w=32, num_train=3, seed=3)
    write_scene_priors(tmp_path / "db", "blobs", gt["train_frames"], gt["images"], gt["depths"],
                       gt["extrinsics"], gt["intrinsic"])
    cfg = presets.with_visibility_priors(presets.tiny_synthetic_config(
        num_rays=256, sparse_depth_rays=128, consistency_start_iter=1,
        compute_dtype="bfloat16" if dtype == torch.bfloat16 else "float32"))
    cfg["model"]["fused_mlp"] = "on"
    cfg["resume_training"] = False
    raw = get_data_loader(cfg, tmp_path / "db", "train").load_data()
    trainer = Trainer(cfg, tmp_path / "run", ScenePreprocessor(cfg, "train", raw, device=cuda_device))
    idx = trainer.train_pp.next_indices(2)
    widths = []
    launch = fused_mlp._launch_fwd

    def spy(spec, *args, **kwargs):
        widths.append([m.out_v for m in getattr(spec, "members", (spec,))])
        return launch(spec, *args, **kwargs)

    def grads():
        for p in trainer.leaves:
            p.grad = None
        total, values = trainer.loss(trainer.batch(*idx), 2, generator=trainer.step_generator(2))
        total.backward()
        assert float(values["VisibilityLoss01"]) > 0 and float(values["DenseDepthMSE01"]) > 0
        return [p.grad.clone() for p in trainer.leaves]

    monkeypatch.setattr(fused_mlp, "_launch_fwd", spy)
    counts = [f.launches for f in (fused_mlp.fused_apply, fused_mlp.fused_bwd,
                                   fused_mlp.fused_apply_ensemble, fused_mlp.fused_ens_bwd)]
    kern = grads()
    torch.cuda.synchronize()
    after = [f.launches for f in (fused_mlp.fused_apply, fused_mlp.fused_bwd,
                                  fused_mlp.fused_apply_ensemble, fused_mlp.fused_ens_bwd)]
    assert [b - a for a, b in zip(counts, after)] == [1, 1, 1, 1]
    assert sorted(widths) == [[4], [4, 3, 0]]  # the fine MLP, the coarse trio
    monkeypatch.setattr(fused_mlp, "_fwd", lambda *a, train=False: (
        torch.stack(fused_mlp.fused_apply_reference(*a)), None, None))
    monkeypatch.setattr(fused_mlp, "fused_bwd",
                        lambda *a, stash=None: fused_mlp.fused_bwd_reference(*a))
    monkeypatch.setattr(fused_mlp, "_ens_fwd", lambda *a, train=False: (
        torch.stack(fused_mlp.fused_apply_ensemble_reference(*a)), None))
    monkeypatch.setattr(fused_mlp, "fused_ens_bwd",
                        lambda *a, stash=None: fused_mlp.fused_ens_bwd_reference(*a))
    plain = grads()
    names = _leaf_names(trainer.params)
    assert any("views_out" in n for n in names)
    errs = {n: _norm_err(a, b) for n, a, b in zip(names, kern, plain)}
    worst = max(errs, key=errs.get)
    print(f"visibility step {dtype}: worst norm err {errs[worst]:.3e} ({worst})")
    assert errs[worst] <= STEP_TOL[dtype], worst


def _leaf_names(tree, prefix=""):
    """Leaf names of a params tree in `checkpoints.flat_leaves` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


# ---------------------------------------------------------------------------
# K training steps as one CUDA graph (Trainer.train_many)
# ---------------------------------------------------------------------------
# The graph runs the loop's kernels on the loop's inputs, so its steps
# should equal the loop's to the bit; each comparison holds the graph to
# no larger a difference than a second run of its yardstick shows, and
# prints both.

GRAPH_K = 4
COUNTED = ("fused_apply", "fused_bwd", "fused_apply_ensemble", "fused_ens_bwd")


@pytest.fixture(scope="module")
def graph_scene(tmp_path_factory):
    from simplenerf_torch.data.synthetic import generate_scene

    root = tmp_path_factory.mktemp("db")
    generate_scene(root, num_frames=5, h=24, w=32, num_train=3, seed=3)
    return root


def _graph_trainer(scene, out, dtype: str = "bfloat16", **overrides):
    """The tiny preset with draws on (jitter, importance uniforms, sigma
    noise) and the consistency ramp at step 2, on the card."""
    from simplenerf_torch.data.factory import get_data_loader
    from simplenerf_torch.data.preprocessor import ScenePreprocessor
    from simplenerf_torch.drivers import presets
    from simplenerf_torch.training.trainer import Trainer

    cfg = presets.tiny_synthetic_config(num_rays=256, sparse_depth_rays=128,
                                        consistency_start_iter=2, compute_dtype=dtype)
    cfg["resume_training"] = False
    cfg.update(overrides)
    raw = get_data_loader(cfg, scene, "train").load_data()
    return Trainer(cfg, out, ScenePreprocessor(cfg, "train", raw, device="cuda"))


def _train_state(t, values=None) -> dict:
    torch.cuda.synchronize()
    state = {"params": torch.cat([p.detach().reshape(-1) for p in t.leaves]),
             "mu": t.opt_state["mu"], "nu": t.opt_state["nu"],
             "count": torch.tensor([float(t.opt_state["count"])])}
    if values is not None:
        state["values"] = torch.stack([values[k].float() for k in sorted(values)])
    return {k: v.detach().cpu().clone() for k, v in state.items()}


def _held(label: str, got: dict, want: dict, again: dict):
    """got against want, no further than `again` (want's yardstick) is."""
    for k in want:
        d = float((got[k] - want[k]).abs().max())
        y = float((again[k] - want[k]).abs().max())
        print(f"{label} {k}: equal to the bit {torch.equal(got[k], want[k])} ({d:.3e}); "
              f"yardstick {torch.equal(again[k], want[k])} ({y:.3e})")
        assert torch.isfinite(got[k]).all() and d <= y, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
def test_graph_steps_equal_loop_steps(cuda_device, graph_scene, tmp_path, dtype):
    def loop(out):
        t = _graph_trainer(graph_scene, out, dtype)
        for it in range(GRAPH_K):
            values = t.train_one_iter(it)
        return _train_state(t, values)

    want, again = loop(tmp_path / "a"), loop(tmp_path / "b")
    g = _graph_trainer(graph_scene, tmp_path / "g", dtype)
    got = _train_state(g, g.train_many(0, GRAPH_K))
    assert g._graph is not None and got["count"].item() == GRAPH_K
    _held(f"graph vs loop {dtype}", got, want, again)


def test_graph_run_resumed_in_the_middle_equals_the_uninterrupted_run(cuda_device, graph_scene,
                                                                      tmp_path):
    cfg = dict(steps_per_call=3, log_interval=3, model_save_interval=3, resume_training=True)

    def whole(out):
        t = _graph_trainer(graph_scene, out, **cfg)
        t.train(6)
        return _train_state(t)

    want, again = whole(tmp_path / "a"), whole(tmp_path / "b")
    _graph_trainer(graph_scene, tmp_path / "r", **cfg).train(3)
    resumed = _graph_trainer(graph_scene, tmp_path / "r", **cfg)
    assert resumed.start_iter == 3
    resumed.train(6)
    _held("resumed graph run", _train_state(resumed), want, again)


def test_graph_keeps_each_stash_in_its_pool(cuda_device, graph_scene, tmp_path, monkeypatch):
    """The bf16 backward's tensor maps hold the stash's address from the
    capture: that stash lies in the graph's private pool, which keeps its
    memory for the graph's lifetime, so every replay writes and reads the
    stash at the address the maps hold. Replays call no wrapper."""
    from simplenerf_torch.ops import build

    t = _graph_trainer(graph_scene, tmp_path)
    t.train_one_iter(0)
    lib = build.load_library("fused_mlp_bwd")
    seen = []
    for entry, arg in (("snerf_fused_mlp_bwd", 15), ("snerf_fused_mlp_ens_bwd", 14)):
        def spy(*args, _fn=getattr(lib, entry), _arg=arg):
            seen.append(args[_arg].value)
            return _fn(*args)

        monkeypatch.setattr(lib, entry, spy)
    t.train_many(1, 2)  # the warm-up step and the capture launch both backwards; one replay
    assert len(seen) == 4
    captured = seen[2:]
    t.train_many(3, 3)
    torch.cuda.synchronize()
    assert len(seen) == 4
    pool = tuple(t._graph.graph.pool())
    segments = [s for s in torch.cuda.memory_snapshot() if tuple(s["segment_pool_id"]) == pool]
    for ptr in captured:
        assert any(s["address"] <= ptr < s["address"] + s["total_size"] for s in segments), ptr


def test_graph_replays_count_one_launch_of_each_kernel_per_step(cuda_device, graph_scene, tmp_path):
    t = _graph_trainer(graph_scene, tmp_path)
    before = fused_mlp.launch_counts()
    t.train_many(0, 2)  # a warm-up step, the capture (no launch) and one replay
    mid = fused_mlp.launch_counts()
    t.train_many(2, 5)
    torch.cuda.synchronize()
    after = fused_mlp.launch_counts()
    assert {k: mid[k] - before[k] for k in COUNTED} == dict.fromkeys(COUNTED, 2)
    assert {k: after[k] - mid[k] for k in COUNTED} == dict.fromkeys(COUNTED, 5)
    assert after["wgrad"] == before["wgrad"] and after["column_sums"] == before["column_sums"]
    # One PE launch a fused forward (the trio's and the fine MLP's), replays too.
    forwards = {k: after[k] - before[k] for k in ("fused_apply", "fused_apply_ensemble")}
    assert after["pe_operands"] - before["pe_operands"] == sum(forwards.values()) == 2 * 7


def test_f32_graph_steps_launch_no_backward_forward(cuda_device, graph_scene, tmp_path):
    """Float32 training steps, eager and replayed: every backward reads the
    stash its forward stored under autograd, none launches its own."""
    t = _graph_trainer(graph_scene, tmp_path, "float32")
    keys = ("fused_bwd.own_forward", "fused_ens_bwd.own_forward")
    before = fused_mlp.launch_counts()
    t.train_one_iter(0)
    t.train_many(1, 4)  # a warm-up step, the capture and two replays
    torch.cuda.synchronize()
    after = fused_mlp.launch_counts()
    assert {k: after[k] - before[k] for k in COUNTED} == dict.fromkeys(COUNTED, 5)
    assert {k: after[k] - before[k] for k in keys} == dict.fromkeys(keys, 0)


def test_set_params_drops_the_graph(cuda_device, graph_scene, tmp_path):
    """After set_params a call captures anew and trains the new parameters,
    as a fresh Trainer from them does; a stale graph would train the old
    tensors and leave the new ones at their start."""
    import copy

    from simplenerf_torch.training import checkpoints

    t = _graph_trainer(graph_scene, tmp_path / "t")
    init = copy.deepcopy(t.params)
    t.train_many(0, 3)
    old = t._graph
    t.set_params(init)
    assert t._graph is None
    got = _train_state(t, t.train_many(3, 3))
    assert t._graph is not old

    def fresh(out):
        f = _graph_trainer(graph_scene, out)
        f.train_pp.fast_forward(3)
        return _train_state(f, f.train_many(3, 3))

    start = torch.cat([p.detach().reshape(-1) for p in checkpoints.flat_leaves(init)]).cpu()
    assert not torch.equal(got["params"], start)
    _held("after set_params", got, fresh(tmp_path / "a"), fresh(tmp_path / "b"))


# Secondary views (ViP-NeRF's prior; bf16 only on the card): the forward's
# hvx-layer store and csrc/fused_mlp_sec.cu, and the row pass taking their
# cotangent, against the plain versions (`fused_apply_reference` and
# `fused_bwd_reference` with `sec`). The secondary planes' tolerance is the
# planes' (TOL); dwdir's the weights' (GRAD_TOL): its sums run in another
# order, on the same bf16 operands. Row counts leave a block's second
# consumer and the secondary kernels' last warp ragged.
SEC_CASES = {
    "visibility": CASES["visibility"],
    "published": dict(CASES["published"], predict_visibility=True),
}


def _sec_operands(cfg, nr, ns, k, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = mlp.init(g, cfg, device=device)
    pts = torch.randn((nr * ns, 3), generator=g).to(device)
    dirs = torch.nn.functional.normalize(torch.randn((nr, 3), generator=g), dim=-1).to(device)
    dirs2 = torch.nn.functional.normalize(torch.randn((nr * ns, k, 3), generator=g), dim=-1).to(device)
    ops = mlp.fused_operands(params, cfg, pts, dirs, ns, torch.bfloat16)
    return ops, mlp.secondary_operands(params, cfg, dirs2, torch.bfloat16)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("shape", [(37, 5), (1037, 1), (40, 64)], ids=["37x5", "1037x1", "40x64"])
@pytest.mark.parametrize("name", sorted(SEC_CASES))
def test_secondary_kernels_match_plain(cuda_device, name, shape, k):
    cfg = mlp.MLPConfig(**{**SMALL, **SEC_CASES[name]})
    nr, ns = shape
    (spec, kp, lo, hi, hvx), sec = _sec_operands(cfg, nr, ns, k, cuda_device, seed=nr + k)
    before = fused_mlp.launch_counts()
    got = fused_mlp.fused_apply(spec, kp, lo, hi, hvx, sec=sec)
    torch.cuda.synchronize()
    after = fused_mlp.launch_counts()
    assert {n: after[n] - before[n] for n in ("fused_apply", "secondary_fwd")} == {
        "fused_apply": 1, "secondary_fwd": 1}
    want = fused_mlp.fused_apply_reference(spec, kp, lo, hi, hvx, sec)
    assert len(got) == len(want) == spec.n_planes + k
    for j, (a, b) in enumerate(zip(got, want)):
        assert a.shape == (nr, ns)
        err = (a - b).abs().max().item()
        print(f"secondary {name} {nr}x{ns} k={k} plane {j}: max abs err {err:.3e}")
        assert err <= TOL[torch.bfloat16], f"plane {j}: max abs err {err}"
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    d_planes = torch.randn((spec.n_planes + k, nr, ns), generator=gen, device=cuda_device)
    pre = fused_mlp._fwd(spec, kp, lo, hi, hvx, sec)[1]
    dkp, dhvx, dwdir = fused_mlp.fused_bwd(spec, kp, lo, hi, hvx, d_planes, sec=sec, pre=pre)
    want, want_hvx, want_dir = fused_mlp.fused_bwd_reference(spec, kp, lo, hi, hvx, d_planes, sec)
    got_g = {**dkp, "dhvx": dhvx, "dwdir": dwdir}
    _grad_errors(f"secondary bwd {name} {nr}x{ns} k={k}", got_g,
                 {**want, "dhvx": want_hvx, "dwdir": want_dir}, torch.bfloat16)
    again = fused_mlp.fused_bwd(spec, kp, lo, hi, hvx, d_planes, sec=sec, pre=pre)
    assert all(torch.equal(again[0][n], dkp[n]) for n in dkp), "two launches differ"
    assert torch.equal(again[1], dhvx) and torch.equal(again[2], dwdir), "two launches differ"


def test_secondary_autograd_matches_plain(cuda_device):
    """Under autograd: wdir's gradient and the kernel params' through
    `fused_apply` with secondary views, against the plain versions."""
    cfg = mlp.MLPConfig(**{**SMALL, **SEC_CASES["published"]})
    nr, ns, k = 37, 64, 2
    (spec, kp, lo, hi, hvx), (pe2, wdir) = _sec_operands(cfg, nr, ns, k, cuda_device, seed=5)
    leaves = {n: t.detach().clone().requires_grad_() for n, t in {**kp, "wdir": wdir}.items()}
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    weights = torch.randn((spec.n_planes + k, nr, ns), generator=gen, device=cuda_device)

    def run():
        kp_ = {n: leaves[n] for n in kp}
        planes = fused_mlp.fused_apply(spec, kp_, lo, hi, hvx, sec=(pe2, leaves["wdir"]))
        loss = (torch.stack(planes) * weights).sum()
        return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    got = run()
    plain = (fused_mlp.fused_apply_reference, fused_mlp.fused_bwd_reference)
    saved = (fused_mlp._fwd, fused_mlp.fused_bwd)
    fused_mlp._fwd = lambda *a, train=False: (torch.stack(plain[0](*a)), None, None)
    fused_mlp.fused_bwd = lambda *a, sec=None, pre=None, stash=None: plain[1](*a, sec=sec)
    try:
        want = run()
    finally:
        fused_mlp._fwd, fused_mlp.fused_bwd = saved
    _grad_errors("secondary autograd", got, want, torch.bfloat16)


def test_k0_launches_the_kernels_it_launched_before(cuda_device):
    """Without secondary views a field call and its backward launch the
    forward engine and the row pass in their plain instances (kPre, kSec
    false), the weight pass and the column sums: no secondary kernel and
    no column sum of its partials."""
    cfg = mlp.MLPConfig(**{**SMALL, **SEC_CASES["published"]})
    spec, kp, lo, hi, hvx = _operands(cfg, 37, 64, torch.bfloat16, cuda_device)
    kp = {n: t.detach().clone().requires_grad_() for n, t in kp.items()}
    before = fused_mlp.launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        planes = fused_mlp.fused_apply(spec, kp, lo, hi, hvx)
        torch.autograd.grad(torch.stack(planes).sum(), list(kp.values()))
        torch.cuda.synchronize()
    after = fused_mlp.launch_counts()
    delta = {n: after[n] - before[n] for n in after if after[n] != before[n]}
    assert delta == {"fused_apply": 1, "fused_bwd": 1}, delta
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = [n for n in names if "fused_mlp" in n or "sec_" in n]
    print("k = 0 kernels:", sorted(set(ours)))
    assert not [n for n in ours if "sec_" in n or "<true>" in n], ours
    assert sum("fused_mlp_fwd_sm90_kernel<false>" in n for n in ours) == 1, ours
    assert sum("fused_mlp_bwd_rows_sm90_kernel<false>" in n for n in ours) == 1, ours
