"""The port's fused MLP gradients and ensemble against the JAX package.

The JAX side differentiates its Pallas kernels (`fused_apply` and
`fused_apply_ensemble`, forward and backward) in interpret mode on the CPU,
as tests/test_ops.py runs them; the port's wrappers take their plain
versions (`fused_bwd_reference`, `fused_apply_ensemble_reference`,
`fused_ens_bwd_reference`) for CPU tensors, under autograd. Inputs are
numpy arrays from one seed; parameters cross over with
`convert.params_from_numpy`.

Tolerances: gradients are sums over every row, so the bound is relative to
the largest value of each gradient. f32: both sides compute the same
products in float32 and differ in summation order only, hence 1e-5. bf16:
both round every product operand to bf16, and an order difference can flip
one rounding (2^-8 relative) of an activation or cotangent, hence 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from simplenerf_tpu.fields import mlp as jmlp
from simplenerf_tpu.ops import fused_mlp as jfused
from simplenerf_torch import convert
from simplenerf_torch.fields import mlp
from simplenerf_torch.ops import fused_mlp
from simplenerf_torch.render import sampling

SMALL = dict(
    points_net_depth=4, views_net_depth=1, points_net_width=64, views_net_width=64,
    points_pe_degree=10, views_pe_degree=4, use_view_dirs=True, view_dependent_rgb=True,
    skip_layers=(2,),
)
# The five CASES of tests/test_ops.py.
CASES = {
    "main": {},
    "points_aug": dict(points_sigma_pe_degree=3),
    "lambertian": dict(use_view_dirs=False, view_dependent_rgb=False),
    "visibility": dict(predict_visibility=True),
    "two_skips": dict(points_net_depth=5, skip_layers=(1, 3)),
}
TRIO = ("main", "points_aug", "lambertian")
NR, NS = 6, 5
RTOL = {"float32": 1e-5, "bfloat16": 5e-3}


def _dtypes(name):
    return (jnp.bfloat16, torch.bfloat16) if name == "bfloat16" else (jnp.float32, torch.float32)


def _close(got, want, rtol, label):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, label
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f"{label}: max abs err {err} vs largest value {scale}"


def _member(name, seed):
    kw = {**SMALL, **CASES[name]}
    jcfg, tcfg = jmlp.MLPConfig(**kw), mlp.MLPConfig(**kw)
    jparams = jmlp.init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))


def _inputs(rng, tile_rays, n_planes):
    pts = rng.standard_normal((tile_rays * NS, 3)).astype(np.float32)
    pts[NR * NS :] = 0.0  # JAX pads rays to its tile; the padding carries no cotangent
    dirs = rng.standard_normal((tile_rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dps = rng.standard_normal((n_planes, tile_rays, NS)).astype(np.float32)
    dps[:, NR:] = 0.0
    return pts, dirs, dps


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_apply_gradients_match_jax(name, dtype_name):
    jdt, tdt = _dtypes(dtype_name)
    jcfg, tcfg, jparams, tparams = _member(name, 3)
    spec = jfused.make_spec(jcfg, NS, jdt)
    rng = np.random.default_rng(0)
    pts, _, dps = _inputs(rng, spec.tile_rays, spec.n_planes)
    kp = jfused.kernel_params(jparams, jcfg)
    lo, hi = jmlp._trunk_inputs(jcfg, jnp.asarray(pts), spec.cdtype)
    hvx = None
    if spec.has_hvx:
        hvx = jnp.asarray(rng.standard_normal((spec.tile_rays, spec.views_width)).astype(np.float32))
    planes, vjp = jax.vjp(lambda kp, hvx: jfused.fused_apply(spec, kp, lo, hi, hvx), kp, hvx)
    dkp, dhvx = vjp(tuple(jnp.asarray(d) for d in dps))

    tspec = fused_mlp.make_spec(tcfg, NS, tdt)
    tkp = {k: v.detach().clone().requires_grad_() for k, v in fused_mlp.kernel_params(tparams, tcfg).items()}
    t = lambda a, dt: None if a is None else torch.from_numpy(np.array(a[: NR * NS], np.float32)).to(dt)  # noqa: E731
    tlo, thi = t(lo, tdt), t(hi, tdt)
    thvx = None if hvx is None else torch.from_numpy(np.array(hvx[:NR])).requires_grad_()
    got = fused_mlp.fused_apply(tspec, tkp, tlo, thi, thvx)
    for j, (g, w) in enumerate(zip(got, planes)):
        _close(g, np.asarray(w)[:NR], RTOL[dtype_name], f"plane {j}")
    torch.autograd.backward(list(got), [torch.from_numpy(d[:NR]) for d in dps])
    for k in tspec.param_keys():
        _close(tkp[k].grad, dkp[k], RTOL[dtype_name], k)
    if thvx is not None:
        _close(thvx.grad, np.asarray(dhvx)[:NR], RTOL[dtype_name], "dhvx")


def _trio(seed=4):
    return [_member(name, seed + i) for i, name in enumerate(TRIO)]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_fused_apply_ensemble_gradients_match_jax(dtype_name):
    jdt, tdt = _dtypes(dtype_name)
    members = _trio()
    ens = jfused.make_ensemble_spec(tuple(m[0] for m in members), NS, jdt, tile_rays=8)
    rng = np.random.default_rng(1)
    pts, _, dps = _inputs(rng, ens.tile_rays, ens.n_planes)
    d_max = max(m[0].points_pe_degree for m in members)
    kps = tuple(jfused.kernel_params(m[2], m[0], shared_degree=d_max) for m in members)
    x, s, c = jmlp.encoding.encode_parts(jnp.asarray(pts), d_max)
    lo = jnp.concatenate([x, s, c], -1).astype(jdt)
    hvxs = tuple(jnp.asarray(rng.standard_normal((ens.tile_rays, ens.members[mi].views_width))
                             .astype(np.float32)) for mi in ens.hvx_members)
    planes, vjp = jax.vjp(lambda kps, hvxs: jfused.fused_apply_ensemble(ens, kps, lo, hvxs), kps, hvxs)
    dkps, dhvxs = vjp(tuple(jnp.asarray(d) for d in dps))

    tens = fused_mlp.make_ensemble_spec([m[1] for m in members], NS, tdt)
    tkps = [{k: v.detach().clone().requires_grad_()
             for k, v in fused_mlp.kernel_params(m[3], m[1], shared_degree=d_max).items()}
            for m in members]
    tlo = torch.from_numpy(np.array(lo[: NR * NS], np.float32)).to(tdt)
    thvxs = [torch.from_numpy(np.array(h[:NR])).requires_grad_() for h in hvxs]
    got = fused_mlp.fused_apply_ensemble(tens, tkps, tlo, thvxs)
    assert len(got) == len(planes) == tens.n_planes
    for j, (g, w) in enumerate(zip(got, planes)):
        _close(g, np.asarray(w)[:NR], RTOL[dtype_name], f"plane {j}")
    torch.autograd.backward(list(got), [torch.from_numpy(d[:NR]) for d in dps])
    for name, tkp, dkp in zip(TRIO, tkps, dkps):
        for k in tkp:
            _close(tkp[k].grad, dkp[k], RTOL[dtype_name], f"{name}.{k}")
    for th, dh in zip(thvxs, dhvxs):
        _close(th.grad, np.asarray(dh)[:NR], RTOL[dtype_name], "dhvx")


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_apply_fused_ensemble_equals_members_run_alone(dtype_name):
    """Outputs and canonical-parameter gradients of the ensemble equal those
    of `apply_fused` per member: the zero-padded joins add nothing."""
    _, tdt = _dtypes(dtype_name)
    g = torch.Generator().manual_seed(5)
    cfgs = [mlp.MLPConfig(**{**SMALL, **CASES[name]}) for name in TRIO]
    pts = torch.randn((NR * NS, 3), generator=g)
    dirs = torch.nn.functional.normalize(torch.randn((NR, 3), generator=g), dim=-1)
    noises = [torch.randn((NR, NS), generator=g) for _ in TRIO]
    weights = [torch.randn((NR, NS), generator=g) for _ in range(3)]

    def run(ensemble: bool):
        params = [mlp.init(torch.Generator().manual_seed(10 + i), c) for i, c in enumerate(cfgs)]
        leaves = [p for tree in params for p in _leaves(tree)]
        for p in leaves:
            p.requires_grad_()
        kw = dict(view_dirs=dirs, noise_std=0.3, dtype=tdt, view_dirs_tile=NS)
        if ensemble:
            outs = mlp.apply_fused_ensemble(list(zip(params, cfgs)), pts, noises=noises, **kw)
        else:
            outs = [mlp.apply_fused(p, c, pts, noise=n, **kw) for p, c, n in zip(params, cfgs, noises)]
        loss = sum((o["sigma"] * w).sum() + (o["rgb"] * w).sum() for o, w in zip(outs, weights))
        loss.backward()
        return outs, [p.grad for p in leaves]

    (outs_e, grads_e), (outs_m, grads_m) = run(True), run(False)
    for oe, om in zip(outs_e, outs_m):
        assert set(oe) == set(om)
        for k in om:
            torch.testing.assert_close(oe[k], om[k], atol=1e-6, rtol=1e-6)
    for ge, gm in zip(grads_e, grads_m):
        torch.testing.assert_close(ge, gm, atol=1e-5, rtol=1e-5)


def _leaves(tree):
    if isinstance(tree, dict):
        return [p for v in tree.values() for p in _leaves(v)]
    if isinstance(tree, list):
        return [p for v in tree for p in _leaves(v)]
    return [tree]


def test_sampling_draws_on_the_generators_device():
    """The uniforms come from the given generator on the tensors' device, and
    the host's global generator does not enter."""
    near = torch.full((7, 1), 0.5)
    far = torch.full((7, 1), 4.0)
    z0 = sampling.stratified_z_vals(near, far, 16, perturb=False)
    draws = []
    for host_seed in (0, 1):
        torch.manual_seed(host_seed)
        g = torch.Generator(device=near.device).manual_seed(3)
        z = sampling.stratified_z_vals(near, far, 16, perturb=True, generator=g)
        w = torch.rand((7, 15), generator=torch.Generator().manual_seed(4))
        fine = sampling.fine_z_vals(z, torch.cat([w, w[:, :1]], -1), 24, perturb=True, generator=g)
        draws.append((z, fine))
    torch.testing.assert_close(draws[0][0], draws[1][0], rtol=0, atol=0)
    torch.testing.assert_close(draws[0][1], draws[1][1], rtol=0, atol=0)
    u = torch.rand((7, 16), generator=torch.Generator(device=near.device).manual_seed(3))
    mids = 0.5 * (z0[:, 1:] + z0[:, :-1])
    lower, upper = torch.cat([z0[:, :1], mids], -1), torch.cat([mids, z0[:, -1:]], -1)
    torch.testing.assert_close(draws[0][0], lower + (upper - lower) * u)
