"""simplenerf_torch render/geometry building blocks and `render_rays` vs JAX.

All in float32 on the CPU, with the same numpy inputs and (for the full
render) the same JAX-initialized parameters on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from simplenerf_tpu.fields.mlp import MLPConfig as JMLPConfig
from simplenerf_tpu.geometry import poses as jposes
from simplenerf_tpu.geometry import projection as jproj
from simplenerf_tpu.geometry import rays as jrays
from simplenerf_tpu.render import renderer as jrenderer
from simplenerf_tpu.render import sampling as jsampling
from simplenerf_tpu.render import volume as jvolume
from simplenerf_torch import convert
from simplenerf_torch.fields.mlp import MLPConfig
from simplenerf_torch.geometry import poses, projection, rays
from simplenerf_torch.render import renderer, sampling, volume

T = torch.from_numpy


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_sample_pdf_with_fixed_uniforms():
    rng = _rng(1)
    nr, m, s = 16, 24, 40
    bins = np.sort(rng.uniform(1.0, 6.0, (nr, m)), axis=-1).astype(np.float32)
    weights = rng.uniform(0, 1, (nr, m - 1)).astype(np.float32)
    weights[:3, 5:] = 0.0  # degenerate intervals exercise the denominator guard
    u = rng.uniform(0, 1, (nr, s))
    # Where u lies within float32 noise of a cdf entry the bracket is a coin
    # flip between the frameworks (a jump of one bin); keep u clear of them.
    w64 = weights.astype(np.float64) + 1e-5
    cdf = np.cumsum(w64 / w64.sum(-1, keepdims=True), axis=-1)
    near = np.abs(u[:, :, None] - cdf[:, None, :]).min(-1) < 1e-5
    u = np.where(near, u - 3e-5, u).astype(np.float32)
    # The ends. u = 1 only on a row whose last interval has mass: where the
    # tail is degenerate, float32 cumsum lands cdf[-1] on either side of 1
    # and picks a bracket one bin apart.
    u[0, 0], u[5, 0] = 0.0, 1.0
    # The JAX side draws its uniforms from a key; hand it ours by patching
    # the draw so both invert the same numbers.
    orig = jax.random.uniform
    try:
        jax.random.uniform = lambda key, shape, dtype=jnp.float32: jnp.asarray(u)
        want = jsampling.sample_pdf(jax.random.PRNGKey(0), jnp.asarray(bins), jnp.asarray(weights), s)
    finally:
        jax.random.uniform = orig
    got = sampling.sample_pdf(T(bins), T(weights), s, u=T(u))
    # The cdf's float32 cumsum order differs between the frameworks; the
    # difference reaches a sample scaled by bin width / interval mass.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # Deterministic u ends at 1.0: compare the rows without degenerate tails.
    b, w = bins[3:], weights[3:]
    det_want = jsampling.sample_pdf(None, jnp.asarray(b), jnp.asarray(w), s, deterministic=True)
    det_got = sampling.sample_pdf(T(b), T(w), s, deterministic=True)
    np.testing.assert_allclose(det_got.numpy(), np.asarray(det_want), rtol=1e-5, atol=1e-5)


def test_stratified_and_fine_z_vals_eval():
    rng = _rng(2)
    near = np.full((8, 1), 0.5, np.float32)
    far = rng.uniform(3, 6, (8, 1)).astype(np.float32)
    for lindisp in (False, True):
        want = jsampling.stratified_z_vals(None, jnp.asarray(near), jnp.asarray(far), 16, lindisp, False)
        got = sampling.stratified_z_vals(T(near), T(far), 16, lindisp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    w = rng.uniform(0, 1, (8, 16)).astype(np.float32)
    want = jsampling.fine_z_vals(None, want, jnp.asarray(w), 24, perturb=False)
    got = sampling.fine_z_vals(got, T(w), 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("ndc", [False, True])
def test_composite_matches_jax(ndc):
    rng = _rng(3)
    nr, ns, k = 10, 12, 2
    sigma = rng.uniform(0, 3, (nr, ns)).astype(np.float32)
    rgb = rng.uniform(0, 1, (3, nr, ns)).astype(np.float32)
    z = np.sort(rng.uniform(0.0, 0.99 if ndc else 5.0, (nr, ns)), axis=-1).astype(np.float32)
    rd = rng.standard_normal((nr, 3)).astype(np.float32)
    ro_w = rng.standard_normal((nr, 3)).astype(np.float32) * 0.1
    rd_w = rng.standard_normal((nr, 3)).astype(np.float32)
    rd_w[:, 2] = -np.abs(rd_w[:, 2]) - 0.5
    vis2 = rng.uniform(0, 1, (nr, ns, k)).astype(np.float32)
    kw = dict(ndc=ndc, white_bkgd=True)
    want = jvolume.composite(
        jnp.asarray(sigma), jnp.asarray(rgb), jnp.asarray(z), jnp.asarray(rd),
        rays_o_world=jnp.asarray(ro_w) if ndc else None,
        rays_d_world=jnp.asarray(rd_w) if ndc else None, vis2=jnp.asarray(vis2), **kw,
    )
    got = volume.composite(
        T(sigma), T(rgb), T(z), T(rd), rays_o_world=T(ro_w) if ndc else None,
        rays_d_world=T(rd_w) if ndc else None, vis2=T(vis2), **kw,
    )
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5, atol=1e-5, err_msg=key)


def test_rays_and_ndc_match_jax():
    rng = _rng(4)
    h, w = 6, 9
    K = np.array([[8.0, 0, w / 2], [0, 8.5, h / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    c2w[:3, 3] = rng.standard_normal(3) * 0.2
    for half in (False, True):
        ro, rd = rays.get_rays(h, w, T(K), T(c2w), half)
        jro, jrd = jrays.get_rays(h, w, jnp.asarray(K), jnp.asarray(c2w), half)
        np.testing.assert_allclose(ro.numpy(), np.asarray(jro), atol=1e-6)
        np.testing.assert_allclose(rd.numpy(), np.asarray(jrd), atol=1e-5)
    np.testing.assert_allclose(rays.get_view_dirs(rd).numpy(), np.asarray(jrays.get_view_dirs(jrd)), atol=1e-6)
    rd_np = np.asarray(jrd).copy()
    rd_np[..., 2] = -np.abs(rd_np[..., 2]) - 0.3
    o_ndc, d_ndc = rays.ndc_rays(ro, T(rd_np), h, w, float(K[0, 0]), float(K[1, 1]), 1.0)
    jo, jd = jrays.ndc_rays(jro, jnp.asarray(rd_np), h, w, K[0, 0], K[1, 1], 1.0)
    np.testing.assert_allclose(o_ndc.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d_ndc.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rays.get_radii(T(rd_np)[None]).numpy(),
                               np.asarray(jrays.get_radii(jnp.asarray(rd_np)[None])), atol=1e-6)
    np.testing.assert_allclose(rays.get_radii_ndc(o_ndc[None]).numpy(),
                               np.asarray(jrays.get_radii_ndc(jo[None])), atol=1e-5)
    depth = rng.uniform(1, 4, (h, w, 1)).astype(np.float32)
    z = projection.depth_to_ndc(T(depth), ro, T(rd_np))
    np.testing.assert_allclose(z.numpy(), np.asarray(jproj.depth_to_ndc(jnp.asarray(depth), jro, jnp.asarray(rd_np))), atol=1e-5)
    back = projection.depth_from_ndc(z, ro, T(rd_np))
    np.testing.assert_allclose(back.numpy(), np.asarray(jproj.depth_from_ndc(jnp.asarray(z.numpy()), jro, jnp.asarray(rd_np))), rtol=1e-4)
    pts = (rng.standard_normal((5, 3)) + [0, 0, -3]).astype(np.float32)
    w2c = np.tile(c2w[None], (5, 1, 1))
    np.testing.assert_allclose(projection.reproject(T(pts), T(w2c), T(K)).numpy(),
                               np.asarray(jproj.reproject(jnp.asarray(pts), jnp.asarray(w2c), jnp.asarray(K))), rtol=1e-4, atol=1e-4)


def test_preprocess_poses_matches_jax():
    rng = _rng(5)
    w2c = np.tile(np.eye(4), (4, 1, 1))
    for i in range(4):
        w2c[i, :3, :3] = np.linalg.qr(rng.standard_normal((3, 3)) * 0.1 + np.eye(3))[0]
        w2c[i, :3, 3] = rng.standard_normal(3)
    bounds = np.array([2.0, 9.0])
    want = jposes.preprocess_poses(w2c, bounds=bounds, bd_factor=0.75)
    got = poses.preprocess_poses(w2c, bounds=bounds, bd_factor=0.75)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    test_want = jposes.preprocess_poses(w2c[:1], translation_scale=want["sc"], avg_pose=want["average_pose"], train_mode=False)
    test_got = poses.preprocess_poses(w2c[:1], translation_scale=got["sc"], avg_pose=got["average_pose"], train_mode=False)
    np.testing.assert_array_equal(test_got["poses"], test_want["poses"])


# ---------------------------------------------------------------------------
# The whole render (eval), JAX-initialized parameters on both sides
# ---------------------------------------------------------------------------

NR, NSC, NSF = 64, 16, 32
MLP_KW = dict(points_net_depth=4, views_net_depth=1, points_net_width=32, views_net_width=16,
              points_pe_degree=4, views_pe_degree=2, skip_layers=(2,))


def _render_cfgs(ndc, fused, visibility=False):
    kw = dict(MLP_KW, predict_visibility=visibility)
    rkw = dict(ndc=ndc, perturb=False, raw_noise_std=0.0, compute_dtype="float32", fused_mlp=fused)
    jcfg = jrenderer.RenderConfig(coarse_mlp=JMLPConfig(num_samples=NSC, **kw),
                                  fine_mlp=JMLPConfig(num_samples=NSF, **kw), **rkw)
    tcfg = renderer.RenderConfig(coarse_mlp=MLPConfig(num_samples=NSC, **kw),
                                 fine_mlp=MLPConfig(num_samples=NSF, **kw), **rkw)
    return jcfg, tcfg


def _batch(ndc, k2=0):
    rng = _rng(11)
    d = rng.standard_normal((NR, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    o = (rng.standard_normal((NR, 3)) * 0.05).astype(np.float32)
    b = {"rays_o": o, "rays_d": d, "view_dirs": d / np.linalg.norm(d, axis=-1, keepdims=True),
         "near": np.full((NR, 1), 1.0, np.float32), "far": np.full((NR, 1), 6.0, np.float32)}
    if ndc:
        jo, jd = jrays.ndc_rays(jnp.asarray(o), jnp.asarray(d), 24, 32, 30.0, 30.0, 1.0)
        b.update(rays_o_ndc=np.array(jo), rays_d_ndc=np.array(jd),
                 near_ndc=np.zeros((NR, 1), np.float32), far_ndc=np.ones((NR, 1), np.float32))
    if k2:
        b["rays_o2"] = (rng.standard_normal((NR, k2, 3)) * 0.1).astype(np.float32)
    return b


@pytest.mark.parametrize(
    "ndc,fused,vis", [(False, "off", False), (False, "on", False), (True, "off", True)],
    ids=["metric", "metric-fused", "ndc-visibility2"],
)
def test_render_rays_matches_jax(ndc, fused, vis):
    jcfg, tcfg = _render_cfgs(ndc, fused, vis)
    jparams = jrenderer.init(jax.random.PRNGKey(3), jcfg)
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    batch = _batch(ndc, k2=2 if vis else 0)
    want = jrenderer.render_rays(jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                                 sec_views_vis=vis, retraw=True)
    got = renderer.render_rays(tparams, tcfg, {k: T(v) for k, v in batch.items()},
                               sec_views_vis=vis, retraw=True)
    assert set(got) == set(want)
    for k in want:
        if k.endswith("_coarse"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-5, rtol=2e-5, err_msg=k)
    # Inverse-CDF sampling is chaotic where pdf bins are tiny: a float32
    # summation-order difference shifts a sample by ~1/denom, so z_vals_fine
    # gets tests/test_torch_parity.py's 5e-3, and the fine level is rendered
    # again below at the JAX z values.
    np.testing.assert_allclose(got["z_vals_fine"].numpy(), np.asarray(want["z_vals_fine"]), atol=5e-3)
    rays_t = {k: T(v) for k, v in batch.items()}
    comp, _ = renderer._run_level(tcfg, tparams, "fine", tcfg.fine_mlp,
                                  T(np.array(want["z_vals_fine"])), rays_t, vis)
    for k, v in comp.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[f"{k}_fine"]), atol=2e-5, rtol=2e-5, err_msg=k)


def test_render_rays_lean_and_train_guard():
    jcfg, tcfg = _render_cfgs(False, "off")
    params = renderer.init(torch.Generator().manual_seed(0), tcfg)
    batch = {k: T(v) for k, v in _batch(False).items()}
    lean = renderer.render_rays(params, tcfg, batch, keep_per_sample=False)
    assert not any(k.startswith("z_vals") or "weights" in k or "alpha" in k for k in lean)
    assert lean["rgb_fine"].shape == (NR, 3)
    with pytest.raises(NotImplementedError):
        renderer.render_rays(params, tcfg, batch, train=True)


@pytest.mark.parametrize("setting", ["auto", "on", "off"])
def test_fused_switch_never_skips_the_card_kernel(setting):
    _, tcfg = _render_cfgs(False, setting)
    assert renderer._use_fused(tcfg, torch.device("cpu")) == (setting == "on")
    if setting == "off":
        with pytest.raises(ValueError, match="no CUDA path"):
            renderer._use_fused(tcfg, torch.device("cuda"))
    else:
        assert renderer._use_fused(tcfg, torch.device("cuda"))
