"""The port's training data path, train-mode render and loss stack against JAX.

- data: the scene preprocessor's ray cache, the epoch samplers' index
  streams (numpy, the same seed), `fast_forward` and `gather_batch`;
- render: `render_rays(train=True)` with the full coarse trio (perturb off,
  no sigma noise: the JAX draws come from its own keys), the port through
  the ensemble's plain version and through the unfused MLP;
- losses: each of the nine losses' value, loss maps and gradients with
  respect to the render outputs, at an iteration where the consistency ramp
  is on.

Everything in float32 on the CPU, on a tiny synthetic scene.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from simplenerf_tpu.data import get_data_loader as jget_data_loader
from simplenerf_tpu.data import preprocessor as jpre
from simplenerf_tpu.data.synthetic import generate_scene
from simplenerf_tpu.drivers.presets import tiny_synthetic_config
from simplenerf_tpu.fields.mlp import MLPConfig as JMLPConfig
from simplenerf_tpu.losses import LossComputer as JLossComputer
from simplenerf_tpu.render import renderer as jrenderer
from simplenerf_tpu.training.trainer import loss_context_from_configs as jctx
from simplenerf_torch import convert
from simplenerf_torch.data import preprocessor as pre
from simplenerf_torch.data.factory import get_data_loader
from simplenerf_torch.fields.mlp import MLPConfig
from simplenerf_torch.losses import LossComputer
from simplenerf_torch.render import renderer
from simplenerf_torch.training.trainer import loss_context_from_configs

LOSS_ITER = 150  # the tiny preset ramps consistency in at 100 -> weight 0.1 here


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("db")
    generate_scene(root, num_frames=5, h=24, w=32, num_train=3, seed=3)
    cfg = tiny_synthetic_config(num_rays=96, sparse_depth_rays=48)
    jraw = jget_data_loader(cfg, root, "train").load_data()
    raw = get_data_loader(cfg, root, "train").load_data()
    return root, cfg, jraw, raw


def _pps(scene):
    _, cfg, jraw, raw = scene
    return (jpre.ScenePreprocessor(cfg, "train", jraw, seed=0),
            pre.ScenePreprocessor(cfg, "train", raw, device="cpu", seed=0))


def _np(v):
    return v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)


def test_ray_cache_and_model_configs_match_jax(scene):
    jpp, pp = _pps(scene)
    assert pp.get_model_configs() == jpp.get_model_configs()
    assert set(pp.cache) == set(jpp.cache)
    assert pp.packed_layout == jpp.packed_layout
    for k in jpp.cache:
        np.testing.assert_allclose(_np(pp.cache[k]), np.asarray(jpp.cache[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    for k in ("images", "poses", "intrinsics"):
        np.testing.assert_allclose(_np(pp.common[k]), np.asarray(jpp.common[k]), atol=1e-6)
    assert pp.batch_constants() == jpp.batch_constants()


def test_sampler_streams_and_fast_forward_match_jax(scene):
    jpp, pp = _pps(scene)
    draws = [pp.next_indices(it) for it in range(4)]
    for it, draw in enumerate(draws):
        for a, b in zip(draw, jpp.next_indices(it)):
            np.testing.assert_array_equal(a, b)
    # A resumed preprocessor replays three iterations and then draws what
    # the continuous one drew at the fourth, in both packages.
    jpp2, pp2 = _pps(scene)
    pp2.fast_forward(3)
    jpp2.fast_forward(3)
    for got in (pp2.next_indices(3), jpp2.next_indices(3)):
        for a, b in zip(got, draws[3]):
            np.testing.assert_array_equal(a, b)
    # Wrap-around: more draws than the sparse-depth pool holds.
    n_pool = len(pp.sparse_sampler.pool)
    np.testing.assert_array_equal(pp.sparse_sampler.next(n_pool + 7), jpp.sparse_sampler.next(n_pool + 7))


def test_gather_batch_matches_jax(scene):
    jpp, pp = _pps(scene)
    idx, mn, ms = pp.next_indices(0)
    jb = jpre.gather_batch(jpp.cache, jpp.common, jpp.batch_constants(), jnp.asarray(idx),
                           jnp.asarray(mn), jnp.asarray(ms), packed_layout=jpp.packed_layout)
    b = pre.gather_batch(pp.cache, pp.common, pp.batch_constants(), torch.as_tensor(idx),
                         torch.as_tensor(mn), torch.as_tensor(ms), packed_layout=pp.packed_layout)
    assert set(b) == set(jb)
    for k in jb:
        if k != "common":
            np.testing.assert_allclose(_np(b[k]), np.asarray(jb[k]), rtol=1e-5, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# render_rays(train=True) with the coarse trio
# ---------------------------------------------------------------------------

NR, NSC, NSF = 48, 16, 32
MLP_KW = dict(points_net_depth=4, views_net_depth=1, points_net_width=32, views_net_width=16,
              points_pe_degree=4, views_pe_degree=2, skip_layers=(2,))


def _trio_cfgs(fused):
    trio = dict(
        coarse=dict(num_samples=NSC), fine=dict(num_samples=NSF),
        points_aug_coarse=dict(num_samples=NSC, points_sigma_pe_degree=2),
        views_aug_coarse=dict(num_samples=NSC, use_view_dirs=False, view_dependent_rgb=False),
    )
    rkw = dict(ndc=False, perturb=False, raw_noise_std=0.0, compute_dtype="float32")
    jcfg = jrenderer.RenderConfig(**{f"{k}_mlp": JMLPConfig(**MLP_KW, **v) for k, v in trio.items()},
                                  fused_mlp="off", **rkw)
    tcfg = renderer.RenderConfig(**{f"{k}_mlp": MLPConfig(**MLP_KW, **v) for k, v in trio.items()},
                                 fused_mlp=fused, **rkw)
    return jcfg, tcfg


def _rays():
    rng = np.random.default_rng(11)
    d = rng.standard_normal((NR, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    o = (rng.standard_normal((NR, 3)) * 0.05).astype(np.float32)
    return {"rays_o": o, "rays_d": d, "view_dirs": d / np.linalg.norm(d, axis=-1, keepdims=True),
            "near": np.full((NR, 1), 1.0, np.float32), "far": np.full((NR, 1), 6.0, np.float32)}


@pytest.mark.parametrize("fused", ["on", "off"], ids=["ensemble", "unfused"])
def test_render_rays_train_with_trio_matches_jax(fused):
    jcfg, tcfg = _trio_cfgs(fused)
    jparams = jrenderer.init(jax.random.PRNGKey(3), jcfg)
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    rays = _rays()
    want = jrenderer.render_rays(jparams, jcfg, {k: jnp.asarray(v) for k, v in rays.items()},
                                 key=None, train=True)
    trays = {k: torch.from_numpy(v) for k, v in rays.items()}
    got = renderer.render_rays(tparams, tcfg, trays, train=True)
    assert set(got) == set(want)
    for prefix in ("points_augmentation_", "views_augmentation_"):
        aug = [k for k in got if k.startswith(prefix)]
        assert f"{prefix}rgb_coarse" in aug and all(k.endswith("_coarse") for k in aug)
    for k in want:
        if k.endswith("_coarse"):
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), atol=2e-5, rtol=2e-5, err_msg=k)
    # The fine level at the JAX fine samples (inverse-CDF sampling is chaotic
    # at bin edges; tests/test_torch_port_render.py).
    np.testing.assert_allclose(_np(got["z_vals_fine"]), np.asarray(want["z_vals_fine"]), atol=5e-3)
    comp, _ = renderer._run_level(tcfg, tparams, "fine", tcfg.fine_mlp,
                                  torch.from_numpy(np.array(want["z_vals_fine"])), trays, False, True)
    for k, v in comp.items():
        np.testing.assert_allclose(_np(v), np.asarray(want[f"{k}_fine"]), atol=2e-5, rtol=2e-5, err_msg=k)


def test_render_train_draws_follow_the_generator():
    """Jitter and noise come from the generator, on the rays' device: the same
    seed gives the same render, another seed another."""
    _, tcfg = _trio_cfgs("on")
    tcfg = dataclasses.replace(tcfg, perturb=True, raw_noise_std=1.0)
    params = renderer.init(torch.Generator().manual_seed(0), tcfg)
    trays = {k: torch.from_numpy(v) for k, v in _rays().items()}
    a, b, c = (renderer.render_rays(params, tcfg, trays, train=True,
                                    generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["z_vals_coarse"], c["z_vals_coarse"])
    assert not torch.equal(a["points_augmentation_raw_sigma_coarse"],
                           c["points_augmentation_raw_sigma_coarse"])


# ---------------------------------------------------------------------------
# The nine losses
# ---------------------------------------------------------------------------

OUTPUT_KEYS = ("rgb_coarse", "rgb_fine", "points_augmentation_rgb_coarse",
               "views_augmentation_rgb_coarse", "depth_coarse", "depth_fine",
               "points_augmentation_depth_coarse", "views_augmentation_depth_coarse")


def test_nine_losses_values_maps_and_grads_match_jax(scene):
    _, cfg, _, _ = scene
    jpp, pp = _pps(scene)
    idx, mn, ms = pp.next_indices(0)
    jb = jpre.gather_batch(jpp.cache, jpp.common, jpp.batch_constants(), jnp.asarray(idx),
                           jnp.asarray(mn), jnp.asarray(ms), packed_layout=jpp.packed_layout)
    b = pre.gather_batch(pp.cache, pp.common, pp.batch_constants(), torch.as_tensor(idx),
                         torch.as_tensor(mn), torch.as_tensor(ms), packed_layout=pp.packed_layout)
    nr = len(idx)
    rng = np.random.default_rng(2)
    # Depths around the scene's (most rays reproject into the other view, so
    # the arbitration masks are neither all on nor all off), colors in (0, 1).
    depth = np.asarray(jpp.cache["sparse_depth_values"])[idx, 0]
    base = np.where(depth > 0, depth, np.median(depth[depth > 0]))
    outputs = {}
    for k in OUTPUT_KEYS:
        if "rgb" in k:
            outputs[k] = rng.uniform(0.05, 0.95, (nr, 3)).astype(np.float32)
        else:
            outputs[k] = (base * rng.uniform(0.85, 1.15, nr)).astype(np.float32)

    jlc = JLossComputer(cfg["losses"], jctx(cfg))
    lc = LossComputer(cfg["losses"], loss_context_from_configs(cfg))
    assert lc.names == jlc.names and len(lc.names) == 9
    weights = lc.weights_vector(LOSS_ITER)
    np.testing.assert_array_equal(weights, jlc.weights_vector(LOSS_ITER))
    assert (weights > 0).all()

    def jtotal(out):
        total, values, maps = jlc.compute(jb, out, jnp.asarray(weights), return_loss_maps=True)
        return total, (values, maps)

    (_, (jvalues, jmaps)), jgrads = jax.value_and_grad(jtotal, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outputs.items()})
    tout = {k: torch.from_numpy(v).requires_grad_() for k, v in outputs.items()}
    total, values, maps = lc.compute(b, tout, weights.tolist(), return_loss_maps=True)
    total.backward()
    assert set(values) == set(jvalues) and set(maps) == set(jmaps)
    for k in jvalues:
        np.testing.assert_allclose(_np(values[k]), np.asarray(jvalues[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    for k in jmaps:
        np.testing.assert_allclose(_np(maps[k]), np.asarray(jmaps[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    for k in OUTPUT_KEYS:
        np.testing.assert_allclose(_np(tout[k].grad), np.asarray(jgrads[k]), rtol=1e-5, atol=1e-8,
                                   err_msg=k)
    # The arbitration selects some rays and not others at this setting.
    sel = _np(maps["CoarseFineConsistencyLoss02_fine"]) > 0
    assert 0 < sel.sum() < sel.size
