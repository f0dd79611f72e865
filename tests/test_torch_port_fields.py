"""simplenerf_torch.fields against simplenerf_tpu.fields (f32, CPU).

Same parameters (JAX init, carried over by `convert.params_from_numpy`)
and the same numpy inputs go through both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from simplenerf_tpu.fields import encoding as jenc
from simplenerf_tpu.fields import mlp as jmlp
from simplenerf_torch import convert
from simplenerf_torch.fields import encoding, mlp

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
}


def _setup(name, seed=0):
    kw = {**SMALL, **CASES[name]}
    jcfg, tcfg = jmlp.MLPConfig(**kw), mlp.MLPConfig(**kw)
    jparams = jmlp.init(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(seed)
    return jcfg, tcfg, jparams, tparams, rng


def _close(got: dict, want: dict, atol, label=""):
    assert set(got) == set(want), label
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=atol, err_msg=f"{label}/{k}")


def test_encoding_matches_jax():
    x = np.random.default_rng(1).standard_normal((7, 3)).astype(np.float32)
    for d in (0, 2, 10):
        np.testing.assert_allclose(encoding.encode(torch.from_numpy(x), d).numpy(),
                                   np.asarray(jenc.encode(jnp.asarray(x), d)), atol=1e-6)
        assert encoding.blocked_to_reference_perm(d) == jenc.blocked_to_reference_perm(d)
        assert encoding.out_dim(d) == jenc.out_dim(d)
        if d:
            np.testing.assert_array_equal(encoding.frequency_matrix(d).numpy(),
                                          np.asarray(jenc.frequency_matrix(d)))
            for a, b in zip(encoding.encode_parts(torch.from_numpy(x), d),
                            jenc.encode_parts(jnp.asarray(x), d)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("name", sorted(CASES))
def test_config_properties_match_jax(name):
    jcfg, tcfg, *_ = _setup(name)
    for prop in ("full_points_dim", "sigma_pe_degree", "points_input_dim", "extra_views_dim",
                 "views_input_dim", "view_dep_outputs", "points_output_dim", "views_output_dim"):
        assert getattr(tcfg, prop) == getattr(jcfg, prop), prop


@pytest.mark.parametrize("name", sorted(CASES))
def test_apply_and_reference_match_jax(name):
    jcfg, tcfg, jparams, tparams, rng = _setup(name)
    nr, ns = 5, 4
    pts = rng.standard_normal((nr * ns, 3)).astype(np.float32)
    dirs = rng.standard_normal((nr, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    tp, td = torch.from_numpy(pts), torch.from_numpy(dirs)
    _close(
        mlp.apply(tparams, tcfg, tp, view_dirs=td, view_dirs_tile=ns),
        jmlp.apply(jparams, jcfg, jnp.asarray(pts), view_dirs=jnp.asarray(dirs), view_dirs_tile=ns),
        1e-5, f"{name}/apply",
    )
    dirs_pp = np.repeat(dirs, ns, axis=0)
    _close(
        mlp.apply_reference(tparams, tcfg, tp, view_dirs=torch.from_numpy(dirs_pp)),
        jmlp.apply_reference(jparams, jcfg, jnp.asarray(pts), view_dirs=jnp.asarray(dirs_pp)),
        1e-5, f"{name}/apply_reference",
    )


def test_visibility2_and_noise_match_jax():
    jcfg, tcfg, jparams, tparams, rng = _setup("visibility", seed=2)
    n, k = 12, 3
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    dirs2 = rng.standard_normal((n, k, 3)).astype(np.float32)
    got = mlp.apply(tparams, tcfg, torch.from_numpy(pts), view_dirs=torch.from_numpy(dirs),
                    view_dirs2=torch.from_numpy(dirs2))
    want = jmlp.apply(jparams, jcfg, jnp.asarray(pts), view_dirs=jnp.asarray(dirs),
                      view_dirs2=jnp.asarray(dirs2))
    _close(got, want, 1e-5, "visibility2")

    # Sigma noise enters before the ReLU: feed the JAX draws to the port.
    key = jax.random.PRNGKey(9)
    want = jmlp.apply(jparams, jcfg, jnp.asarray(pts), view_dirs=jnp.asarray(dirs),
                      noise_std=1.0, noise_key=key)
    noise = np.array(jax.random.normal(key, (n, 1)))
    got = mlp.apply(tparams, tcfg, torch.from_numpy(pts), view_dirs=torch.from_numpy(dirs),
                    noise_std=1.0, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got["sigma"].numpy(), np.asarray(want["sigma"]), atol=1e-5)


def test_init_law_and_layout():
    cfg = mlp.MLPConfig(**SMALL)
    params = mlp.init(torch.Generator().manual_seed(0), cfg)
    jshapes = jax.tree_util.tree_map(lambda a: a.shape, jmlp.init(jax.random.PRNGKey(0), jmlp.MLPConfig(**SMALL)))
    tshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), convert.params_to_numpy(params))
    assert tshapes == jshapes
    w = params["pts"][1]["w"]
    bound = 1.0 / np.sqrt(w.shape[0])
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert abs(float(w.mean())) < 0.1 * bound
