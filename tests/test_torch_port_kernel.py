"""simplenerf_torch.ops.fused_mlp against the JAX package's fused MLP.

The JAX side runs its Pallas forward kernel in interpret mode on the CPU
(as tests/test_ops.py does); the port's `fused_apply` takes its plain
PyTorch version for CPU tensors. Inputs are numpy arrays from one seed;
parameters cross over with `convert.params_from_numpy`.

The host-side packing that feeds the CUDA kernel (`pack_program`) is
checked here too, by executing the packed program with PyTorch ops: the
kernel itself runs only on the card (tests/test_torch_port_cuda.py).
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
NR, NS = 6, 5  # a ray count that no tile divides

# f32: both sides compute the same products in float32; only summation
# order differs (test_ops.py's bound). bf16: both round every activation to
# bf16, and an order difference of one float32 ulp can flip a rounding of an
# O(1) activation by 2^-8 ~ 4e-3; through the next layer's weights and the
# output sigmoid (slope <= 1/4) or ReLU such a flip moves an output by about
# that much, hence 5e-3 rather than float32 precision.
ATOL = {"float32": 3e-5, "bfloat16": 5e-3}


def _case(name, dtype_name, seed=0):
    kw = {**SMALL, **CASES[name]}
    jcfg = jmlp.MLPConfig(**kw)
    tcfg = mlp.MLPConfig(**kw)
    jparams = jmlp.init(jax.random.PRNGKey(3 + seed), jcfg)
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((NR * NS, 3)).astype(np.float32)
    dirs = rng.standard_normal((NR, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    jdt = jnp.bfloat16 if dtype_name == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    return jcfg, tcfg, jparams, tparams, pts, dirs, jdt, tdt


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_apply_fused_matches_jax(name, dtype_name):
    jcfg, tcfg, jparams, tparams, pts, dirs, jdt, tdt = _case(name, dtype_name)
    want = jmlp.apply_fused(
        jparams, jcfg, jnp.asarray(pts), view_dirs=jnp.asarray(dirs), dtype=jdt, view_dirs_tile=NS
    )
    got = mlp.apply_fused(
        tparams, tcfg, torch.from_numpy(pts), view_dirs=torch.from_numpy(dirs), dtype=tdt,
        view_dirs_tile=NS,
    )
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(want[k], np.float32), atol=ATOL[dtype_name],
            err_msg=f"{name}/{k}",
        )


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_params_and_dirs_w_match_jax(name):
    jcfg, tcfg, jparams, tparams, *_ = _case(name, "float32")
    want = jfused.kernel_params(jparams, jcfg)
    got = fused_mlp.kernel_params(tparams, tcfg)
    assert list(got) == list(want)
    spec = fused_mlp.make_spec(tcfg, NS, torch.float32)
    assert spec.param_keys() == jfused.make_spec(jcfg, NS, jnp.float32).param_keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    if tcfg.use_view_dirs and tcfg.view_dep_outputs:
        np.testing.assert_array_equal(
            fused_mlp.dirs_w(tparams, tcfg).numpy(), np.asarray(jfused.dirs_w(jparams, jcfg))
        )


def _run_program(spec, kp, lo, hi, hvx):
    """Execute `pack_program`'s output with PyTorch ops, as the kernel does."""
    n = lo.shape[0]
    words, wts, fpar, _ = fused_mlp.pack_program(spec, kp, n)
    hw = fused_mlp._HEADER_WORDS
    hdr, ops = words[:hw], words[hw:].reshape(-1, fused_mlp._OP_WORDS)
    assert hdr[0] == len(ops) and hdr[1] == n and hdr[2] == spec.ns
    cd = spec.cdtype
    tiles = {
        fused_mlp._SRC_LO: torch.zeros((n, hdr[5]), dtype=cd),
        fused_mlp._SRC_HI: torch.zeros((n, hdr[6]), dtype=cd),
    }
    tiles[fused_mlp._SRC_LO][:, : hdr[3]] = lo
    if hdr[4]:
        tiles[fused_mlp._SRC_HI][:, : hdr[4]] = hi
    planes = {}
    for kind, width, b_off, flags, nseg, *rest in ops.tolist():
        src, w_off, kpad, plane = rest[0:3], rest[3:6], rest[6:9], rest[9]
        if kind == fused_mlp._OP_LAYER:
            acc = sum(
                tiles[src[s]].float()
                @ wts[w_off[s] : w_off[s] + width * kpad[s]].reshape(width, kpad[s]).float().T
                for s in range(nseg)
            )
            v = acc + fpar[b_off : b_off + width]
            if flags & fused_mlp._FLAG_HVX:
                v = v + hvx.repeat_interleave(spec.ns, 0)
            if flags & fused_mlp._FLAG_RELU:
                v = torch.relu(v)
            tiles[fused_mlp._SRC_ACT] = v.to(cd)  # the kernel overwrites its one activation tile
        else:
            w = fpar[w_off[0] : w_off[0] + width * kpad[0]].reshape(width, kpad[0])
            for j in range(width):
                planes[plane + j] = (tiles[src[0]].float() @ w[j] + fpar[b_off + j]).reshape(-1, spec.ns)
    return tuple(planes[j] for j in range(spec.n_planes))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES) + ["published"])
def test_packed_program_computes_plain_version(name, dtype_name):
    kw = {**SMALL, **CASES.get(name, dict(points_net_depth=8, points_net_width=256,
                                          views_net_width=128, skip_layers=(4,)))}
    cfg = mlp.MLPConfig(**kw)
    g = torch.Generator().manual_seed(1)
    params = mlp.init(g, cfg)
    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    pts = torch.randn((NR * NS, 3), generator=g)
    dirs = torch.nn.functional.normalize(torch.randn((NR, 3), generator=g), dim=-1)
    spec, kp, lo, hi, hvx = mlp.fused_operands(params, cfg, pts, dirs, NS, dtype)
    want = fused_mlp.fused_apply(spec, kp, lo, hi, hvx)  # CPU tensors: the plain version
    got = _run_program(spec, kp, lo, hi, hvx)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    _, _, _, smem = fused_mlp.pack_program(spec, kp, NR * NS)
    assert smem <= fused_mlp._SMEM_LIMIT


def test_published_flop_count():
    spec = fused_mlp.make_spec(mlp.MLPConfig(), 192, torch.bfloat16)
    assert spec.flops_per_point() == 2 * 589_952


def test_wrapper_rejects_other_devices():
    cfg = mlp.MLPConfig(**SMALL)
    spec = fused_mlp.make_spec(cfg, NS, torch.float32)
    lo = torch.zeros((NR * NS, spec.in_lo), device="meta")
    with pytest.raises(ValueError):
        fused_mlp.fused_apply(spec, {}, lo, None, None)
