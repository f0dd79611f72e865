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


def _run_bwd_program(spec, kp, lo, hi, hvxs, d_planes):
    """Execute `pack_bwd_program`'s output with PyTorch ops, tile by tile and
    task by task, as the backward kernels do: (per-member dkp, dhvx stack)."""
    n = lo.shape[0]
    plan = fused_mlp.pack_bwd_program(spec, kp, n)
    hdr = plan.header.tolist()
    ns, in_lo, in_hi, lo_kpad, hi_kpad = hdr[2:7]
    members = spec.members if isinstance(spec, fused_mlp.EnsembleSpec) else (spec,)
    cd = members[0].cdtype
    bm, _ = fused_mlp._tiling(cd)
    stash = torch.zeros(plan.stash_cols * n, dtype=cd)
    g32 = torch.zeros((max(plan.n_hvx, 1), n, max(plan.hvx_w, 1)))
    n_tiles = -(-n // bm)
    parts = torch.zeros((n_tiles, plan.part_w))
    dp = d_planes.reshape(d_planes.shape[0], n)

    def slot(off, w):
        return stash[off * n : (off + w) * n].view(n, w)

    def weight(off, rows, kpad):
        return plan.wts[off : off + rows * kpad].view(rows, kpad).float()

    for t in range(n_tiles):
        rows = slice(t * bm, min(n, (t + 1) * bm))
        masks = {}  # the tile's ReLU masks by mask slot, from each layer's rounded activation
        tiles = {fused_mlp._SRC_LO: torch.zeros((rows.stop - rows.start, lo_kpad), dtype=cd)}
        tiles[fused_mlp._SRC_LO][:, :in_lo] = lo[rows]
        if in_hi:
            tiles[fused_mlp._SRC_HI] = torch.zeros((rows.stop - rows.start, hi_kpad), dtype=cd)
            tiles[fused_mlp._SRC_HI][:, :in_hi] = hi[rows]
        acc = None
        for op in plan.ops.tolist():
            kind, width, b_off, flags, nseg = op[:5]
            src, w_off, kpad = op[5:8], op[8:11], op[11:14]
            plane, hvx_slot, out_slot, gn, mask, hn, hw_off, part, g32_slot, part2 = op[14:]
            if kind == fused_mlp._F_IN:
                slot(out_slot, gn)[rows] = tiles[src[0]][:, :gn]
                continue
            d = dp[plane : plane + hn, rows]
            if kind == fused_mlp._F_LAYER:
                v = sum(tiles[src[s]].float()[:, : kpad[s]] @ weight(w_off[s], width, kpad[s]).T
                        for s in range(nseg)) + plan.fpar[b_off : b_off + width]
                if flags & fused_mlp._FLAG_HVX:
                    v = v + hvxs[hvx_slot].repeat_interleave(ns, 0)[rows]
                if flags & fused_mlp._FLAG_RELU:
                    v = torch.relu(v)
                tiles[fused_mlp._SRC_ACT] = v.to(cd)
                slot(out_slot, width)[rows] = v.to(cd)
                if flags & fused_mlp._FLAG_RELU:
                    masks[mask] = v.to(cd).float() > 0
                if hn:  # the head this layer feeds: partials of its rounded activation
                    parts[t, part : part + hn * width] = (d @ v.to(cd).float()).reshape(-1)
                    parts[t, part2 : part2 + hn] = d.sum(1)
                continue
            v = torch.zeros((rows.stop - rows.start, gn)) if flags & fused_mlp._FLAG_ZERO else acc
            if hn:
                v = v + d.T @ plan.fpar[hw_off : hw_off + hn * gn].view(hn, gn)
            if flags & fused_mlp._FLAG_RELU:
                v = v * masks[mask]
            if g32_slot >= 0:
                g32[g32_slot, rows] = v
            tiles[fused_mlp._SRC_ACT] = v.to(cd)
            slot(out_slot, gn)[rows] = v.to(cd)
            parts[t, part : part + gn] = v.sum(0)
            if nseg:
                acc = v.to(cd).float() @ weight(w_off[0], width, kpad[0]).T

    dw = torch.zeros(plan.dw_total)
    for a_slot, a_w, g_slot, g_w, k_in, n_out, off, i0, j0 in plan.tasks.tolist():
        a = slot(a_slot, a_w).float()[:, i0 : min(i0 + 128, k_in)]
        gm = slot(g_slot, g_w).float()[:, j0 : min(j0 + 128, n_out)]
        view = dw[off : off + k_in * n_out].view(k_in, n_out)
        view[i0 : i0 + a.shape[1], j0 : j0 + gm.shape[1]] = a.T @ gm
    dhvx = g32[: plan.n_hvx].reshape(plan.n_hvx, n // ns, ns, g32.shape[-1]).sum(2)
    return fused_mlp.unpack_grads(plan, dw, parts.sum(0)), dhvx


def _assert_grads_close(got, want, tol):
    for k in want:
        scale = want[k].abs().max().item()
        err = (got[k] - want[k]).abs().max().item()
        assert err <= tol * max(scale, 1e-30), f"{k}: err {err} vs scale {scale}"


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES) + ["published"])
def test_packed_bwd_program_computes_plain_version(name, dtype_name):
    kw = {**SMALL, **CASES.get(name, dict(points_net_depth=8, points_net_width=256,
                                          views_net_width=128, skip_layers=(4,)))}
    cfg = mlp.MLPConfig(**kw)
    g = torch.Generator().manual_seed(1)
    params = mlp.init(g, cfg)
    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    nr, ns = 37, 7  # rows straddle the 64/128-row tiles
    pts = torch.randn((nr * ns, 3), generator=g)
    dirs = torch.nn.functional.normalize(torch.randn((nr, 3), generator=g), dim=-1)
    spec, kp, lo, hi, hvx = mlp.fused_operands(params, cfg, pts, dirs, ns, dtype)
    d_planes = torch.randn((spec.n_planes, nr, ns), generator=g)
    want, want_hvx = fused_mlp.fused_bwd_reference(spec, kp, lo, hi, hvx, d_planes)
    (got,), got_hvx = _run_bwd_program(spec, kp, lo, hi, [hvx] if hvx is not None else [], d_planes)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    _assert_grads_close(got, want, tol)
    if hvx is not None:
        _assert_grads_close({"h": got_hvx[0]}, {"h": want_hvx}, tol)
    assert fused_mlp.pack_bwd_program(spec, kp, nr * ns).smem <= fused_mlp._SMEM_LIMIT


def _trio_operands(nr, ns, dtype, seed=2, **width):
    g = torch.Generator().manual_seed(seed)
    members = []
    for name in ("main", "points_aug", "lambertian"):
        cfg = mlp.MLPConfig(**{**SMALL, **CASES[name], **width})
        members.append((mlp.init(g, cfg), cfg))
    pts = torch.randn((nr * ns, 3), generator=g)
    dirs = torch.nn.functional.normalize(torch.randn((nr, 3), generator=g), dim=-1)
    return mlp.ensemble_operands(members, pts, dirs, ns, dtype)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_packed_ensemble_programs_compute_plain_versions(dtype_name):
    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    nr, ns = 21, 9
    g = torch.Generator().manual_seed(3)
    ens, kps, lo, hvxs = _trio_operands(nr, ns, dtype)
    d_planes = torch.randn((ens.n_planes, nr, ns), generator=g)
    want, want_hvx = fused_mlp.fused_ens_bwd_reference(ens, kps, lo, hvxs, d_planes)
    got, got_hvx = _run_bwd_program(ens, kps, lo, None, hvxs, d_planes)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        _assert_grads_close(a, b, tol)
    for a, b in zip(got_hvx, want_hvx):
        _assert_grads_close({"h": a}, {"h": b}, tol)
    words, _, _, smem = fused_mlp.pack_program(ens, kps, nr * ns)
    assert words[0] <= fused_mlp._MAX_OPS and smem <= fused_mlp._SMEM_LIMIT


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["single", "trio"])
def test_bwd_program_offsets_disjoint_and_in_range(which, dtype_name):
    """Every per-tile partial (layer db, head dW and db) of the packed backward
    program has its own range inside the partials row, and every ReLU layer
    its own mask slot, which its backward layer reads; the mask buffer holds
    every thread's words of every tile, the ragged last one included."""
    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    nr, ns = 1037, 64  # 66,368 rows: a ragged last 128-row tile in bf16 (f32 tiles are 64)
    published = dict(points_net_depth=8, points_net_width=256, views_net_width=128,
                     skip_layers=(4,))
    if which == "single":
        cfg = mlp.MLPConfig(**{**SMALL, **published})
        g = torch.Generator().manual_seed(1)
        pts = torch.randn((nr * ns, 3), generator=g)
        dirs = torch.nn.functional.normalize(torch.randn((nr, 3), generator=g), dim=-1)
        spec, kp, *_ = mlp.fused_operands(mlp.init(g, cfg), cfg, pts, dirs, ns, dtype)
    else:
        spec, kp, _, _ = _trio_operands(nr, ns, dtype, **published)
    n = nr * ns
    plan = fused_mlp.pack_bwd_program(spec, kp, n)
    bm, _ = fused_mlp._tiling(dtype)
    assert (n % bm > 0) == (dtype == torch.bfloat16)
    n_masks = int(plan.header[15])
    ranges, relu_f, relu_b = [], {}, []
    for op in plan.ops.tolist():
        kind, width, flags = op[0], op[1], op[3]
        gn, mask, hn, part, part2 = op[17], op[18], op[19], op[21], op[23]
        if kind == fused_mlp._F_LAYER:
            if hn:
                ranges += [(part, part + hn * width), (part2, part2 + hn)]
            if flags & fused_mlp._FLAG_RELU:
                assert mask not in relu_f and 0 <= mask < n_masks
                relu_f[mask] = width
            else:
                assert mask == -1
        elif kind == fused_mlp._B_LAYER:
            ranges.append((part, part + gn))
            if flags & fused_mlp._FLAG_RELU:
                relu_b.append((mask, gn))
    assert len(relu_f) == n_masks
    # each ReLU layer's mask is read back once, by a backward layer of its width
    assert sorted(relu_b) == sorted(relu_f.items())
    ranges.sort()
    assert ranges[0][0] >= 0 and ranges[-1][1] <= plan.part_w
    assert all(a[1] <= b[0] for a, b in zip(ranges, ranges[1:])), "partials overlap"
    assert sum(b - a for a, b in ranges) == plan.part_w
    threads = 4 * bm
    last = ((-(-n // bm) - 1) * n_masks + n_masks - 1) * threads + threads - 1
    assert 2 * (last + 1) == plan.mask_words
