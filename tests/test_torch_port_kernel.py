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


def _unswizzle_slab(img, n_pad):
    """The (n_pad, 64) block of W^T held by one slab image: element (n, k)
    sits in row n's 16-byte chunk (k // 8) ^ (n % 8), as the kernel's
    128-byte-swizzle descriptors read it."""
    rows = img.reshape(n_pad, 8, 8)  # row, chunk as stored, element
    n = torch.arange(n_pad)[:, None]
    return rows[n, torch.arange(8)[None, :] ^ (n % 8)].reshape(n_pad, 64)


def _sm90_layers(words):
    """The bf16 program's header and its layers as dicts (struct sm90::Op)."""
    hw = fused_mlp._SM90_HEADER_WORDS
    hdr = words[:hw].tolist()
    names = ("n", "n_pad", "b_off", "flags", "nseg", "src", "kb", "hvx_slot", "plane", "nout",
             "head_w", "head_b")
    layers = []
    for op in words[hw:].reshape(-1, fused_mlp._SM90_OP_WORDS).tolist():
        vals = op[:5] + [op[5:8], op[8:11]] + op[11:]
        layers.append(dict(zip(names, vals)))
    assert hdr[0] == len(layers)
    return hdr, layers


def _slabs(words, wts):
    """Every segment's slabs in stream order: [(layer, segment, W^T padded (n_pad, 64 kb))]."""
    _, layers = _sm90_layers(words)
    out, pos = [], 0
    for li, op in enumerate(layers):
        for s in range(op["nseg"]):
            blocks = []
            for _ in range(op["kb"][s]):
                blocks.append(_unswizzle_slab(wts[pos : pos + op["n_pad"] * 64], op["n_pad"]))
                pos += op["n_pad"] * 64
            out.append((li, s, torch.cat(blocks, 1)))
    assert pos == wts.numel()
    return out


def _run_sm90_program(spec, kp, lo, hi, hvx):
    """The bf16 program, its slab image read through the swizzle, as the kernel runs it."""
    n = lo.shape[0]
    words, wts, fpar, _ = fused_mlp.pack_program(spec, kp, n)
    hdr, layers = _sm90_layers(words)
    _, n_rows, ns, in_lo, in_hi, lo_kb, hi_kb, act_kb, slot, stages, head_floats, *_ = hdr
    assert n_rows == n and ns == spec.ns
    cd = torch.bfloat16
    tiles = {fused_mlp._SRC_LO: torch.zeros((n, 64 * lo_kb), dtype=cd),
             fused_mlp._SRC_HI: torch.zeros((n, 64 * hi_kb), dtype=cd)}
    tiles[fused_mlp._SRC_LO][:, :in_lo] = lo
    if in_hi:
        tiles[fused_mlp._SRC_HI][:, :in_hi] = hi
    slabs = iter(_slabs(words, wts))
    hvxs = hvx if isinstance(hvx, (list, tuple)) else [hvx]
    planes = {}
    for li, op in enumerate(layers):
        assert op["n_pad"] in (64, 128, 256) and op["n_pad"] * 128 <= slot
        acc = 0
        for s in range(op["nseg"]):
            li2, s2, wt = next(slabs)
            assert (li2, s2) == (li, s)
            acc = acc + tiles[op["src"][s]][:, : wt.shape[1]].float() @ wt.float().T
        v = acc + fpar[op["b_off"] : op["b_off"] + op["n_pad"]]
        if op["flags"] & fused_mlp._FLAG_HVX:
            v[:, : op["n"]] += hvxs[op["hvx_slot"]].repeat_interleave(ns, 0)
        if op["flags"] & fused_mlp._FLAG_RELU:
            v = torch.relu(v)
        tiles[fused_mlp._SRC_ACT] = v.to(cd)  # the kernel overwrites its one activation tile
        assert op["n_pad"] <= 64 * act_kb
        if op["nout"]:
            assert op["head_w"] + op["nout"] * op["n_pad"] <= head_floats
            w = fpar[op["head_w"] : op["head_w"] + op["nout"] * op["n_pad"]].view(op["nout"], -1)
            for j in range(op["nout"]):
                planes[op["plane"] + j] = (v.to(cd).float() @ w[j]
                                           + fpar[op["head_b"] + j]).reshape(-1, ns)
    return tuple(planes[j] for j in range(len(planes)))


def _run_program(spec, kp, lo, hi, hvx):
    """Execute `pack_program`'s output with PyTorch ops, as the kernel does."""
    if spec.cdtype == torch.bfloat16:
        return _run_sm90_program(spec, kp, lo, hi, hvx)
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
    hvxs = hvx if isinstance(hvx, (list, tuple)) else [hvx]
    planes = {}
    for kind, width, b_off, flags, nseg, *rest in ops.tolist():
        src, w_off, kpad, plane, hvx_slot = rest[0:3], rest[3:6], rest[6:9], rest[9], rest[10]
        if kind == fused_mlp._OP_LAYER:
            acc = sum(
                tiles[src[s]].float()
                @ wts[w_off[s] : w_off[s] + width * kpad[s]].reshape(width, kpad[s]).float().T
                for s in range(nseg)
            )
            v = acc + fpar[b_off : b_off + width]
            if flags & fused_mlp._FLAG_HVX:
                v = v + hvxs[hvx_slot].repeat_interleave(hdr[2], 0)
            if flags & fused_mlp._FLAG_RELU:
                v = torch.relu(v)
            tiles[fused_mlp._SRC_ACT] = v.to(cd)  # the kernel overwrites its one activation tile
        else:
            w = fpar[w_off[0] : w_off[0] + width * kpad[0]].reshape(width, kpad[0])
            for j in range(width):
                planes[plane + j] = (tiles[src[0]].float() @ w[j] + fpar[b_off + j]).reshape(-1, hdr[2])
    return tuple(planes[j] for j in range(len(planes)))


PUBLISHED = dict(points_net_depth=8, points_net_width=256, views_net_width=128, skip_layers=(4,))


def _program_operands(name, dtype_name, nr=NR, ns=NS):
    """(spec, kp, lo, hi, hvx) of one case, or of the trio (kp a tuple, hvx a list)."""
    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    if name == "trio":
        ens, kps, lo, hvxs = _trio_operands(nr, ns, dtype)
        return ens, kps, lo, None, list(hvxs)
    cfg = mlp.MLPConfig(**{**SMALL, **CASES.get(name, PUBLISHED)})
    g = torch.Generator().manual_seed(1)
    params = mlp.init(g, cfg)
    pts = torch.randn((nr * ns, 3), generator=g)
    dirs = torch.nn.functional.normalize(torch.randn((nr, 3), generator=g), dim=-1)
    return mlp.fused_operands(params, cfg, pts, dirs, ns, dtype)


def _plain_planes(spec, kp, lo, hi, hvx):
    if isinstance(spec, fused_mlp.EnsembleSpec):
        return fused_mlp.fused_apply_ensemble(spec, kp, lo, hvx)
    return fused_mlp.fused_apply(spec, kp, lo, hi, hvx)  # CPU tensors: the plain version


PROGRAMS = sorted(CASES) + ["published", "trio"]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", PROGRAMS)
def test_packed_program_computes_plain_version(name, dtype_name):
    spec, kp, lo, hi, hvx = _program_operands(name, dtype_name)
    want = _plain_planes(spec, kp, lo, hi, hvx)
    got = _run_program(spec, kp, lo, hi, hvx)
    assert len(got) == len(want) == spec.n_planes
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", PROGRAMS)
def test_slab_image_unswizzles_to_padded_weights(name):
    """Every slab of the bf16 image, read back through the swizzle, is the
    zero-padded W^T of the parameter it was packed from."""
    spec, kp, lo, *_ = _program_operands(name, "bfloat16")
    kps = kp if isinstance(kp, tuple) else (kp,)
    words, wts, _, _ = fused_mlp.pack_program(spec, kp, lo.shape[0])
    plan = fused_mlp.sm90_plan(spec)
    slabs = _slabs(words, wts)
    assert len(slabs) == len(plan.w_src)
    for (li, s, wt), (mi, key) in zip(slabs, plan.w_src):
        w = kps[mi][key].detach().float()  # (K, N)
        k, n = w.shape
        want = torch.zeros_like(wt, dtype=torch.float32)
        want[:n, :k] = w.T.to(torch.bfloat16).float()
        assert wt.shape[0] in (64, 128, 256) and wt.shape[1] % 64 == 0, (li, s, key)
        assert wt.shape[0] >= n and wt.shape[1] >= k, (li, s, key)
        torch.testing.assert_close(wt.float(), want, atol=0, rtol=0, msg=f"{key} of member {mi}")


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", PROGRAMS)
def test_program_fits_shared_memory(name, dtype_name):
    spec, kp, lo, *_ = _program_operands(name, dtype_name)
    words, _, _, smem = fused_mlp.pack_program(spec, kp, lo.shape[0])
    assert words[0] <= fused_mlp._MAX_OPS
    assert smem <= fused_mlp._SMEM_LIMIT == 227 * 1024
    members = spec.members if isinstance(spec, fused_mlp.EnsembleSpec) else (spec,)
    if dtype_name == "bfloat16":  # the deepest ring, and hvx rows staged where a member has them
        hdr, _ = _sm90_layers(words)
        assert hdr[9] == 4 and (hdr[11] > 0) == any(m.has_hvx for m in members)


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

    if cd == torch.bfloat16:
        dw = _run_wgrad_jobs(stash, n, plan.tasks, plan.maps, plan.chunk_rows, plan.n_chunks,
                             plan.dw_total)
    else:
        dw = torch.zeros(plan.dw_total)
        for a_slot, a_w, g_slot, g_w, k_in, n_out, off, i0, j0 in plan.tasks.tolist():
            a = slot(a_slot, a_w).float()[:, i0 : min(i0 + 128, k_in)]
            gm = slot(g_slot, g_w).float()[:, j0 : min(j0 + 128, n_out)]
            view = dw[off : off + k_in * n_out].view(k_in, n_out)
            view[i0 : i0 + a.shape[1], j0 : j0 + gm.shape[1]] = a.T @ gm
    dhvx = g32[: plan.n_hvx].reshape(plan.n_hvx, n // ns, ns, g32.shape[-1]).sum(2)
    return fused_mlp.unpack_grads(plan, dw, parts.sum(0)), dhvx


def _run_wgrad_jobs(stash, n, jobs, maps, chunk_rows, n_chunks, dw_total):
    """The bf16 weight pass's jobs, as fused_mlp_bwd_wgrad_kernel runs them:
    each CTA's two consumers (their A box and G boxes), one partials row per
    chunk; then the chunks summed in order. Each dW element must be written
    by exactly one consumer per chunk."""
    box = fused_mlp._WBOX
    part = torch.zeros((n_chunks, dw_total))
    written = torch.zeros((n_chunks, dw_total), dtype=torch.int32)

    def boxes(m, c0, nb, rows):  # nb boxes of map m from column c0, zeros past the slot
        off, width = int(maps[m][0]), int(maps[m][1])
        view = stash[off : off + width * n].view(n, width)[rows].float()
        out = torch.zeros((view.shape[0], nb * box))
        cols = max(0, min(nb * box, width - c0))
        out[:, :cols] = view[:, c0 : c0 + cols]
        return out

    for chunk, a_map, i0, n_a, g_map, n_g, dw_off, k_in, n_out in jobs.tolist():
        rows = slice(chunk * chunk_rows, min(n, (chunk + 1) * chunk_rows))
        for c in range(2):
            ab, gb0, gn = c, 0, n_g
            if n_a == 1:
                h = (n_g + 1) // 2
                ab, gb0, gn = 0, (h if c else 0), (n_g - h if c else h)
            if gn == 0:
                continue
            val = boxes(a_map, i0 + ab * box, 1, rows).T @ boxes(g_map, gb0 * box, gn, rows)
            row0, col0 = i0 + ab * box, gb0 * box
            r, q = max(0, min(box, k_in - row0)), max(0, min(gn * box, n_out - col0))
            part[chunk, dw_off : dw_off + k_in * n_out].view(k_in, n_out)[
                row0 : row0 + r, col0 : col0 + q] = val[:r, :q]
            written[chunk, dw_off : dw_off + k_in * n_out].view(k_in, n_out)[
                row0 : row0 + r, col0 : col0 + q] += 1
    assert (written == 1).all(), "a dW element is written by no consumer or by two"
    dw = torch.zeros(dw_total)
    for chunk in range(n_chunks):
        dw += part[chunk]
    return dw


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


@pytest.mark.parametrize("table", ["EDITS", "TIMING_EDITS"])
def test_forward_probe_edits_match_the_kernel_sources(table):
    """Every edit of tools/probe_fused_mlp.py still finds its text in the
    kernel sources, so the probe builds each variant on the card."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "probe_fused_mlp.py"
    spec = importlib.util.spec_from_file_location("probe_fused_mlp", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    edits = getattr(probe, table)
    variants = probe.VARIANTS if table == "EDITS" else probe.TIMING
    for name, parts in variants.items():
        probe._edited_sources(parts, edits)  # raises on an edit that no longer matches


@pytest.mark.parametrize("table", ["EDITS", "TIMING_EDITS"])
def test_backward_probe_edits_match_the_kernel_sources(table, monkeypatch):
    """Every edit of tools/probe_fused_mlp_bwd.py still finds its text in the
    kernel sources, so the probe builds each variant on the card."""
    import importlib.util
    import sys
    from pathlib import Path

    tools = Path(__file__).resolve().parents[1] / "tools"
    monkeypatch.setattr(sys, "argv", ["probe_fused_mlp_bwd.py"])
    monkeypatch.syspath_prepend(str(tools))
    spec = importlib.util.spec_from_file_location("probe_fused_mlp_bwd", tools / "probe_fused_mlp_bwd.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    from probe_fused_mlp import _edited_sources

    edits = getattr(probe, table)
    variants = probe.VARIANTS if table == "EDITS" else {**probe.TIMING, **probe.WGRAD_TIMING}
    for name, parts in variants.items():
        if "(v3)" not in name:  # the "(v3)" parts split an earlier row pass (--parent)
            _edited_sources(parts, edits)  # raises on an edit that no longer matches


@pytest.mark.parametrize("n", [37, 1000, 4165])
def test_wgrad_plan_matches_jax_dw_product(n):
    """The bf16 weight pass's jobs (run as the kernel runs them) and the
    port's plain `wgrad` against the JAX backward kernel's dW product
    (`_mm_tn`: bf16 operands, float32 sums) on the same numpy inputs:
    a skip join's 256 x 256 and lo dWs sharing G, the views' 256 x 128, a
    48-wide and a 144-wide dW (one and three G boxes), rows fewer than one
    64-row stage, a ragged stage, several chunks."""
    import types

    widths = [64, 256, 256, 128, 48, 144]
    dws = [(1, 2, 256, 256), (0, 2, 63, 256), (0, 1, 63, 256), (2, 3, 256, 128),
           (4, 4, 48, 48), (5, 1, 144, 256)]
    rng = np.random.default_rng(n)
    slots = [rng.standard_normal((n, w)).astype(np.float32) for w in widths]
    tslots = [torch.from_numpy(x).to(torch.bfloat16) for x in slots]
    cols = np.cumsum([0] + widths).tolist()
    tasks, total = [], 0
    for a, g, k, m in dws:
        tasks.append([cols[a], widths[a], cols[g], widths[g], k, m, total])
        total += k * m
    plan = fused_mlp._wgrad_plan(tasks, n)
    stash = torch.cat([x.reshape(-1) for x in tslots])
    dw = _run_wgrad_jobs(stash, n, plan.jobs, plan.maps, plan.chunk_rows, plan.n_chunks, total)
    plain = fused_mlp.wgrad(tslots, dws)
    spec = types.SimpleNamespace(cdtype=jnp.bfloat16)
    for (a, g, k, m), (*_, off), got in zip(dws, tasks, plain):
        want = np.asarray(jfused._mm_tn(jnp.asarray(slots[a][:, :k]), jnp.asarray(slots[g][:, :m]),
                                        spec))
        scale = np.abs(want).max()
        jobs = dw[off : off + k * m].view(k, m).numpy()
        assert np.abs(jobs - want).max() <= 1e-5 * scale, f"dW ({k}, {m}) by the jobs"
        assert np.abs(got.numpy() - want).max() <= 1e-5 * scale, f"dW ({k}, {m}) plain"
