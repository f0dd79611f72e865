"""simplenerf_torch.ops.fused_mlp against the JAX package's fused MLP.

The JAX side runs its Pallas forward kernel in interpret mode on the CPU
(as tests/test_ops.py does); the port's `fused_apply` takes its plain
PyTorch version for CPU tensors. Inputs are numpy arrays from one seed;
parameters cross over with `convert.params_from_numpy`.

The host-side packing that feeds the CUDA kernel (`pack_program`) is
checked here too, by executing the packed program with PyTorch ops: the
kernel itself runs only on the card (tests/test_torch_port_cuda.py).
"""

import dataclasses
import re
from pathlib import Path

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


def _unswizzle_chunk(img):
    """The (64, 32) block of W^T held by one float32 chunk image: element
    (n, k) sits in row n's 16-byte group of four floats (k // 4) ^ (n % 8),
    its depth slot p holding K row _TF32_PERM[p % 8] of its 8-deep group,
    as the TF32 kernels' descriptors and register fragments read it."""
    rows = img.reshape(64, 8, 4)
    n = torch.arange(64)[:, None]
    phys = rows[n, torch.arange(8)[None, :] ^ (n % 8)].reshape(64, 32)
    logical = torch.empty_like(phys)
    perm = torch.as_tensor(fused_mlp._TF32_PERM)
    for g in range(4):
        logical[:, 8 * g + perm] = phys[:, 8 * g : 8 * g + 8]
    return logical


def _image_mats(n_pad, kb, wts, pos, f32):
    """One segment's weight from the image at `pos`: (n_pad, depth * kb)
    W^T, bf16 slabs or (float32) the (big, small) halves of its chunks read
    back from the split image; and the position after it."""
    if not f32:
        blocks = []
        for _ in range(kb):
            blocks.append(_unswizzle_slab(wts[pos : pos + n_pad * 64], n_pad))
            pos += n_pad * 64
        return torch.cat(blocks, 1), pos
    f = fused_mlp._TF32_CHUNK_FLOATS
    big = torch.zeros((n_pad, 32 * kb))
    small = torch.zeros((n_pad, 32 * kb))
    for k in range(kb):
        for ch in range(n_pad // 64):
            big[64 * ch : 64 * ch + 64, 32 * k : 32 * k + 32] = _unswizzle_chunk(wts[pos : pos + f])
            small[64 * ch : 64 * ch + 64, 32 * k : 32 * k + 32] = _unswizzle_chunk(wts[pos + f : pos + 2 * f])
            pos += 2 * f
    return (big, small), pos


def _product(a, w, f32):
    """a @ w^T as the kernel forms it: bf16 operands in float32 sums, or
    3xTF32 (w the (big, small) halves): small-big + big-small + big-big."""
    if not f32:
        return a.float() @ w.float().T
    big, small = fused_mlp.tf32_halves(a)
    return small @ w[0].T + big @ w[1].T + big @ w[0].T


def _sm90_layers(words):
    """The forward program's header and its layers as dicts (struct sm90::Op)."""
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


def _slabs(words, wts, f32=False):
    """Every segment's weight in stream order: [(layer, segment, W^T padded
    (n_pad, depth kb))], bf16 slabs or float32 (big, small) halves."""
    _, layers = _sm90_layers(words)
    out, pos = [], 0
    for li, op in enumerate(layers):
        for s in range(op["nseg"]):
            mat, pos = _image_mats(op["n_pad"], op["kb"][s], wts, pos, f32)
            out.append((li, s, mat))
    assert pos == wts.numel()
    return out


def _run_sm90_program(spec, kp, lo, hi, hvx):
    """The forward program, its weight image read through the swizzle (and,
    float32, the permuted K order and the split), as the kernel runs it."""
    n = lo.shape[0]
    words, wts, fpar, _ = fused_mlp.pack_program(spec, kp, n)
    hdr, layers = _sm90_layers(words)
    _, n_rows, ns, in_lo, in_hi, lo_kb, hi_kb, act_kb, slot, stages, head_floats, *_ = hdr
    assert n_rows == n and ns == spec.ns
    cd = spec.cdtype
    f32 = cd == torch.float32
    depth = 32 if f32 else 64
    tiles = {fused_mlp._SRC_LO: torch.zeros((n, depth * lo_kb), dtype=cd),
             fused_mlp._SRC_HI: torch.zeros((n, depth * hi_kb), dtype=cd)}
    tiles[fused_mlp._SRC_LO][:, :in_lo] = lo
    if in_hi:
        tiles[fused_mlp._SRC_HI][:, :in_hi] = hi
    slabs = iter(_slabs(words, wts, f32))
    hvxs = hvx if isinstance(hvx, (list, tuple)) else [hvx]
    planes = {}
    for li, op in enumerate(layers):
        assert op["n_pad"] in (64, 128, 256) and (16384 if f32 else op["n_pad"] * 128) <= slot
        acc = 0
        for s in range(op["nseg"]):
            li2, s2, wt = next(slabs)
            assert (li2, s2) == (li, s)
            k = (wt[0] if f32 else wt).shape[1]
            acc = acc + _product(tiles[op["src"][s]][:, :k], wt, f32)
        v = acc + fpar[op["b_off"] : op["b_off"] + op["n_pad"]]
        if op["flags"] & fused_mlp._FLAG_HVX:
            v[:, : op["n"]] += hvxs[op["hvx_slot"]].repeat_interleave(ns, 0)
        if op["flags"] & fused_mlp._FLAG_RELU:
            v = torch.relu(v)
        tiles[fused_mlp._SRC_ACT] = v.to(cd)  # the kernel overwrites its one activation tile
        assert op["n_pad"] <= depth * act_kb
        if op["nout"]:
            assert op["head_w"] + op["nout"] * op["n_pad"] <= head_floats
            w = fpar[op["head_w"] : op["head_w"] + op["nout"] * op["n_pad"]].view(op["nout"], -1)
            for j in range(op["nout"]):
                planes[op["plane"] + j] = (v.to(cd).float() @ w[j]
                                           + fpar[op["head_b"] + j]).reshape(-1, ns)
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
    got = _run_sm90_program(spec, kp, lo, hi, hvx)
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
    # the deepest ring that fits (float32 at the published widths: three
    # 16 KB slots beside 2 x 80 KB of tiles), and hvx rows staged where a
    # member has them
    hdr, _ = _sm90_layers(words)
    wide = name == "published" and dtype_name == "float32"
    assert hdr[9] == (3 if wide else 4) and (hdr[11] > 0) == any(m.has_hvx for m in members)


def test_published_flop_count():
    spec = fused_mlp.make_spec(mlp.MLPConfig(), 192, torch.bfloat16)
    assert spec.flops_per_point() == 2 * 589_952


def test_wrapper_rejects_other_devices():
    cfg = mlp.MLPConfig(**SMALL)
    spec = fused_mlp.make_spec(cfg, NS, torch.float32)
    lo = torch.zeros((NR * NS, spec.in_lo), device="meta")
    with pytest.raises(ValueError):
        fused_mlp.fused_apply(spec, {}, lo, None, None)


def _bwd90_ops(words):
    """The bf16 row program's header and ops as dicts (struct bwd90::Op)."""
    hw, ow = fused_mlp._BWD90_HEADER_WORDS, fused_mlp._BWD90_OP_WORDS
    sizes = {"src": fused_mlp._BWD90_MAX_SEG, "kb": fused_mlp._BWD90_MAX_SEG}
    ops = []
    for words_ in words[hw:].reshape(-1, ow).tolist():
        op, pos = {}, 0
        for name in fused_mlp._BWD90_OP:
            k = sizes.get(name, 1)
            op[name] = words_[pos : pos + k] if name in sizes else words_[pos]
            pos += k
        ops.append(op)
    assert words[0] == len(ops)
    return words[:hw].tolist(), ops


def _bwd90_slabs(plan, f32=False):
    """Each op's segments as (n_pad, depth kb) matrices read back through
    the swizzle from the weight image (float32: the (big, small) halves of
    the split chunk image), in the producer's order."""
    _, ops = _bwd90_ops(plan.rows90.words)
    pos, mats = 0, []
    for op in ops:
        segs = []
        for s in range(op["nseg"]):
            mat, pos = _image_mats(op["n_pad"], op["kb"][s], plan.wts, pos, f32)
            segs.append(mat)
        mats.append(segs)
    assert pos == plan.wts.numel()
    return mats


def _run_bwd90_rows(plan, n, lo, hi, hvxs, dp):
    """The row pass's program, run as fused_mlp_bwd_rows_sm90_kernel (bf16)
    or fused_mlp_bwd_rows_tf32_kernel (float32, products in 3xTF32) runs
    it, tile by tile: (stash, g32, per-tile partials). An op with no tensor
    map stores no stash: its slot stays zero."""
    hdr, ops = _bwd90_ops(plan.rows90.words)
    ns, in_lo, in_hi, lo_kb, hi_kb, act_kb = hdr[2:8]
    slot_bytes, part_w, n_maps = hdr[8], hdr[12], hdr[14]
    assert part_w == plan.part_w and n_maps == len(plan.rows90.maps)
    cd, bm = plan.wts.dtype, 128
    f32 = cd == torch.float32
    depth = 32 if f32 else 64
    mats = _bwd90_slabs(plan, f32)
    stash = torch.zeros(plan.stash_cols * n, dtype=cd)
    g32 = torch.zeros((max(plan.n_hvx, 1), n, max(plan.hvx_w, 1)))
    n_tiles = -(-n // bm)
    parts = torch.zeros((n_tiles, part_w))
    fpar = plan.fpar

    def slot(off, w):
        return stash[off * n : (off + w) * n].view(n, w)

    def store(op, rows, v):
        if op["map"] >= 0:
            assert plan.rows90.maps[op["map"]] == (op["out_slot"], op["n"])
            slot(op["out_slot"], op["n"])[rows] = v[:, : op["n"]]

    for t in range(n_tiles):
        rows = slice(t * bm, min(n, (t + 1) * bm))
        r = rows.stop - rows.start
        tiles = {fused_mlp._SRC_LO: torch.zeros((r, depth * lo_kb), dtype=cd),
                 fused_mlp._SRC_HI: torch.zeros((r, depth * hi_kb), dtype=cd)}
        tiles[fused_mlp._SRC_LO][:, :in_lo] = lo[rows]
        if in_hi:
            tiles[fused_mlp._SRC_HI][:, :in_hi] = hi[rows]
        masks = {}
        for op, segs in zip(ops, mats):
            kind, width, n_pad, flags = op["kind"], op["n"], op["n_pad"], op["flags"]
            if kind == fused_mlp._F_IN:
                store(op, rows, tiles[op["src"][0]])
                continue
            assert n_pad in (64, 128, 256) and n_pad <= depth * act_kb
            assert (16384 if f32 else n_pad * 128) <= slot_bytes
            acc = torch.zeros((r, n_pad))
            for s, w in enumerate(segs):
                k = (w[0] if f32 else w).shape[1]
                acc = acc + _product(tiles[op["src"][s]][:, :k], w, f32)
            d = dp[op["plane"] : op["plane"] + op["head_nout"], rows]
            if kind == fused_mlp._F_LAYER:
                v = acc + fpar[op["b_off"] : op["b_off"] + n_pad]
                if flags & fused_mlp._FLAG_HVX:
                    v[:, :width] += hvxs[op["hvx_slot"]].repeat_interleave(ns, 0)[rows]
                if flags & fused_mlp._FLAG_RELU:
                    v = torch.relu(v)
                    masks[op["mask_slot"]] = v.to(cd).float() > 0
                tiles[fused_mlp._SRC_ACT] = v.to(cd)
                store(op, rows, v.to(cd))
                if op["head_nout"]:  # the head this layer feeds: partials of its rounded activation
                    hn = op["head_nout"]
                    parts[t, op["part"] : op["part"] + hn * width] = (
                        d @ v.to(cd).float()[:, :width]).reshape(-1)
                    parts[t, op["part2"] : op["part2"] + hn] = d.sum(1)
                continue
            assert op["nseg"] <= 1
            if op["head_nout"]:
                hw = fpar[op["head_w"] : op["head_w"] + op["head_nout"] * n_pad].view(op["head_nout"], n_pad)
                acc = acc + d.T @ hw
            if flags & fused_mlp._FLAG_RELU:
                acc = acc * masks[op["mask_slot"]][:, :n_pad]
            if op["g32_slot"] >= 0:
                g32[op["g32_slot"], rows] = acc[:, :width]
            tiles[fused_mlp._SRC_ACT] = acc.to(cd)
            store(op, rows, acc.to(cd))
            parts[t, op["part"] : op["part"] + width] = acc[:, :width].sum(0)
    return stash, g32, parts


def _run_bwd_program(spec, kp, lo, hi, hvxs, d_planes):
    """Execute `pack_bwd_program`'s output with PyTorch ops, tile by tile and
    task by task, as the backward kernels do: (per-member dkp, dhvx stack).
    The row pass runs the program of `bwd90_plan` (`_run_bwd90_rows`)."""
    n = lo.shape[0]
    plan = fused_mlp.pack_bwd_program(spec, kp, n)
    ns = int(plan.header[2])
    members = spec.members if isinstance(spec, fused_mlp.EnsembleSpec) else (spec,)
    bf16 = members[0].cdtype == torch.bfloat16
    dp = d_planes.reshape(d_planes.shape[0], n)
    stash, g32, parts = _run_bwd90_rows(plan, n, lo, hi, hvxs, dp)

    def slot(off, w):
        return stash[off * n : (off + w) * n].view(n, w)

    if bf16:
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
    nr, ns = 1037, 64  # 66,368 rows: a ragged last 128-row tile
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
    assert n % bm > 0
    n_masks = int(dict(zip(fused_mlp._BHEADER, plan.header))["n_masks"])
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
    # a uint4 for each of a tile's 256 consumer threads (the wgmma fragment
    # of 128 values), in both types
    threads, words = 256, 4
    last = ((-(-n // bm) - 1) * n_masks + n_masks - 1) * threads + threads - 1
    assert words * (last + 1) == plan.mask_words


BWD90_CASES = {"main": {}, "published": PUBLISHED, "trunk48": dict(points_net_width=48),
               "trunk160": dict(points_net_width=160), "views80": dict(views_net_width=80),
               "trio": None}


def _bwd90_operands(name, nr=NR, ns=NS):
    """(spec, kp, lo, hi, hvx list, d_planes) in bf16 for one BWD90_CASES entry."""
    if name == "trio":
        spec, kp, lo, hi, hvx = _program_operands("trio", "bfloat16", nr, ns)
    else:
        cfg = mlp.MLPConfig(**{**SMALL, **BWD90_CASES[name]})
        g = torch.Generator().manual_seed(4)
        params = mlp.init(g, cfg)
        pts = torch.randn((nr * ns, 3), generator=g)
        dirs = torch.nn.functional.normalize(torch.randn((nr, 3), generator=g), dim=-1)
        spec, kp, lo, hi, hvx = mlp.fused_operands(params, cfg, pts, dirs, ns, torch.bfloat16)
        hvx = [hvx] if hvx is not None else []
    g = torch.Generator().manual_seed(5)
    return spec, kp, lo, hi, hvx, torch.randn((spec.n_planes, nr, ns), generator=g)


def _f32_twin(spec):
    if isinstance(spec, fused_mlp.EnsembleSpec):
        return fused_mlp.EnsembleSpec(members=tuple(_f32_twin(m) for m in spec.members))
    return dataclasses.replace(spec, dtype="float32")


def _padded_op_weights(plan, kp, depth):
    """Each row-pass op's segments' weights, zero-padded to (n_pad, depth
    kb), from the parameters: a forward op's W^T, a backward op's W (the
    product of the BOp before it), as `_bwd_plan` lays the ops' buffer out
    (each matrix's rows padded to 16 columns, one after the other)."""
    kps = list(kp) if isinstance(kp, tuple) else [kp]
    srcs, mats, w_len = iter(plan.w_src), [], 0
    for w in plan.ops.tolist():  # the ops' buffer: each op's segments in order
        segs = []
        for s_ in range(w[4]):
            mi, key = next(srcs)
            m = kps[mi][key].detach().float()
            m = m.T if w[0] == fused_mlp._F_LAYER else m
            assert (w[8 + s_], w[11 + s_]) == (w_len, -(-m.shape[1] // 16) * 16)
            w_len += m.shape[0] * w[11 + s_]
            segs.append(m)
        mats.append(segs)
    assert next(srcs, None) is None
    _, ops = _bwd90_ops(plan.rows90.words)
    out = []
    for i, op in enumerate(ops):
        src = mats[i] if op["kind"] == fused_mlp._F_LAYER else mats[i - 1]  # B: the op before's W
        segs = []
        for s_ in range(op["nseg"]):
            want = torch.zeros((op["n_pad"], depth * op["kb"][s_]))
            want[: src[s_].shape[0], : src[s_].shape[1]] = src[s_]
            segs.append(want)
        out.append(segs)
    return out


@pytest.mark.parametrize("name", sorted(BWD90_CASES))
def test_bwd90_slab_image_unswizzles_to_padded_weights(name):
    """Every slab of the bf16 row pass's image, read back through the
    swizzle, is its op's weight zero-padded to (n_pad, 64 kb): a forward
    op's W^T, a backward op's W (the product of the op before it), at the
    offsets the ops' buffer gives them; the float32 program has the same
    ops."""
    spec, kp, lo, *_ = _bwd90_operands(name)
    n = lo.shape[0]
    plan = fused_mlp.pack_bwd_program(spec, kp, n)
    twin = fused_mlp.pack_bwd_program(_f32_twin(spec), kp, n)  # same ops, float32 weights
    assert np.array_equal(plan.ops, twin.ops)
    for i, (segs, wants) in enumerate(zip(_bwd90_slabs(plan), _padded_op_weights(plan, kp, 64))):
        assert len(segs) == len(wants)
        for s, (got, want) in enumerate(zip(segs, wants)):
            assert got.shape == want.shape, (i, s)
            torch.testing.assert_close(got.float(), want.to(torch.bfloat16).float(), atol=0, rtol=0,
                                       msg=f"op {i} segment {s}")


@pytest.mark.parametrize("name", sorted(BWD90_CASES))
def test_bwd90_maps_are_the_slots_the_weight_pass_reads(name):
    """The bf16 row pass stores a stash slot (has a tensor map for it) iff
    the weight pass reads it, each such slot once; the slots it skips are
    the activations that feed only a head, whose dW the row pass forms."""
    spec, kp, lo, *_ = _bwd90_operands(name)
    plan = fused_mlp.pack_bwd_program(spec, kp, lo.shape[0])
    _, ops = _bwd90_ops(plan.rows90.words)
    read = {s_: w for a, aw, g_, gw, *_ in plan.dws for s_, w in ((a, aw), (g_, gw))}
    mapped = [(op["out_slot"], op["n"]) for op in ops if op["map"] >= 0]
    assert [ops[i]["map"] for i in range(len(ops)) if ops[i]["map"] >= 0] == list(range(len(mapped)))
    assert list(plan.rows90.maps) == mapped and dict(mapped) == read
    skipped = [op for op in ops if op["map"] < 0]
    assert skipped and all(op["kind"] == fused_mlp._F_LAYER and op["head_nout"] for op in skipped)


def _np_tf32(x):
    """cvt.rna.tf32.f32 in numpy, on the uint32 view: round the magnitude's
    13 low bits to the nearest, ties away from zero, then clear them."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("name", sorted(BWD90_CASES))
def test_f32_bwd_buffer_holds_each_ops_padded_weight(name):
    """The float32 row pass's weight image, gathered from the parameters
    and split, holds each op's padded weight (a forward op's W^T, a
    backward op's W) in its chunks: read back through the swizzle and the
    permuted K order, the big half is tf32(W) and the small half
    tf32(W - big), bit for bit, and big + small is W to 2^-22 of |W|."""
    spec, kp, lo, *_ = _bwd90_operands(name)
    spec = _f32_twin(spec)
    plan = fused_mlp.pack_bwd_program(spec, kp, lo.shape[0])
    assert plan.wts.dtype == torch.float32
    for i, (segs, wants) in enumerate(zip(_bwd90_slabs(plan, f32=True),
                                          _padded_op_weights(plan, kp, 32))):
        assert len(segs) == len(wants)
        for s, ((big, small), want) in enumerate(zip(segs, wants)):
            w = want.numpy()
            b = _np_tf32(w)
            np.testing.assert_array_equal(big.numpy(), b, err_msg=f"op {i} segment {s} big")
            np.testing.assert_array_equal(small.numpy(), _np_tf32(w - b), err_msg=f"op {i} {s} small")
            assert np.all(np.abs((big + small).numpy() - w) <= 2.0**-22 * np.abs(w)), (i, s)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_bwd_plan_cached_per_spec_but_buffers_follow_the_weights(dtype_name):
    """pack_bwd_program reuses the plan of a spec and row count, but gathers
    its buffers from the parameters of each call: new weights give the
    program of new weights, which runs to their plain backward."""
    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    spec, kp, lo, hi, hvx, d_planes = _bwd90_operands("main")
    if dtype == torch.float32:
        spec, lo, hi = _f32_twin(spec), lo.float(), hi.float() if hi is not None else None
    a = fused_mlp.pack_bwd_program(spec, kp, lo.shape[0])
    g = torch.Generator().manual_seed(9)
    kp2 = {k: v + 0.1 * torch.randn(v.shape, generator=g) for k, v in kp.items()}
    b = fused_mlp.pack_bwd_program(spec, kp2, lo.shape[0])
    assert a.header is b.header and a.rows90 is b.rows90 and a.dev_tasks is b.dev_tasks
    assert not torch.equal(a.wts, b.wts) and not torch.equal(a.fpar, b.fpar)
    want, want_hvx = fused_mlp.fused_bwd_reference(spec, kp2, lo, hi, hvx[0] if hvx else None,
                                                   d_planes)
    (got,), got_hvx = _run_bwd_program(spec, kp2, lo, hi, hvx, d_planes)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    _assert_grads_close(got, want, tol)
    if hvx:
        _assert_grads_close({"h": got_hvx[0]}, {"h": want_hvx}, tol)


def _cuh_ints(text: str, names: dict) -> dict:
    """The `constexpr int` / `bool` constants of a header, evaluated in order."""
    vals = dict(names)
    for decl in re.findall(r"constexpr (?:int|bool) ([^;]+);", text):
        for item in re.split(r",\s*(?=k\w+ =)", decl):
            name, expr = item.split(" = ", 1)
            vals[name.strip()] = eval(expr.replace("true", "True").replace("false", "False"), {},
                                      vals)
    return vals


def _cuh_fields(text: str, struct: str, vals: dict) -> list:
    """The int fields of a struct, arrays expanded: [(name, count), ...]."""
    body = re.search(r"struct " + struct + r" \{(.*?)\};", text, re.S).group(1)
    fields = []
    for decl in re.findall(r"int ([^;]+);", body):
        for item in decl.split(","):
            m = re.fullmatch(r"\s*(\w+)(?:\[(\w+)\])?\s*", item)
            fields.append((m[1], eval(m[2], {}, vals) if m[2] else 1))
    return fields


def test_bwd90_header_constants_match_the_cuh():
    """The row program's layout and shared-memory constants in
    ops/fused_mlp.py are csrc/fused_mlp_bwd_sm90.cuh's."""
    csrc = Path(fused_mlp.__file__).resolve().parent / "csrc"
    base = _cuh_ints((csrc / "fused_mlp_sm90.cuh").read_text(), {})
    text = (csrc / "fused_mlp_bwd_sm90.cuh").read_text()
    k = _cuh_ints(text, {"kRows": base["kRows"], "kBM": base["kBM"],
                         "kBlockBytes": base["kBlockBytes"]})
    assert k["kMaxOps"] == fused_mlp._BWD90_MAX_OPS and k["kMaxSeg"] == fused_mlp._BWD90_MAX_SEG
    assert k["kHeaderWords"] == fused_mlp._BWD90_HEADER_WORDS
    assert k["kOpWords"] == fused_mlp._BWD90_OP_WORDS
    assert k["kMaxStages"] == max(fused_mlp._BWD90_STAGES) and k["kMaxHead"] == fused_mlp._MAX_HEAD
    assert k["kBiasFloats"] == fused_mlp._SM90_BIAS and k["kBlockBytes"] == fused_mlp._SM90_KBLOCK
    assert (k["kDpFloats"], k["kRedFloats"], k["kXferFloats"]) == (
        fused_mlp._BWD90_DP, fused_mlp._BWD90_RED, fused_mlp._BWD90_XFER)
    assert k["kBarriers"] * 8 == fused_mlp._BWD90_BARRIERS
    assert k["kMaskThreads"] == fused_mlp._BWD90_MASK_THREADS
    op = _cuh_fields(text, "Op", k)
    assert [name for name, _ in op] == list(fused_mlp._BWD90_OP)
    assert sum(c for _, c in op) == fused_mlp._BWD90_OP_WORDS
    header = _cuh_fields(text, "Program", k)
    assert [name for name, _ in header] == list(fused_mlp._BWD90_HEADER)
    enums = dict(re.findall(r"(\w+) = (\d+)", re.search(r"enum \{ F_IN[^}]*\}", text).group(0)))
    assert (int(enums["F_IN"]), int(enums["F_LAYER"]), int(enums["B_LAYER"])) == (
        fused_mlp._F_IN, fused_mlp._F_LAYER, fused_mlp._B_LAYER)


@pytest.mark.parametrize("trio", [None, ("main", "points_aug", "lambertian"),
                                  ("visibility", "points_aug", "lambertian")],
                         ids=["fine", "trio", "visibility_trio"])
def test_bwd90_plan_fits_shared_memory(trio):
    """The published fine MLP, the coarse trio and the trio with the
    4-channel visibility head: the row pass's regions sum to its plan's
    bytes, inside a Hopper block's 227 KB, with a ring of 4 slabs of
    32 KB and the hvx rows staged."""
    nr, ns = 5, 64
    if trio is None:
        spec, kp, lo, *_ = _program_operands("published", "bfloat16", nr, ns)
    else:
        g = torch.Generator().manual_seed(1)
        members = []
        for name in trio:
            cfg = mlp.MLPConfig(**{**SMALL, **PUBLISHED, **CASES[name]})
            members.append((mlp.init(g, cfg), cfg))
        pts = torch.randn((nr * ns, 3), generator=g)
        dirs = torch.nn.functional.normalize(torch.randn((nr, 3), generator=g), dim=-1)
        spec, kp, lo, _ = mlp.ensemble_operands(members, pts, dirs, ns, torch.bfloat16)
    plan = fused_mlp.pack_bwd_program(spec, kp, lo.shape[0])
    hdr, ops = _bwd90_ops(plan.rows90.words)
    h = dict(zip(fused_mlp._BWD90_HEADER, hdr))
    assert h["stages"] == 4 and h["slot_bytes"] == 256 * 128 and h["hvx_rays"] > 0
    regions = (h["stages"] * h["slot_bytes"]
               + 2 * (h["act_kb"] + h["lo_kb"] + h["hi_kb"]) * fused_mlp._SM90_KBLOCK
               + 2 * 4 * (h["cst_floats"] + fused_mlp._BWD90_DP)
               + 4 * (fused_mlp._BWD90_RED + fused_mlp._BWD90_XFER) + fused_mlp._BWD90_BARRIERS)
    assert plan.smem == regions <= fused_mlp._SMEM_LIMIT
    read = {s for a, _, g_, *_ in plan.dws for s in (a, g_)}
    assert len(ops) <= fused_mlp._BWD90_MAX_OPS and h["n_maps"] == len(read) < len(ops)
    heads = [op["head_nout"] for op in ops if op["kind"] == fused_mlp._B_LAYER and op["head_nout"]]
    # 4 channels: the Lambertian member's points head (sigma and rgb), the
    # visibility member's views head (rgb and visibility)
    assert max(heads) == (3 if trio is None else 4)
    if trio and trio[0] == "visibility":
        assert heads.count(4) == 2


@pytest.mark.parametrize("name", ["trunk48", "trunk160", "views80"])
def test_packed_bwd90_program_pads_widths(name):
    """The bf16 row program at widths its wgmma pads (48 -> 64, 160 -> 256,
    views 80 -> 128), run as the kernel runs it, against the plain backward."""
    spec, kp, lo, hi, hvx, d_planes = _bwd90_operands(name, nr=37, ns=7)
    want, want_hvx = fused_mlp.fused_bwd_reference(spec, kp, lo, hi, hvx[0] if hvx else None,
                                                   d_planes)
    (got,), got_hvx = _run_bwd_program(spec, kp, lo, hi, hvx, d_planes)
    _assert_grads_close(got, want, 2e-2)
    if hvx:
        _assert_grads_close({"h": got_hvx[0]}, {"h": want_hvx}, 2e-2)


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
