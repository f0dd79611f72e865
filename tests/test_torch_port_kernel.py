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


# The m64n256 float32 accumulator of each of a tile's 256 consumer threads
# (128 c + 32 warp + lane: consumer c's rows 64 c ..), element d[4j + e]:
# its row and column in the 128-row tile, and where its ReLU mask bit goes
# (word j // 8, bit 4 (j % 8) + e), as both float32 kernels pack the words.
_T = np.arange(256)[:, None]
_I = np.arange(128)[None, :]
_MASK_ROW = 64 * (_T // 128) + 16 * (_T % 128 // 32) + _T % 32 // 4 + 8 * (_I // 2 % 2)
_MASK_COL = 8 * (_I // 4) + 2 * (_T % 4) + _I % 2
_MASK_WORD = np.broadcast_to(_I // 4 // 8, _MASK_ROW.shape)
_MASK_BIT = np.broadcast_to(4 * (_I // 4 % 8) + _I % 4, _MASK_ROW.shape).astype(np.uint64)


def _mask_words(on):
    """One ReLU layer's mask words of a tile: `on` (rows, n_pad) booleans ->
    (256, 4) int32, each thread's bit set where its element is on; rows past
    the tile's and columns past n_pad give 0."""
    full = np.zeros((128, 256), bool)
    full[: on.shape[0], : on.shape[1]] = on
    words = np.zeros((256, 4), np.uint64)
    np.add.at(words, (np.broadcast_to(_T, _MASK_ROW.shape), _MASK_WORD),
              full[_MASK_ROW, _MASK_COL].astype(np.uint64) << _MASK_BIT)
    return torch.from_numpy(words.astype(np.uint32).view(np.int32))


def _mask_of(words, rows, n_pad):
    """The booleans a tile's mask words (256, 4) hold, (rows, n_pad)."""
    w = words.numpy().view(np.uint32).astype(np.uint64)
    full = np.zeros((128, 256), bool)
    full[_MASK_ROW, _MASK_COL] = (w[_T, _MASK_WORD] >> _MASK_BIT) & 1 == 1
    return torch.from_numpy(full[:rows, :n_pad])


def test_mask_words_hold_each_element_once():
    """Every (row, column) of a 128 x 256 tile is one thread's one bit, so
    the words round-trip any mask."""
    assert sorted(zip(_MASK_ROW.ravel(), _MASK_COL.ravel())) == [(r, c) for r in range(128)
                                                                  for c in range(256)]
    assert len({(t, w, b) for t, w, b in zip(np.broadcast_to(_T, _MASK_ROW.shape).ravel(),
                                              _MASK_WORD.ravel(), _MASK_BIT.ravel())}) == 128 * 256
    g = torch.Generator().manual_seed(0)
    on = torch.rand((101, 192), generator=g) > 0.5
    assert torch.equal(_mask_of(_mask_words(on.numpy()), 101, 192), on)


def _stash_words(plan):
    """The training forward's layout (struct tf32::Stash): (lo slot, lo
    width, hi slot, hi width, n_masks, each layer's slot, its mask slot)."""
    w = plan.fwd_words.tolist()
    k = fused_mlp._MAX_OPS
    return (*w[:5], w[6 : 6 + k], w[6 + k : 6 + 2 * k])


def _run_sm90_program(spec, kp, lo, hi, hvx, plan=None):
    """The forward program, its weight image read through the swizzle (and,
    float32, the permuted K order and the split), as the kernel runs it.
    With `plan` (the float32 backward's), the planes and what the training
    forward stores: (planes, (acts, masks)), the activation stash and the
    mask words (n_tiles, n_masks, 256, 4)."""
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
    if plan is not None:
        lo_slot, lo_n, hi_slot, hi_n, n_masks, slots, mask_slots = _stash_words(plan)
        ld, n_tiles = plan.stash_ld, -(-n // 128)
        acts = torch.zeros(plan.act_cols * ld)
        masks = torch.zeros((n_tiles, n_masks, 256, 4), dtype=torch.int32)

        def put(slot, v):
            acts[slot * ld : slot * ld + n * v.shape[1]].view(n, -1)[:] = v

        put(lo_slot, tiles[fused_mlp._SRC_LO][:, :lo_n])
        if hi_slot >= 0:
            put(hi_slot, tiles[fused_mlp._SRC_HI][:, :hi_n])
    # float32: an activation tile of act_kb K blocks; bf16: none, the last
    # layer's n_pad columns in registers (a fragment per k16 step).
    assert (act_kb > 0) == f32
    held = depth * act_kb
    for li, op in enumerate(layers):
        assert op["n_pad"] in (64, 128, 256) and (16384 if f32 else op["n_pad"] * 128) <= slot
        assert sum(op["kb"]) <= stages or f32  # the bf16 consumers' turns on a layer's slabs
        acc = 0
        for s in range(op["nseg"]):
            li2, s2, wt = next(slabs)
            assert (li2, s2) == (li, s)
            k = (wt[0] if f32 else wt).shape[1]
            assert op["src"][s] != fused_mlp._SRC_ACT or k <= held
            acc = acc + _product(tiles[op["src"][s]][:, :k], wt, f32)
        v = acc + fpar[op["b_off"] : op["b_off"] + op["n_pad"]]
        if op["flags"] & fused_mlp._FLAG_HVX:
            v[:, : op["n"]] += hvxs[op["hvx_slot"]].repeat_interleave(ns, 0)
        if op["flags"] & fused_mlp._FLAG_RELU:
            v = torch.relu(v)
        if plan is not None:
            if slots[li] >= 0:
                put(slots[li], v[:, : op["n"]])
            if op["flags"] & fused_mlp._FLAG_RELU:
                for t in range(n_tiles):
                    masks[t, mask_slots[li]] = _mask_words(v[128 * t : 128 * t + 128].numpy() > 0)
        tiles[fused_mlp._SRC_ACT] = v.to(cd)  # the kernel replaces the last layer's activations
        assert op["n_pad"] <= (depth * act_kb if f32 else 256)
        held = depth * act_kb if f32 else op["n_pad"]
        if op["nout"]:
            assert op["head_w"] + op["nout"] * op["n_pad"] <= head_floats
            w = fpar[op["head_w"] : op["head_w"] + op["nout"] * op["n_pad"]].view(op["nout"], -1)
            for j in range(op["nout"]):
                planes[op["plane"] + j] = (v.to(cd).float() @ w[j]
                                           + fpar[op["head_b"] + j]).reshape(-1, ns)
    planes = tuple(planes[j] for j in range(len(planes)))
    return planes if plan is None else (planes, (acts, masks))


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
    # 16 KB slots beside 2 x 80 KB of tiles; bf16, with no activation tiles:
    # six), and hvx rows staged where a member has them
    hdr, _ = _sm90_layers(words)
    wide = name == "published" and dtype_name == "float32"
    want = (3 if wide else 4) if dtype_name == "float32" else 6
    assert hdr[9] == want and (hdr[11] > 0) == any(m.has_hvx for m in members)


# The bf16 forward keeps each consumer's activations in registers as the
# next layer's wgmma A operand (csrc/fused_mlp_sm90.cuh `epilogue`, `layer`).
# A mirror of the two register layouts of a warpgroup's 64 rows, from the
# PTX ISA's wgmma fragments: the m64nN float32 accumulator d, and the
# m64k16 bf16 A fragment of four registers of two values each.
def _acc_element(warp, lane, i):
    """(row, column) of accumulator register d[i] of (warp, lane): n8 tile
    i // 4, rows 16 warp + lane // 4 (+ 8 for i % 4 >= 2), columns
    2 (lane % 4) (+ 1 for odd i)."""
    return 16 * warp + lane // 4 + 8 * (i // 2 % 2), 8 * (i // 4) + 2 * (lane % 4) + i % 2


def _a_element(warp, lane, kk, r, half):
    """(row, column) of value `half` (0: low 16 bits) of A register r of
    k16 step kk: r 0 / 1 rows 16 warp + lane // 4 / + 8, columns 2 (lane %
    4) + half; r 2 / 3 the same 8 columns on."""
    return 16 * warp + lane // 4 + 8 * (r % 2), 16 * kk + 2 * (lane % 4) + 8 * (r // 2) + half


@pytest.mark.parametrize("n", [64, 128, 256])
def test_accumulators_round_into_the_next_layers_a_fragments(n):
    """The epilogue rounds d[2m], d[2m + 1] into the bf16 pair a[m], and k16
    step kk of the next layer reads a[4kk .. 4kk + 3]: those registers
    hold exactly A's columns 16kk .. 16kk + 15, and over all steps, warps
    and lanes they rebuild the 64 x n tile, each element once."""
    tile = torch.arange(64 * n).reshape(64, n)
    got = torch.full((64, n), -1)
    for warp in range(4):
        for lane in range(32):
            d = [tile[_acc_element(warp, lane, i)] for i in range(n // 2)]
            a = [(d[2 * m], d[2 * m + 1]) for m in range(n // 4)]  # (low, high) of each pair
            for kk in range(n // 16):
                for r in range(4):
                    for half in range(2):
                        row, col = _a_element(warp, lane, kk, r, half)
                        assert a[4 * kk + r][half] == tile[row, col], (warp, lane, kk, r, half)
                        assert got[row, col] == -1, (row, col)
                        got[row, col] = a[4 * kk + r][half]
    assert torch.equal(got, tile)


def _published_bf16_programs():
    """The bf16 forward programs of the main path: the fine and coarse main
    MLP at the render's and the training step's samples (the plan does not
    depend on the rows), the coarse trio, and ViP-NeRF's MLP (visibility
    head) at both levels."""
    pub, vip = mlp.MLPConfig(), mlp.MLPConfig(predict_visibility=True)
    trio = [mlp.MLPConfig(**kw) for kw in
            ({}, {"points_sigma_pe_degree": 3}, {"use_view_dirs": False, "view_dependent_rgb": False})]
    bf = torch.bfloat16
    return {"fine 192": fused_mlp.make_spec(pub, 192, bf), "coarse 64": fused_mlp.make_spec(pub, 64, bf),
            "trio 64": fused_mlp.make_ensemble_spec(trio, 64, bf),
            "vipnerf fine 192": fused_mlp.make_spec(vip, 192, bf),
            "vipnerf coarse 64": fused_mlp.make_spec(vip, 64, bf)}


@pytest.mark.parametrize("name", sorted(_published_bf16_programs()))
def test_bf16_plan_keeps_activations_in_registers(name):
    """Every published bf16 program reserves no activation tile, fits
    shared memory with six 32 KB slabs in its ring (the 64 KB the two
    activation tiles would take), stages its hvx rows, and its ring holds a
    layer's slabs (the consumers' turns need them all in it)."""
    spec = _published_bf16_programs()[name]
    plan = fused_mlp.sm90_plan(spec)
    hdr, layers = _sm90_layers(plan.words)
    _, _, ns, in_lo, in_hi, lo_kb, hi_kb, act_kb, slot, stages, head_floats, rays, cst, _ = hdr
    assert act_kb == 0 and slot == 32 * 1024 and stages == 6 and rays > 0
    assert max(sum(op["kb"]) for op in layers) <= stages
    want = (stages * slot + 2 * (lo_kb + hi_kb) * 8192 + -(-head_floats * 4 // 16) * 16
            + 2 * 4 * cst + (2 * 6 + 1) * 8)
    assert plan.smem == want <= fused_mlp._SMEM_LIMIT
    rows = 65536 * ns  # a render chunk
    words, *_, smem = fused_mlp.pack_program(spec, _zero_params(spec), rows)
    assert words[1] == rows and smem == plan.smem


def _zero_params(spec):
    """Zero kernel params of the spec's shapes (or a tuple per member)."""
    members = spec.members if isinstance(spec, fused_mlp.EnsembleSpec) else (spec,)
    kps = tuple({k: torch.zeros(shape) for k, shape in fused_mlp._sm90_shapes(m).items()}
                for m in members)
    return kps if isinstance(spec, fused_mlp.EnsembleSpec) else kps[0]


def test_bf16_plan_refuses_a_ring_shorter_than_a_layer():
    """A layer of more slabs than any ring that fits would deadlock the
    consumers' turns: the plan raises instead (a lo input 640 wide: a
    skip layer of 4 + 10 slabs)."""
    cfg = mlp.MLPConfig(points_pe_degree=106)  # 3 + 6 x 106 = 639 inputs
    with pytest.raises(ValueError, match="weight slabs"):
        fused_mlp.sm90_plan(fused_mlp.make_spec(cfg, 64, torch.bfloat16))


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
    _, ops = _bwd90_ops(plan.words)
    pos, mats = 0, []
    for op in ops:
        segs = []
        for s in range(op["nseg"]):
            mat, pos = _image_mats(op["n_pad"], op["kb"][s], plan.wts, pos, f32)
            segs.append(mat)
        mats.append(segs)
    assert pos == plan.wts.numel()
    return mats


def _run_bwd90_rows(plan, n, lo, hi, hvxs, dp, saved=None):
    """The row pass's program, run as fused_mlp_bwd_rows_sm90_kernel (bf16)
    or fused_mlp_bwd_rows_tf32_kernel (float32, products in 3xTF32) runs
    it, tile by tile: (stash, g32, per-tile partials). An op with no tensor
    map stores no stash: its slot stays zero. Float32 slots have
    plan.stash_ld rows; a backward op's slot (the weight pass's G) is
    stored K-major there, (r, c) at slot * ld + c * ld + r. The float32
    program runs no forward op: it reads `saved`, the training forward's
    (acts, masks) (`_run_sm90_program` with the plan), its head ops the
    activations and its backward ops the mask words."""
    hdr, ops = _bwd90_ops(plan.words)
    ns, in_lo, in_hi, lo_kb, hi_kb, act_kb = hdr[2:8]
    slot_bytes, part_w, n_maps = hdr[8], hdr[12], hdr[14]
    assert part_w == plan.part_w and n_maps == len(plan.row_maps)
    cd, bm = plan.wts.dtype, 128
    f32 = cd == torch.float32
    depth = 32 if f32 else 64
    mats = _bwd90_slabs(plan, f32)
    ld = plan.stash_ld
    assert ld == (-(-n // 8) * 8 if f32 else n)
    stash = torch.zeros(plan.stash_cols * ld, dtype=cd)
    g32 = torch.zeros((max(plan.n_hvx, 1), n, max(plan.hvx_w, 1)))
    n_tiles = -(-n // bm)
    parts = torch.zeros((n_tiles, part_w))
    fpar = plan.fpar
    if f32:  # a block holds its activation tile only
        assert (in_lo, in_hi, lo_kb, hi_kb) == (0, 0, 0, 0)
        acts, words = saved

    def store(op, rows, v):
        if op["map"] >= 0:
            assert plan.row_maps[op["map"]] == (op["out_slot"], op["n"])
            off, w = op["out_slot"], op["n"]
            if f32 and op["kind"] == fused_mlp._B_LAYER:
                stash[off * ld : (off + w) * ld].view(w, ld)[:, rows] = v[:, :w].T
            else:
                stash[off * ld : off * ld + n * w].view(n, w)[rows] = v[:, :w]

    for t in range(n_tiles):
        rows = slice(t * bm, min(n, (t + 1) * bm))
        r = rows.stop - rows.start
        tiles = {fused_mlp._SRC_LO: torch.zeros((r, depth * lo_kb), dtype=cd),
                 fused_mlp._SRC_HI: torch.zeros((r, depth * hi_kb), dtype=cd)}
        if in_lo:
            tiles[fused_mlp._SRC_LO][:, :in_lo] = lo[rows]
        if in_hi:
            tiles[fused_mlp._SRC_HI][:, :in_hi] = hi[rows]
        masks = {}
        for op, segs in zip(ops, mats):
            kind, width, n_pad, flags = op["kind"], op["n"], op["n_pad"], op["flags"]
            assert kind in ((fused_mlp._H_LAYER, fused_mlp._B_LAYER) if f32 else
                            (fused_mlp._F_IN, fused_mlp._F_LAYER, fused_mlp._B_LAYER))
            if kind == fused_mlp._F_IN:
                store(op, rows, tiles[op["src"][0]])
                continue
            assert n_pad in (64, 128, 256) and n_pad <= depth * act_kb
            assert (16384 if f32 else n_pad * 128) <= slot_bytes
            d = dp[op["plane"] : op["plane"] + op["head_nout"], rows]
            if kind == fused_mlp._H_LAYER:  # the head's partials from the forward's activations
                assert op["nseg"] == 0 and op["map"] == -1 and op["head_nout"]
                a = acts[op["out_slot"] * ld : op["out_slot"] * ld + n * width].view(n, width)[rows]
                parts[t, op["part"] : op["part"] + op["head_nout"] * width] = (d @ a).reshape(-1)
                parts[t, op["part2"] : op["part2"] + op["head_nout"]] = d.sum(1)
                continue
            acc = torch.zeros((r, n_pad))
            for s, w in enumerate(segs):
                k = (w[0] if f32 else w).shape[1]
                acc = acc + _product(tiles[op["src"][s]][:, :k], w, f32)
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
                on = (_mask_of(words[t, op["mask_slot"]], r, n_pad) if f32
                      else masks[op["mask_slot"]][:, :n_pad])
                acc = acc * on
            if op["g32_slot"] >= 0:
                g32[op["g32_slot"], rows] = acc[:, :width]
            tiles[fused_mlp._SRC_ACT] = acc.to(cd)
            store(op, rows, acc.to(cd))
            parts[t, op["part"] : op["part"] + width] = acc[:, :width].sum(0)
    return stash, g32, parts


def _run_bwd_program(spec, kp, lo, hi, hvxs, d_planes):
    """Execute `pack_bwd_program`'s output with PyTorch ops, tile by tile and
    task by task, as the backward kernels do: (per-member dkp, dhvx stack).
    The row pass runs the program of `_bwd_plan` (`_run_bwd90_rows`); in
    float32 after the training forward (`_run_sm90_program` with the
    plan), whose activations the weight pass reads as A."""
    n = lo.shape[0]
    plan = fused_mlp.pack_bwd_program(spec, kp, n)
    ns = int(plan.words[2])  # the row program's header
    members = spec.members if isinstance(spec, fused_mlp.EnsembleSpec) else (spec,)
    bf16 = members[0].cdtype == torch.bfloat16
    dp = d_planes.reshape(d_planes.shape[0], n)
    saved = None if bf16 else _run_sm90_program(spec, kp, lo, hi, hvxs, plan)[1]
    stash, g32, parts = _run_bwd90_rows(plan, n, lo, hi, hvxs, dp, saved)
    if bf16:
        dw = _run_wgrad_jobs(stash, n, plan.tasks, plan.maps, plan.chunk_rows, plan.n_chunks,
                             plan.dw_total)
    else:  # the float32 weight pass's jobs through its tensor maps, in 3xTF32
        dw = _wgrad_tf32_tests().run_wgrad32_jobs(stash, n, plan.tasks, plan.maps, plan.chunk_rows,
                                                  plan.n_chunks, plan.dw_total, acts=saved[0])
    dhvx = g32[: plan.n_hvx].reshape(plan.n_hvx, n // ns, ns, g32.shape[-1]).sum(2)
    return fused_mlp.unpack_grads(plan, dw, parts.sum(0)), dhvx


def _wgrad_tf32_tests():
    """tests/test_torch_port_wgrad_tf32.py, whose `run_wgrad32_jobs` runs the
    float32 weight pass's jobs as the kernel runs them."""
    import importlib.util

    path = Path(__file__).resolve().parent / "test_torch_port_wgrad_tf32.py"
    spec = importlib.util.spec_from_file_location("wgrad_tf32_tests", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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
    its own mask slot (float32: in the training forward's layout), which
    its backward layer reads; the mask buffer holds every thread's words of
    every tile, the ragged last one included."""
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
    hdr, ops = _bwd90_ops(plan.words)
    n_masks = dict(zip(fused_mlp._BWD90_HEADER, hdr))["n_masks"]
    ranges, relu_f, relu_b = [], {}, []
    if dtype == torch.float32:  # the training forward packs the masks of the forward program's layers
        _, _, _, _, fwd_masks, _, mask_slots = _stash_words(plan)
        assert fwd_masks == n_masks
        for layer, mask in zip(_sm90_layers(fused_mlp.sm90_plan(spec).words)[1], mask_slots):
            if layer["flags"] & fused_mlp._FLAG_RELU:
                assert mask not in relu_f and 0 <= mask < n_masks
                relu_f[mask] = layer["n"]
    for op in ops:
        kind, width, flags = op["kind"], op["n"], op["flags"]
        mask, hn, part, part2 = op["mask_slot"], op["head_nout"], op["part"], op["part2"]
        if kind == fused_mlp._H_LAYER:
            ranges += [(part, part + hn * width), (part2, part2 + hn)]
        elif kind == fused_mlp._F_LAYER:
            if hn:
                ranges += [(part, part + hn * width), (part2, part2 + hn)]
            if flags & fused_mlp._FLAG_RELU:
                assert mask not in relu_f and 0 <= mask < n_masks
                relu_f[mask] = width
            else:
                assert mask == 0  # the row program's word for no mask
        elif kind == fused_mlp._B_LAYER:
            ranges.append((part, part + width))
            if flags & fused_mlp._FLAG_RELU:
                relu_b.append((mask, width))
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


def _padded_op_weights(spec, plan, kp, depth):
    """Each row-pass op's segments' weights, zero-padded to (n_pad, depth
    kb), from `w_src` and the row program alone: `w_src` names every op's
    segments in op order, a forward op's W^T and a backward op's W, which
    must be that of the activation segment of the layer above: each
    member's backward ops walk its layers (`_layers`) from the top, whose
    op has no product."""
    kps = list(kp) if isinstance(kp, tuple) else [kp]
    layers = fused_mlp._layers(spec)
    above = []  # each backward op's product, in program order: (member, key) or None
    for mi in range(len(kps)):
        mine = [x for x in layers if x.mi == mi]
        above += [(mi, mine[i + 1].segs[0][1]) if i + 1 < len(mine) else None
                  for i in range(len(mine) - 1, -1, -1)]
    srcs, above, out = iter(plan.w_src), iter(above), []
    for op in _bwd90_ops(plan.words)[1]:
        keys = [next(srcs) for _ in range(op["nseg"])]
        if op["kind"] == fused_mlp._B_LAYER:
            want = next(above)
            assert keys == ([want] if want else []), (keys, want)
        segs = []
        for s_, (mi, key) in enumerate(keys):
            m = kps[mi][key].detach().float()
            m = m.T if op["kind"] == fused_mlp._F_LAYER else m
            want = torch.zeros((op["n_pad"], depth * op["kb"][s_]))
            want[: m.shape[0], : m.shape[1]] = m
            segs.append(want)
        out.append(segs)
    assert next(srcs, None) is None and next(above, None) is None
    return out


@pytest.mark.parametrize("name", sorted(BWD90_CASES))
def test_bwd90_slab_image_unswizzles_to_padded_weights(name):
    """Every slab of the bf16 row pass's image, read back through the
    swizzle, is its op's weight zero-padded to (n_pad, 64 kb): a forward
    op's W^T, a backward op's W (that of the activation segment of the
    layer above); the float32 program has no forward op and the same
    backward ops but for their K blocks, stash slots and head weights'
    offsets (its buffer holds no bias)."""
    spec, kp, lo, *_ = _bwd90_operands(name)
    n = lo.shape[0]
    plan = fused_mlp.pack_bwd_program(spec, kp, n)
    twin = fused_mlp.pack_bwd_program(_f32_twin(spec), kp, n)  # float32 weights
    keys = ("n", "n_pad", "flags", "nseg", "src", "mask_slot", "plane", "head_nout", "part",
            "g32_slot")
    ops, twin_ops = ([{k: op[k] for k in keys} for op in _bwd90_ops(p.words)[1]
                      if op["kind"] == fused_mlp._B_LAYER] for p in (plan, twin))
    assert ops == twin_ops
    for i, (segs, wants) in enumerate(zip(_bwd90_slabs(plan), _padded_op_weights(spec, plan, kp, 64))):
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
    _, ops = _bwd90_ops(plan.words)
    read = {s_: w for a, aw, g_, gw, *_ in plan.dws for s_, w in ((a, aw), (g_, gw))}
    mapped = [(op["out_slot"], op["n"]) for op in ops if op["map"] >= 0]
    assert [ops[i]["map"] for i in range(len(ops)) if ops[i]["map"] >= 0] == list(range(len(mapped)))
    assert list(plan.row_maps) == mapped and dict(mapped) == read
    skipped = [op for op in ops if op["map"] < 0]
    assert skipped and all(op["kind"] == fused_mlp._F_LAYER and op["head_nout"] for op in skipped)


@pytest.mark.parametrize("name", sorted(BWD90_CASES))
def test_row_program_runs_the_forward_programs_layers(name):
    """The bf16 row pass's forward ops are the forward program's layers, in
    its order: the same widths, sources and K blocks of each segment,
    flags, hvx slot, and head channels and plane. The float32 training
    forward runs the forward program itself and stores each of its layers
    (a slot of the layer's width each, none shared, lo and hi beside them),
    and the float32 row pass has a head op for each layer with a head, in
    order. Both: one backward op for each layer, each member's in
    reverse."""
    spec, kp, lo, *_ = _bwd90_operands(name)
    for s in (spec, _f32_twin(spec)):
        _, layers = _sm90_layers(fused_mlp.sm90_plan(s).words)
        plan = fused_mlp.pack_bwd_program(s, kp, lo.shape[0])
        _, ops = _bwd90_ops(plan.words)
        if s is spec:
            fwd = [op for op in ops if op["kind"] == fused_mlp._F_LAYER]
            keys = ("n", "n_pad", "nseg", "src", "kb", "flags", "hvx_slot", "plane")
            assert [{k: op[k] for k in keys} | {"nout": op["head_nout"]} for op in fwd] == [
                {k: layer[k] for k in keys + ("nout",)} for layer in layers]
        else:
            lo_slot, lo_n, hi_slot, hi_n, _, slots, _ = _stash_words(plan)
            widths = [(lo_slot, lo_n)] + ([(hi_slot, hi_n)] if hi_slot >= 0 else [])
            widths += [(slot, layer["n"]) for slot, layer in zip(slots, layers)]
            assert slots[len(layers) :] == [-1] * (fused_mlp._MAX_OPS - len(layers))
            cols = sorted(c for slot, w in widths for c in range(slot, slot + w))
            assert cols == list(range(plan.act_cols))  # every slot its own columns
            heads = [op for op in ops if op["kind"] == fused_mlp._H_LAYER]
            by_slot = dict(zip(slots, layers))
            assert [(op["n"], op["plane"], op["head_nout"]) for op in heads] == [
                (layer["n"], layer["plane"], layer["nout"]) for layer in layers if layer["nout"]]
            assert all(by_slot[op["out_slot"]]["nout"] == op["head_nout"] for op in heads)
        back = [op for op in ops if op["kind"] == fused_mlp._B_LAYER]
        assert sorted(op["n"] for op in back) == sorted(layer["n"] for layer in layers)


@pytest.mark.parametrize("name", sorted(BWD90_CASES))
def test_f32_row_program_has_no_forward_ops(name):
    """The float32 row program runs no forward op (the training forward
    stored what they gave): each member's head ops, one per head, then its
    backward ops; its blocks hold an activation tile only, so the ring
    takes the deepest depth; and the training forward's layout has the
    header's size."""
    spec, kp, lo, *_ = _bwd90_operands(name)
    spec = _f32_twin(spec)
    plan = fused_mlp.pack_bwd_program(spec, kp, lo.shape[0])
    hdr, ops = _bwd90_ops(plan.words)
    h = dict(zip(fused_mlp._BWD90_HEADER, hdr))
    kinds = [op["kind"] for op in ops]
    assert set(kinds) == {fused_mlp._H_LAYER, fused_mlp._B_LAYER}
    members = spec.members if isinstance(spec, fused_mlp.EnsembleSpec) else (spec,)
    heads = [sum(x.head is not None for x in fused_mlp._layers(spec) if x.mi == mi)
             for mi in range(len(members))]
    assert kinds.count(fused_mlp._H_LAYER) == sum(heads)
    first_back = [i for i, k in enumerate(kinds) if k == fused_mlp._B_LAYER and ops[i]["nseg"] == 0]
    assert len(first_back) == len(members)  # one walk back a member, from its top layer
    for i, h_ in zip(first_back, heads):  # the member's head ops come right before its walk back
        assert kinds[i - h_ : i] == [fused_mlp._H_LAYER] * h_
    assert (h["in_lo"], h["in_hi"], h["lo_kb"], h["hi_kb"], h["cst_floats"]) == (0, 0, 0, 0, 0)
    assert h["stages"] == max(fused_mlp._BWD90_STAGES) and plan.smem <= fused_mlp._SMEM_LIMIT
    text = (Path(fused_mlp.__file__).resolve().parent / "csrc" / "fused_mlp_tf32_sm90.cuh").read_text()
    header = int(re.search(r"constexpr int kStashHeader = (\d+);", text).group(1))
    assert plan.fwd_words.size == header + 2 * fused_mlp._MAX_OPS


def _plain_layers(spec, kp, lo, hi, hvxs):
    """Every layer's activation in the forward programs' order, from the
    plain version: each member's trunk, feature and views layers."""
    if not isinstance(spec, fused_mlp.EnsembleSpec):
        spec, kp, hvxs, extra = fused_mlp.EnsembleSpec(members=(spec,)), (kp,), hvxs, [hi]
    else:
        extra = [lo if m.has_extra else None for m in spec.members]
    out = []
    for m, k, x, hvx in zip(spec.members, kp, extra, fused_mlp._member_hvx(spec, list(hvxs))):
        hs = fused_mlp._trunk_forward(m, k, lo)
        out += hs
        if m.has_views:
            f, hvs = fused_mlp._views_forward(m, k, hs[-1], x, hvx)
            out += [f, *hvs]
    return out


@pytest.mark.parametrize("name", sorted(BWD90_CASES))
def test_stash_forward_stores_the_plain_activations_and_masks(name):
    """The float32 training forward, run as its kernel runs it, stores what
    the row pass's forward ops used to produce: lo (hi) bit for bit, each
    layer's activation within float32 rounding of the plain version's
    (3xTF32 products), and its ReLU mask words holding exactly the plain
    activation's sign but where that activation is within rounding of 0,
    in the 128-row tiles' thread layout; and the plain version's planes."""
    spec, kp, lo, hi, hvxs, _ = _bwd90_operands(name, nr=37, ns=7)
    spec, lo, hi = _f32_twin(spec), lo.float(), hi.float() if hi is not None else None
    n = lo.shape[0]
    plan = fused_mlp.pack_bwd_program(spec, kp, n)
    planes, (acts, words) = _run_sm90_program(spec, kp, lo, hi, hvxs, plan)
    lo_slot, lo_n, hi_slot, hi_n, n_masks, slots, mask_slots = _stash_words(plan)
    ld = plan.stash_ld

    def slot(s_, w):
        return acts[s_ * ld : s_ * ld + n * w].view(n, w)

    assert torch.equal(slot(lo_slot, lo_n)[:, : lo.shape[1]], lo)
    assert not slot(lo_slot, lo_n)[:, lo.shape[1] :].any()  # the tile's zero columns
    if hi is not None and hi_slot >= 0:
        assert torch.equal(slot(hi_slot, hi_n)[:, : hi.shape[1]], hi)
    layers = _sm90_layers(fused_mlp.sm90_plan(spec).words)[1]
    plain = _plain_layers(spec, kp, lo, hi, hvxs)
    assert len(plain) == len(layers)
    for li, (layer, want) in enumerate(zip(layers, plain)):
        got = slot(slots[li], layer["n"])
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-5 * scale, f"layer {li}"
        if layer["flags"] & fused_mlp._FLAG_RELU:
            for t in range(-(-n // 128)):
                rows = slice(128 * t, min(n, 128 * t + 128))
                on = _mask_of(words[t, mask_slots[li]], rows.stop - rows.start, 256)
                assert not on[:, layer["n"] :].any()
                near = want[rows].abs() <= 1e-5 * scale
                assert torch.equal(on[:, : layer["n"]] | near, (want[rows] > 0) | near), f"layer {li}"
                assert torch.equal(on[:, : layer["n"]], got[rows] > 0), f"layer {li}"
    want = _plain_planes(spec, kp, lo, hi, hvxs if isinstance(spec, fused_mlp.EnsembleSpec)
                         else (hvxs[0] if hvxs else None))
    for a, b in zip(planes, want):
        assert (a - b).abs().max().item() <= 1e-5 * max(b.abs().max().item(), 1.0)


# The bf16 row and weight passes' plans and both engines' forward programs,
# as digests (`_plan_digest`) taken when the float32 backward began to read
# the training forward's stash: that change gives a bf16 kernel and the
# no-grad forward the inputs they had.
PINNED = {("main", 30): "6b2e65f15ebd0174", ("main", 66405): "e9bdb50f3632dfd4",
          ("published", 30): "c0a93c80b11249aa", ("published", 66405): "ba3f9c323b375cf3",
          ("trio", 30): "58b81f9451666f99", ("trio", 66405): "8c24007da44ef046",
          ("trunk160", 30): "c2214a9b5a5aab6d", ("trunk160", 66405): "da39d2d5423fc802",
          ("trunk48", 30): "86dc804e10c7e700", ("trunk48", 66405): "bd30bb3959e7eba5",
          ("views80", 30): "fc958d37ba1ad777", ("views80", 66405): "d17ca504cf29bce5"}


def _plan_digest(spec, n):
    """sha256 of the bf16 backward's plan of `spec` at n rows (program
    words, jobs, maps, gathers, sizes, gradient places) and of the forward
    programs of spec and its float32 twin."""
    import hashlib

    h = hashlib.sha256()
    plan = fused_mlp._bwd_plan(spec, n)
    for a in (plan.words, plan.tasks, plan.maps, plan.w_index, plan.f_index):
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(repr((plan.row_maps, plan.w_src, plan.f_src, plan.stash_cols, plan.part_w, plan.dw_total,
                   plan.n_chunks, plan.chunk_rows, plan.smem, plan.mask_words, plan.slices, plan.scratch,
                   plan.grads)).encode())
    for s_ in (spec, _f32_twin(spec)):
        fp = fused_mlp.sm90_plan(s_)
        for a in (fp.words, fp.w_index, fp.f_index):
            h.update(np.ascontiguousarray(a).tobytes())
        h.update(repr((fp.w_src, fp.f_src, fp.smem)).encode())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("name", sorted(BWD90_CASES))
def test_bf16_plans_and_forward_programs_are_pinned(name):
    """The bf16 row program, weight pass and gathers, and both forward
    programs, at a tile's worth of rows and a ragged 66,405, equal their
    pinned digests."""
    spec, kp, lo, *_ = _bwd90_operands(name)
    for n in (lo.shape[0], 66_368 + 37):
        assert _plan_digest(spec, n) == PINNED[(name, n)], (name, n)


def _np_tf32(x):
    """cvt.rna.tf32.f32 in numpy, on the uint32 view: round the magnitude's
    13 low bits to the nearest, ties away from zero, then clear them."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("name", sorted(BWD90_CASES))
def test_f32_bwd_buffer_holds_each_ops_padded_weight(name):
    """The float32 row pass's weight image, gathered from the parameters
    and split, holds each backward op's padded weight W in its chunks (the
    program has no forward op): read back through the swizzle and the
    permuted K order, the big half is tf32(W) and the small half
    tf32(W - big), bit for bit, and big + small is W to 2^-22 of |W|."""
    spec, kp, lo, *_ = _bwd90_operands(name)
    spec = _f32_twin(spec)
    plan = fused_mlp.pack_bwd_program(spec, kp, lo.shape[0])
    assert plan.wts.dtype == torch.float32
    for i, (segs, wants) in enumerate(zip(_bwd90_slabs(plan, f32=True),
                                          _padded_op_weights(spec, plan, kp, 32))):
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
    assert a.words is b.words and a.row_maps is b.row_maps and a.dev_tasks is b.dev_tasks
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
    assert (int(enums["F_IN"]), int(enums["F_LAYER"]), int(enums["H_LAYER"]), int(enums["B_LAYER"])) == (
        fused_mlp._F_IN, fused_mlp._F_LAYER, fused_mlp._H_LAYER, fused_mlp._B_LAYER)


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
    hdr, ops = _bwd90_ops(plan.words)
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
