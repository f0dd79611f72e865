"""The float32 weight pass of the backward (3xTF32 wgmma, TMA, G K-major),
on the CPU, against the JAX package.

The kernel (simplenerf_torch/ops/csrc/fused_mlp_wgrad_tf32_sm90.cuh) runs
only on the card. Here: the plan that ops/fused_mlp.py `_wgrad_plan` makes
for it (every job, 128 rows by 128 columns of a dW, once per chunk; two
jobs that share G or A a cluster), the tensor maps it asks the host to encode (row-major A
slots, K-major G slots, ld = `_stash_ld(n_rows)`), the bytes its producers
issue, the header's constants against the packer's; a Python twin of the
fragment layout (each fragment row a dW row once, each warp's A loads on 32
banks through the 128-byte swizzle) and of the float32 row pass's K-major G
store (each element once, whole 32-byte sectors); and a torch emulation of
the kernel's arithmetic (`run_wgrad32_jobs`: each job read through its
tensor maps in 32-row stages, A and G split into big and small TF32 halves
as cvt.rna rounds, each stage's three products summed apart and added in
float32, one partials row per chunk, the chunks summed in order) on a
stash laid out as the row pass lays it out, held against the JAX package's
dW product `_mm_tn` in float32 on the same numpy inputs, and within 4 x
the float32 plain version's error of the float64 product (chip_smoke.py's
YARDSTICK).
"""

import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from simplenerf_tpu.ops import fused_mlp as jfused
from simplenerf_torch.fields import mlp
from simplenerf_torch.ops import fused_mlp

CSRC = Path(fused_mlp.__file__).resolve().parent / "csrc"
PUBLISHED = {"main": {}, "points_aug": {"points_sigma_pe_degree": 3},
             "lambertian": {"use_view_dirs": False, "view_dependent_rgb": False}}
# Rows: the step's (4096 rays x 192 fine, x 64 coarse) and ragged counts
# (no multiple of 8, so the stash's rows are padded).
ROWS = {"fine": [786_432, 66_368 + 37], "trio": [262_144, 40_000 + 5]}
YARDSTICK = 4.0  # chip_smoke.YARDSTICK


def _program(which: str, dtype=torch.float32):
    """(spec, kp) of the published fine MLP or the coarse trio."""
    g = torch.Generator().manual_seed(0)
    pts = torch.rand((8 * 4, 3), generator=g)
    dirs = torch.nn.functional.normalize(torch.randn((8, 3), generator=g), dim=-1)
    if which == "fine":
        cfg = mlp.MLPConfig()
        return mlp.fused_operands(mlp.init(g, cfg), cfg, pts, dirs, 4, dtype)[:2]
    members = [(mlp.init(g, mlp.MLPConfig(**kw)), mlp.MLPConfig(**kw)) for kw in PUBLISHED.values()]
    return mlp.ensemble_operands(members, pts, dirs, 4, dtype)[:2]


def _cases():
    return [(which, n) for which, rows in ROWS.items() for n in rows]


def read_box(stash, m, c0, c1):
    """The box of tensor map `m` (float32 parameters: element offset, dim 0,
    dim 1, dim 1's stride in bytes, box 0, box 1, buffer) at coordinates
    (c0, c1) of `stash`, its buffer: a (box 1, box 0) tensor, zeros past
    the dims, as TMA fills it."""
    off, d0, d1, stride, b0, b1, _ = (int(v) for v in m)
    out = torch.zeros((b1, b0), dtype=stash.dtype)
    n0, n1 = max(0, min(b0, d0 - c0)), max(0, min(b1, d1 - c1))
    if n0 and n1:
        idx = off + (c1 + torch.arange(n1))[:, None] * (stride // 4) + (c0 + torch.arange(n0))[None, :]
        out[:n1, :n0] = stash[idx]
    return out


def a_row(w: int, h: int, g: int) -> int:
    """The dW row of a consumer's 64 that fragment row 16w + 8h + g is (the
    kernel's `a_row`)."""
    return 32 * (w >> 1) + 4 * ((2 * (w & 1) + h) ^ (4 * (g >> 2))) + (g & 3)


def run_wgrad32_jobs(stash, n, jobs, maps, chunk_rows, n_chunks, dw_total, split=True, acts=None):
    """The float32 weight pass's jobs as fused_mlp_bwd_wgrad_tf32_kernel runs
    them: each consumer's A boxes (through `a_row`) and G boxes, read through
    the tensor maps in stages of 32 rows (a map of buffer 0 reads `acts`, the
    training forward's activations, where given, and else `stash`, as one of
    buffer 1 does); per stage the products small.big + big.small + big.big
    of the TF32 halves (split=False: the float32 product), summed apart and
    added to the accumulators in float32; one partials row per chunk, each
    dW element written by exactly one consumer; then the chunks summed in
    order."""
    buffers = (stash if acts is None else acts, stash)
    depth, abox, gbox = fused_mlp._WGRAD32_DEPTH, fused_mlp._WGRAD32_ABOX, fused_mlp._WGRAD32_GBOX
    frag = torch.tensor([a_row(w, h, g) for w in range(4) for h in range(2) for g in range(8)])
    part = torch.zeros((n_chunks, dw_total))
    written = torch.zeros((n_chunks, dw_total), dtype=torch.int32)
    for chunk, a_map, i0, n_a, g_map, g0, n_g, dw_off, k_in, n_out in jobs.tolist():
        r_begin, r_end = chunk * chunk_rows, min(n, (chunk + 1) * chunk_rows)
        for c in range(2):
            ab, gb, gn = 2 * c, 0, n_g
            if n_a <= 2:
                ab, gb, gn = 0, c, int(c < n_g)
            if gn == 0:
                continue
            gb0 = g0 + gb
            acc = torch.zeros((64, 64 * gn))
            for row in range(r_begin, r_end, depth):
                boxes = [read_box(buffers[maps[a_map][6]], maps[a_map], i0 + (ab + b) * abox, row)
                         if ab + b < n_a
                         else torch.full((depth, abox), float("nan")) for b in range(2)]
                a = torch.cat(boxes, 1)[:, frag]  # (K, fragment rows)
                gt = torch.cat([read_box(buffers[maps[g_map][6]], maps[g_map], row, (gb0 + b) * gbox)
                                for b in range(gn)], 0).T  # (K, N)
                if split:
                    ab_, as_ = fused_mlp.tf32_halves(a)
                    gb_, gs_ = fused_mlp.tf32_halves(gt)
                    stage = (as_.T @ gb_ + ab_.T @ gs_) + ab_.T @ gb_
                else:
                    stage = a.T @ gt
                acc = acc + stage
            view = part[chunk, dw_off : dw_off + k_in * n_out].view(k_in, n_out)
            seen = written[chunk, dw_off : dw_off + k_in * n_out].view(k_in, n_out)
            for m in range(64):
                r = i0 + abox * ab + int(frag[m])
                cols = slice(gbox * gb0, min(n_out, gbox * (gb0 + gn)))
                if r < k_in and cols.start < cols.stop:
                    view[r, cols] = acc[m, : cols.stop - cols.start]
                    seen[r, cols] += 1
    assert (written == 1).all(), "a dW element is written by no consumer or by two"
    dw = torch.zeros(dw_total)
    for chunk in range(n_chunks):
        dw += part[chunk]
    return dw


def stash_of(slots, n, plan):
    """The float32 backward's two buffers of `slots` ({("a" | "g", slot,
    width): (n, width)}), laid out as the training forward and the float32
    row pass lay them out: every slot a dW reads as A row-major in the
    activation stash, (r, c) at slot * ld + r * width + c, and every slot it
    reads as G K-major in the row pass's stash, at slot * ld + c * ld + r:
    (acts, stash)."""
    ld = fused_mlp._stash_ld(n)
    acts, stash = torch.zeros(plan.act_cols * ld), torch.zeros(plan.stash_cols * ld)
    for (kind, s, w), x in slots.items():
        if kind == "g":
            stash[s * ld : (s + w) * ld].view(w, ld)[:, :n] = x.T
        else:
            acts[s * ld : s * ld + n * w].view(n, w)[:] = x
    return acts, stash


@pytest.mark.parametrize("which,n", _cases())
def test_f32_plan_covers_every_panel_once_in_clusters(which, n):
    """Every job (a panel of 128 dW rows by a half of 128 columns, the last
    of each ragged) of every dW runs once per chunk; the jobs of a dW are
    clusters of two (jobs 2i and 2i + 1) where there is an even number of
    them: the two panels of a half (the same G) or else the two halves of a
    panel (the same A); A boxes of 32 columns (at most four, none past the
    panel), G boxes of 64 (at most two, none past n_out)."""
    spec, kp = _program(which)
    plan = fused_mlp.pack_bwd_program(spec, kp, n)
    jobs = plan.tasks.tolist()
    assert plan.tasks.shape[1] == fused_mlp._JOB32_WORDS
    want = sorted((c, off, i0, g0) for c in range(plan.n_chunks) for *_, k, m, off in plan.dws
                  for i0 in range(0, k, 128) for g0 in range(0, -(-m // 64), 2))
    assert sorted((j[0], j[7], j[2], j[5]) for j in jobs) == want
    per_dw = {}
    for off in {j[7] for j in jobs}:
        per_dw[off] = sum(1 for j in jobs if j[7] == off and j[0] == 0)
    for idx, (chunk, a_map, i0, n_a, g_map, g0, n_g, off, k_in, n_out) in enumerate(jobs):
        assert n_a == min(4, -(-(k_in - i0) // 32)) and 1 <= n_a <= 4
        assert n_g == min(2, -(-n_out // 64) - g0) and 1 <= n_g <= 2 and g0 % 2 == 0
        if idx % 2 == 1 and per_dw[off] % 2 == 0:
            first = jobs[idx - 1]
            assert (first[0], first[7]) == (chunk, off)
            assert (first[5] == g0 and (first[2], i0) == (0, 128)) or \
                (first[2] == i0 and (first[5], g0) == (0, 2))
    assert plan.chunk_rows % fused_mlp._WGRAD32_DEPTH == 0
    assert (plan.n_chunks - 1) * plan.chunk_rows < n <= plan.n_chunks * plan.chunk_rows
    assert len(jobs) >= 2 * fused_mlp._SMS


@pytest.mark.parametrize("which,n", _cases())
def test_f32_tensor_maps(which, n):
    """One map per slot the jobs read as A (row-major: dims (width, n_rows),
    rows width x 4 bytes apart, 32 x 32 boxes) and one per slot they read as
    G (K-major: dims (n_rows, width), columns ld x 4 bytes apart, boxes of
    32 rows x 64 columns); every slot starts at slot * ld, 16-byte aligned,
    inside its buffer (A the training forward's activation stash, G the row
    pass's); each box's inner extent is the swizzle's 128 bytes; the jobs'
    boxes start inside their slots."""
    spec, kp = _program(which)
    plan = fused_mlp.pack_bwd_program(spec, kp, n)
    ld = plan.stash_ld
    assert ld == -(-n // 8) * 8 and ld % 8 == 0
    maps, jobs = plan.maps, plan.tasks
    assert maps.shape[1] == fused_mlp._WGRAD32_MAP
    a_slots = {(a, aw) for a, aw, *_ in plan.dws}
    g_slots = {(g, gw) for _, _, g, gw, *_ in plan.dws}
    kinds = {}
    for idx, (off, d0, d1, stride, b0, b1, buf) in enumerate(maps.tolist()):
        assert off % ld == 0 and (off * 4) % 16 == 0 and stride % 16 == 0
        assert b0 * 4 == 128  # the inner extent: one swizzle span, 32 floats
        if d0 == n and b1 == fused_mlp._WGRAD32_GBOX:  # K-major G, in the row pass's stash
            kinds[idx] = ("g", off // ld, d1)
            assert stride == ld * 4 and b0 == 32 and buf == 1
            assert off + d1 * ld <= plan.stash_cols * ld
        else:  # A, in the training forward's activation stash
            kinds[idx] = ("a", off // ld, d0)
            assert d1 == n and stride == d0 * 4 and (b0, b1) == (32, 32) and buf == 0
            assert off + d1 * d0 <= plan.act_cols * ld
    assert sorted((s, w) for k, s, w in kinds.values() if k == "a") == sorted(a_slots)
    assert sorted((s, w) for k, s, w in kinds.values() if k == "g") == sorted(g_slots)
    for chunk, a_map, i0, n_a, g_map, g0, n_g, dw_off, k_in, n_out in jobs.tolist():
        assert kinds[a_map][0] == "a" and kinds[g_map][0] == "g"
        assert i0 + (n_a - 1) * 32 < kinds[a_map][2] and k_in <= kinds[a_map][2]
        assert (g0 + n_g - 1) * 64 < kinds[g_map][2] and n_out <= kinds[g_map][2]


@pytest.mark.parametrize("which,n", _cases())
def test_f32_issued_bytes(which, n):
    """The float32 producers issue, for each dW, its A strip once per half
    of 128 columns (32-column boxes, none past the slot) and its G once per
    panel of 128 rows, in float32; the count printed against the distinct
    slots' bytes, which bound the pass on the card."""
    spec, kp = _program(which)
    plan = fused_mlp.pack_bwd_program(spec, kp, n)
    want = sum((-(-m // 128) * min(-(-k // 32) * 32, a_w) + -(-k // 128) * g_w) * n * 4
               for _, a_w, _, g_w, k, m, _ in plan.dws)
    assert plan.wgrad_bytes == want
    distinct = {s: w for a, aw, g, gw, *_ in plan.dws for s, w in ((a, aw), (g, gw))}
    print(f"{which} {n} rows float32: {plan.wgrad_bytes / 1e9:.3f} GB issued, "
          f"{sum(distinct.values()) * n * 4 / 1e9:.3f} GB of distinct slots")


def test_wgrad32_shared_memory_and_kernel_constants():
    """The header's ring, small images and block size are the packer's, and
    fit a Hopper block; the jobs are the bf16 pass's struct."""
    text = (CSRC / "fused_mlp_wgrad_tf32_sm90.cuh").read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)[;,]", text).group(1))

    assert const("kThreads") == fused_mlp._WGRAD32_THREADS == 288
    assert const("kStages") == fused_mlp._WGRAD32_STAGES
    assert const("kDepth") == fused_mlp._WGRAD32_DEPTH
    assert const("kABox") == fused_mlp._WGRAD32_ABOX and const("kGBox") == fused_mlp._WGRAD32_GBOX
    assert const("kMapWords") == fused_mlp._WGRAD32_MAP
    assert const("kMaxA") == 4 and const("kMaxG") == 2 and const("kSmalls") == 2
    assert const("kJobWords") == fused_mlp._JOB32_WORDS
    stage = 4 * 32 * 32 * 4 + 2 * 64 * 32 * 4
    assert stage == fused_mlp._WGRAD32_STAGE == 32 * 1024
    assert fused_mlp._WGRAD32_SMEM == const("kStages") * stage + 2 * 2 * 64 * 32 * 4 + 2 * const("kStages") * 8
    assert fused_mlp._WGRAD32_SMEM == 196_688 <= fused_mlp._SMEM_LIMIT
    ld = re.search(r"stash_ld\(int n_rows\) \{ return \(n_rows \+ (\d+)\) & ~(\d+); \}",
                   (CSRC / "fused_mlp_tf32_sm90.cuh").read_text())
    assert int(ld.group(1)) + 1 == int(ld.group(2)) + 1 == fused_mlp._STASH_LD_ALIGN


def test_fragment_rows_are_each_dw_row_once_and_loads_hit_32_banks():
    """Fragment row 16w + 8h + g of a consumer is dW row `a_row(w, h, g)`:
    each of its 64 rows once, warps 0-1 in the first 32-column box and 2-3
    in the second. Each of a thread's A loads (K row 8s + t + 4e of the box,
    its row's column) is a 4-byte word of the 128-byte-swizzled box; the 32
    lanes of a warp read 32 different banks for every load."""
    rows = [a_row(w, h, g) for w in range(4) for h in range(2) for g in range(8)]
    assert sorted(rows) == list(range(64))
    for w in range(4):
        assert all((a_row(w, h, g) >= 32) == (w >= 2) for h in range(2) for g in range(8))
    for w in range(4):
        for s in range(4):
            for e in range(2):
                for h in range(2):
                    banks = set()
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        r, col = 8 * s + t + 4 * e, a_row(w, h, g) % 32
                        addr = r * 128 + (((col // 4) ^ (r % 8)) * 16) + (col % 4) * 4
                        banks.add((addr // 4) % 32)
                    assert len(banks) == 32, (w, s, e, h)


@pytest.mark.parametrize("n,width", [(37, 256), (300, 128), (5003, 64), (1032, 256)])
def test_row_pass_k_major_g_store_covers_each_element_once(n, width):
    """A Python twin of the float32 row pass's K-major stash store
    (`stash2k`): tile t, consumer c, warp w, lane (g, q), n8 tile j store
    rows r = 128 t + 64 c + 16 w + g (+ 8) and columns 8 j + 2 q (+ 1) at
    c * ld + r, rows < n_rows only. Each element of the slot is stored
    once, nothing past the slot's width x ld floats, and each store
    instruction of a warp fills whole 32-byte sectors."""
    ld = fused_mlp._stash_ld(n)
    n_pad = fused_mlp._n_pad(width)
    hits = np.zeros(width * ld, dtype=np.int64)
    for t in range(-(-n // 128)):
        for c in range(2):
            for w in range(4):
                for j in range(n_pad // 8):
                    for h in range(2):
                        for e in range(2):
                            sectors = [set() for _ in range(4)]  # by the lane's quad position q
                            for lane in range(32):
                                g, q = lane >> 2, lane & 3
                                r, col = 128 * t + 64 * c + 16 * w + g + 8 * h, 8 * j + 2 * q + e
                                if r < n and col - e < width:
                                    hits[col * ld + r] += 1
                                    sectors[q].add((col * ld + r) * 4 // 32)
                            assert all(len(x) <= 1 for x in sectors)  # 8 rows of a column: one sector
    want = np.zeros((width, ld), dtype=np.int64)
    want[:, :n] = 1
    assert np.array_equal(hits.reshape(width, ld), want)


@pytest.mark.parametrize("n", [300, 777])
def test_f32_kernel_arithmetic_matches_jax_mm_tn(n):
    """The kernel's arithmetic (`run_wgrad32_jobs`) on the published fine
    MLP's stash at a few hundred rows (ragged stages, several chunks) against
    the JAX package's dW product `_mm_tn` in float32 on the same numpy
    slots: within float32 rounding of it (1e-5 of each dW's largest value);
    and no further from the float64 product than YARDSTICK x the float32
    plain version (`wgrad` on the CPU: A^T G in float32) is."""
    spec, kp = _program("fine")
    plan = fused_mlp.pack_bwd_program(spec, kp, n)
    rng = np.random.default_rng(n)
    keys = dict.fromkeys(x for a, aw, g, gw, *_ in plan.dws for x in (("a", a, aw), ("g", g, gw)))
    npslots = {k: (rng.random((n, k[2])) if k[0] == "a" else rng.standard_normal((n, k[2])))
               .astype(np.float32) for k in keys}
    slots = {k: torch.from_numpy(v) for k, v in npslots.items()}
    acts, stash = stash_of(slots, n, plan)
    dw = run_wgrad32_jobs(stash, n, plan.tasks, plan.maps, plan.chunk_rows, plan.n_chunks,
                          plan.dw_total, acts=acts)
    spec32 = types.SimpleNamespace(cdtype=jnp.float32)
    worst = 0.0
    for a, aw, g, gw, k, m, off in plan.dws:
        A, G = npslots[("a", a, aw)][:, :k], npslots[("g", g, gw)][:, :m]
        want = np.asarray(jfused._mm_tn(jnp.asarray(A), jnp.asarray(G), spec32))
        got = dw[off : off + k * m].view(k, m).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), f"dW ({k}, {m})"
        exact = A.astype(np.float64).T @ G.astype(np.float64)
        plain = fused_mlp.wgrad([torch.from_numpy(A), torch.from_numpy(G)], [(0, 1, k, m)])[0].numpy()
        k_err = np.linalg.norm(got - exact) / np.linalg.norm(exact)
        p_err = np.linalg.norm(plain - exact) / np.linalg.norm(exact)
        worst = max(worst, k_err / p_err)
        assert k_err <= YARDSTICK * p_err, f"dW ({k}, {m}): {k_err:.3e} vs plain {p_err:.3e}"
    print(f"float32 weight pass emulation, {n} rows: worst ratio to the plain version's error {worst:.2f}")


@pytest.mark.parametrize("n", [37, 200])
def test_wgrad_f32_jobs_on_its_own_stash_match_the_plain_version(n):
    """`wgrad`'s float32 layout (a slot read as A row-major, read as G
    K-major, a slot read both ways twice) run as the kernel runs its jobs,
    against `wgrad`'s plain version, on the card test's cases: a skip join's
    256 x 256 and lo dWs sharing G (slot 1 is A of one and G of another),
    the views' 256 x 128, 48 and 144 wide dWs (one and three G boxes)."""
    widths = [64, 256, 256, 128, 48, 144]
    dws = [(1, 2, 256, 256), (0, 2, 63, 256), (0, 1, 63, 256), (2, 3, 256, 128),
           (4, 4, 48, 48), (5, 1, 144, 256)]
    rng = np.random.default_rng(n)
    slots = [torch.from_numpy(rng.standard_normal((n, w)).astype(np.float32)) for w in widths]
    ld = fused_mlp._stash_ld(n)
    tasks, col, parts, total = [], {}, [], 0
    for a, g, k, m in dws:
        for i, kmajor in ((a, False), (g, True)):
            if (i, kmajor) not in col:
                col[(i, kmajor)] = sum(widths[j] for j, _ in parts)
                parts.append((i, kmajor))
        tasks.append([col[(a, False)], widths[a], col[(g, True)], widths[g], k, m, total])
        total += k * m
    stash = torch.zeros(sum(widths[i] for i, _ in parts) * ld)
    for i, kmajor in parts:
        c, w = col[(i, kmajor)], widths[i]
        if kmajor:
            stash[c * ld : (c + w) * ld].view(w, ld)[:, :n] = slots[i].T
        else:
            stash[c * ld : c * ld + n * w].view(n, w)[:] = slots[i]
    plan = fused_mlp._wgrad_plan(tasks, n, f32=True)
    assert plan.jobs.shape[1] == fused_mlp._JOB32_WORDS
    dw = run_wgrad32_jobs(stash, n, plan.jobs, plan.maps, plan.chunk_rows, plan.n_chunks, total)
    plain = fused_mlp.wgrad(slots, dws)
    for (a, g, k, m), (*_, off), want in zip(dws, tasks, plain):
        got = dw[off : off + k * m].view(k, m)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), f"dW ({k}, {m})"
