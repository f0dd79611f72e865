"""The host side of the bf16 backward's weight pass and column sums
(simplenerf_torch/ops/fused_mlp.py `_wgrad_plan`, `_colsum_slices`), at the
published widths and the training step's row counts, where the kernels
(csrc/fused_mlp_wgrad_sm90.cuh, csrc/fused_mlp_bwd.cu) run only on the card:
the bytes the plan's producers issue, the tensor maps it asks the host to
encode, the shared memory it needs, its chunks, and the column sums' slices.
What the jobs compute is held against the JAX package's dW product and the
plain backward in tests/test_torch_port_kernel.py.
"""

import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from simplenerf_torch.fields import mlp
from simplenerf_torch.ops import fused_mlp

CSRC = Path(fused_mlp.__file__).resolve().parent / "csrc"
PUBLISHED = {"main": {}, "points_aug": {"points_sigma_pe_degree": 3},
             "lambertian": {"use_view_dirs": False, "view_dependent_rgb": False}}
# Rows: the step's (4096 rays x 192 fine, x 64 coarse) and ragged counts.
ROWS = {"fine": [786_432, 66_368 + 37], "trio": [262_144, 40_000 + 5]}


def _program(which: str):
    """(spec, kp) of the published fine MLP or the coarse trio, bf16."""
    g = torch.Generator().manual_seed(0)
    pts = torch.rand((8 * 4, 3), generator=g)
    dirs = torch.nn.functional.normalize(torch.randn((8, 3), generator=g), dim=-1)
    if which == "fine":
        cfg = mlp.MLPConfig()
        return mlp.fused_operands(mlp.init(g, cfg), cfg, pts, dirs, 4, torch.bfloat16)[:2]
    members = [(mlp.init(g, mlp.MLPConfig(**kw)), mlp.MLPConfig(**kw)) for kw in PUBLISHED.values()]
    return mlp.ensemble_operands(members, pts, dirs, 4, torch.bfloat16)[:2]


def _cases():
    return [(which, n) for which, rows in ROWS.items() for n in rows]


@pytest.mark.parametrize("which,n", _cases())
def test_wgrad_issues_each_slot_once_but_shared_lo_reads(which, n):
    """The producers' stash bytes: every panel reads its A strip once and
    all of its G, so a 256-row dW reads G twice (its two panels run side by
    side; the second read is served by L2 on the card, which this count
    does not see), the lo slot is read once per dW of it, and a G that a
    63-row lo dW shares with a 256-row dW (a skip join's, a views layer's
    with an extra input) once more. Each dW's A once is the distinct
    slots' bytes plus those re-reads."""
    spec, kp = _program(which)
    plan = fused_mlp.pack_bwd_program(spec, kp, n)
    reads: dict = {}
    for a_slot, a_w, g_slot, g_w, k_in, n_out, _ in plan.dws:
        for slot, w in ((a_slot, a_w), (g_slot, g_w)):
            reads[(slot, w)] = reads.get((slot, w), 0) + 1
    per_dw = sum((a_w + g_w) * n * 2 for a_slot, a_w, g_slot, g_w, *_ in plan.dws)
    distinct = sum(w * n * 2 for _, w in reads)
    panels = sum((a_w + (-(-k // 128)) * g_w) * n * 2 for _, a_w, _, g_w, k, *_ in plan.dws)
    assert plan.wgrad_bytes == panels
    assert panels - per_dw == sum((-(-k // 128) - 1) * g_w * n * 2
                                  for _, _, _, g_w, k, *_ in plan.dws)
    twice = {s for s, r in reads.items() if r > 1}
    lo = {(int(plan.ops[0][16]), int(plan.ops[0][17]))}  # the F_IN op's lo slot
    shared_g = {(g, gw) for a, aw, g, gw, k, *_ in plan.dws if k <= 64}
    assert twice <= lo | shared_g
    assert per_dw - distinct == sum((r - 1) * w * n * 2 for (_, w), r in reads.items())
    print(f"{which} {n} rows: {plan.wgrad_bytes / 1e9:.3f} GB issued, {per_dw / 1e9:.3f} GB with "
          f"each dW's slots once, {distinct / 1e9:.3f} GB of distinct slots")


@pytest.mark.parametrize("which,n", _cases())
def test_wgrad_tensor_maps(which, n):
    """One map per slot the jobs read, no more than the kernel's parameter
    holds: the slot's base inside the stash, 16-byte aligned; dims (width,
    n_rows); a row stride of width x 2 bytes, a multiple of 16; and the
    jobs' 64 x 64 boxes start inside the slot."""
    spec, kp = _program(which)
    plan = fused_mlp.pack_bwd_program(spec, kp, n)
    maps, jobs = plan.maps, plan.tasks
    slots = {(a, aw) for a, aw, *_ in plan.dws} | {(g, gw) for _, _, g, gw, *_ in plan.dws}
    assert sorted((int(o) // n, int(w)) for o, w, _, _ in maps) == sorted(slots)
    assert len(maps) <= fused_mlp._WGRAD_MAX_MAPS
    assert fused_mlp._WBOX == 64 and fused_mlp._WBOX * 2 == 128  # a box row is the swizzle span
    for off, width, rows, stride in maps.tolist():
        assert off % n == 0 and (off * 2) % 16 == 0
        assert 0 <= off and off + width * n <= plan.stash_cols * n
        assert rows == n and stride == width * 2 and stride % 16 == 0
    assert jobs.shape[1] == fused_mlp._JOB_WORDS
    for chunk, a_map, i0, n_a, g_map, n_g, dw_off, k_in, n_out in jobs.tolist():
        assert 0 <= chunk < plan.n_chunks
        assert 0 <= a_map < len(maps) and 0 <= g_map < len(maps)
        assert i0 + (n_a - 1) * 64 < maps[a_map][1] and k_in <= maps[a_map][1]
        assert (n_g - 1) * 64 < maps[g_map][1] and n_out <= maps[g_map][1]
        assert 1 <= n_a <= 2 and 1 <= n_g <= 4


@pytest.mark.parametrize("which,n", _cases())
def test_wgrad_panels_of_a_dw_run_side_by_side(which, n):
    """The two panels of every dW of more than 128 rows on one chunk (rows
    0 and 128, the same G) are one cluster, jobs 2i and 2i + 1, so the
    second finds G in L2; every panel of every dW runs once per chunk."""
    spec, kp = _program(which)
    plan = fused_mlp.pack_bwd_program(spec, kp, n)
    jobs = plan.tasks.tolist()
    want = sorted((c, off, i0) for c in range(plan.n_chunks) for *_, k, _, off in plan.dws
                  for i0 in range(0, k, 128))
    assert sorted((j[0], j[6], j[2]) for j in jobs) == want
    for idx, job in enumerate(jobs):
        if job[2] == 128:
            first = jobs[idx - 1]
            assert idx % 2 == 1 and first[2] == 0
            assert (first[0], first[6], first[4]) == (job[0], job[6], job[4])


def test_wgrad_plan_refuses_more_maps_than_the_kernel_holds():
    """A plan that reads more stash slots than the kernel's parameter holds
    tensor maps raises instead of launching."""
    k = fused_mlp._WGRAD_MAX_MAPS + 1
    dws = [(s * 16, 16, s * 16 + 16, 16, 16, 16, s * 256) for s in range(0, 2 * k, 2)]
    with pytest.raises(ValueError, match="tensor maps"):
        fused_mlp._wgrad_plan(dws, 100)
    assert len(fused_mlp._wgrad_plan(dws[: k // 2], 100).maps) == 2 * (k // 2)


@pytest.mark.parametrize("which,n", _cases())
def test_wgrad_chunks_fill_the_card(which, n):
    """Chunks of a multiple of 64 rows, none empty, the last ragged only at
    n_rows; at least two waves of one CTA a SM where the rows allow."""
    spec, kp = _program(which)
    plan = fused_mlp.pack_bwd_program(spec, kp, n)
    assert plan.chunk_rows % 64 == 0
    assert (plan.n_chunks - 1) * plan.chunk_rows < n <= plan.n_chunks * plan.chunk_rows
    assert len(plan.tasks) >= 2 * fused_mlp._SMS
    assert {j[0] for j in plan.tasks.tolist()} == set(range(plan.n_chunks))


def test_wgrad_shared_memory_and_kernel_constants():
    """The ring fits a Hopper block, the tensor maps the kernel's
    parameters, and the Python constants are the header's."""
    text = (CSRC / "fused_mlp_wgrad_sm90.cuh").read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)[;,]", text).group(1))

    assert const("kStages") == fused_mlp._WGRAD_STAGES
    assert const("kBox") == fused_mlp._WBOX
    assert const("kJobWords") == fused_mlp._JOB_WORDS
    assert const("kMaxMaps") == fused_mlp._WGRAD_MAX_MAPS
    # The maps ride in the kernel's parameters: 128 bytes each, under the
    # 32,764 bytes CUDA 12.1 allows, beside a few words of the rest.
    assert fused_mlp._WGRAD_MAX_MAPS * 128 + 64 <= 32_764
    assert (const("kMaxA") + const("kMaxG")) * fused_mlp._WBOX_BYTES * const("kStages") + \
        2 * const("kStages") * 8 == fused_mlp._WGRAD_SMEM
    assert fused_mlp._WGRAD_SMEM <= fused_mlp._SMEM_LIMIT == 227 * 1024


SUM_SHAPES = [(1, 6144, 3076), (1, 2048, 9228), (1, 19, 589_312), (1, 9, 1_677_696),
              (4096, 192, 128), (8192, 64, 128),  # the step's six sums
              (1, 6181, 3076), (3, 191, 130), (2, 1, 12), (5, 40, 7), (1, 0, 8), (1, 33, 4)]


@pytest.mark.parametrize("shape", SUM_SHAPES)
def test_colsum_slices_cover_every_row_once(shape):
    """The slices `colsum` in csrc/fused_mlp_bwd.cu makes of L rows (ranges
    of ceil(L / slices) rows) are not empty and cover each row once; the
    partials sums split, the others stay whole; the scratch holds them."""
    S, L, C = shape
    slices, per = fused_mlp._colsum_slices(S, L, C)
    assert per == (-(-L // slices) if L else 0)
    rows = [i for sl in range(slices) for i in range(sl * per, min(L, (sl + 1) * per))]
    assert rows == list(range(L))
    assert all(sl * per < L for sl in range(slices)) or L == 0
    assert slices == 1 or per >= fused_mlp._COLSUM_MIN_ROWS
    if slices > 1:
        assert fused_mlp._colsum_scratch([shape]) >= S * slices * C
    if shape in SUM_SHAPES[:6]:
        assert (slices > 1) == (S == 1 and L >= 2048)
