"""The launch plans of kernels K-B4 (the fused shrink step), K-B5 (the
fused TV gradient map) and K-B8 (the planar whole solve), which the
wrappers compute on the host and the CUDA kernels obey: every shape lands
on one route, and every element (K-B4) or row (K-B5, K-B8) is covered
exactly once.  The plans are pure functions of
the shape and the card's SM count, so they are held here, on the CPU, at
the H100's 132 SMs and at others."""

import numpy as np
import pytest
import torch

from fasta_tpu_torch.kernels import microsolver_planar, prox_fused, tv_fused
from fasta_tpu_torch.kernels.microsolver_planar import tile_plan
from fasta_tpu_torch.kernels.prox_fused import shrink_plan
from fasta_tpu_torch.kernels.tv_fused import tv_plan

SMS = 132


def _walk_counts(plan, n):
    """How often each element of one row is visited by the grid's walk
    (csrc/prox_fused.cu, ``walk``): thread position p of the row's
    ``grid[0]·threads`` takes vectors p, p + stride, … of the row's whole
    float4s, then scalars 4·⌊n/4⌋ + p, … of the tail (the scalar route
    visits scalars alike)."""
    stride = plan.grid[0] * plan.threads
    counts = np.zeros(n, np.int64)
    nq = n // 4
    for pos in range(stride):
        for q in range(pos, nq, stride):
            counts[4 * q:4 * q + 4] += 1
        for j in range(4 * nq + pos, n, stride):
            counts[j] += 1
    return counts


@pytest.mark.parametrize("R,n", [
    (1, 1), (1, 100), (1, 2000), (32, 2000), (3, 37), (300, 5),
    (1, prox_fused.ROW_MAX_N - 1), (1, prox_fused.ROW_MAX_N),
    (1, prox_fused.ROW_MAX_N + 1), (1, 1 << 24), (7, 100003),
    (65535, 2000), (65535, 1 << 20)])
def test_shrink_plan_puts_every_shape_on_one_route(R, n):
    plan = shrink_plan(R, n, SMS)
    assert plan.route in ("row", "stream")
    assert plan.grid[1] == R and plan.grid[0] >= 1
    if plan.route == "row":
        assert plan.grid[0] == 1 and plan.scratch_doubles == 0
        assert plan.threads == prox_fused.ROW_THREADS
    else:
        # a ticket and three partials a block; the grid sized to the card
        # and no block without work
        assert plan.scratch_doubles == 1 + 3 * R * plan.grid[0]
        assert plan.grid[0] * R <= prox_fused.STREAM_BLOCKS_PER_SM * SMS
        assert (plan.grid[0] - 1) * plan.threads < -(-n // 4)


@pytest.mark.parametrize("R,n", [(1, 37), (1, 2000), (2, 2048), (3, 4099)])
def test_shrink_plan_walk_covers_every_element_once(R, n, monkeypatch):
    # shrink the row route's reach so that small rows take the stream route
    monkeypatch.setattr(prox_fused, "ROW_MAX_N", 1)
    for sms in (1, 2, 8):
        plan = shrink_plan(R, n, sms)
        assert np.all(_walk_counts(plan, n) == 1), (plan, sms)
    row = shrink_plan(R, 1, 1)
    assert row.route == "row" and np.all(_walk_counts(row, 1) == 1)


def test_shrink_plan_route_boundaries():
    """Rows up to ROW_MAX_N take the row route; one more element takes
    the stream route, unless the rows alone already give every block at
    most one row's share."""
    edge = prox_fused.ROW_MAX_N
    assert [shrink_plan(1, n, SMS).route for n in (edge - 1, edge, edge + 1)] \
        == ["row", "row", "stream"]
    cap = prox_fused.STREAM_BLOCKS_PER_SM * SMS
    long_row = 1 << 22
    assert shrink_plan(cap // 2, long_row, SMS).route == "stream"
    assert shrink_plan(cap // 2, long_row, SMS).grid[0] == 2
    assert shrink_plan(cap // 2 + 1, long_row, SMS).route == "row"
    # a row just long enough for two blocks of the stream route
    two = prox_fused.STREAM_THREADS * prox_fused.UNROLL * 4
    assert shrink_plan(1, max(two, edge) + 4, SMS).grid[0] >= 2


@pytest.mark.parametrize("R,n", [(0, 10), (1, 0), (0, 0), (65536, 10),
                                 (-1, 5)])
def test_shrink_plan_refuses_what_the_kernel_does_not_take(R, n):
    with pytest.raises(ValueError, match="R <= 65535"):
        shrink_plan(R, n, SMS)


def test_shrink_plan_takes_the_largest_row_count():
    assert shrink_plan(65535, 1, SMS).route == "row"
    assert shrink_plan(65535, 1 << 16, SMS).grid == (1, 65535)


def test_shrink_plan_gives_the_loops_rows_a_block_each():
    """A LASSO trial (1×2000) and a serving batch trial (32×2000): one
    block a row, no scratch, a vector a thread."""
    assert shrink_plan(1, 2000, SMS) == ("row", (1, 1),
                                         prox_fused.ROW_THREADS, 0)
    assert shrink_plan(32, 2000, SMS).grid == (1, 32)
    assert 4 * prox_fused.ROW_THREADS >= 2000


def test_shrink_params_by_value_or_on_the_card():
    """τ and μ reach the kernel as a value (numbers, one-value CPU
    tensors) or as a pointer with their mode; a wrong count raises."""
    cpu = torch.device("cpu")
    assert prox_fused._param(0.25, 4, cpu, "tau") == (None, None, 0.25, 0)
    assert prox_fused._param(torch.tensor(0.5), 4, cpu, "mu")[1:] == \
        (None, 0.5, 0)
    with pytest.raises(ValueError, match="tau holds 3 values for 4 rows"):
        prox_fused._param(torch.ones(3), 4, cpu, "tau")


def _tv_rows(plan, H):
    """Rows each band writes and rows whose r it computes (csrc/tv_fused.cu:
    rows r0 … min(r1, H − 1), writing r0 … r1 − 1)."""
    written, computed = [], []
    for r0, r1 in plan.bands:
        written += range(r0, r1)
        computed.append(list(range(r0, min(r1, H - 1) + 1)))
    return written, computed


@pytest.mark.parametrize("H,W", [(1, 1), (1, 7), (7, 1), (512, 512),
                                 (509, 517), (2049, 33), (130, 70),
                                 (3, 100000), (4096, 4096)])
def test_tv_plan_covers_every_row_once_with_one_halo_row(H, W):
    for sms in (1, SMS):
        plan = tv_plan(H, W, sms)
        assert plan.threads in (32, 64, 128, 256)
        cw = 4 * plan.threads
        assert plan.strips * cw >= W > (plan.strips - 1) * cw
        assert 1 <= len(plan.bands) <= min(H, tv_fused.MAX_BANDS)
        nb = len(plan.bands)
        # the kernel's own band formula
        assert plan.bands == tuple((k * H // nb, (k + 1) * H // nb)
                                   for k in range(nb))
        written, computed = _tv_rows(plan, H)
        assert written == list(range(H))
        for (r0, r1), rows in zip(plan.bands, computed):
            assert r1 > r0
            halo = [r for r in rows if r >= r1]
            assert halo == ([r1] if r1 < H else [])
        blocks = plan.strips * nb
        assert plan.scratch_doubles == (0 if blocks == 1 else 1 + blocks)


def test_tv_plan_sizes_to_the_card():
    main = tv_plan(512, 512, SMS)
    assert main.strips == 1 and main.threads == 128
    assert len(main.bands) == 512 // tv_fused.MIN_BAND_ROWS
    big = tv_plan(4096, 4096, SMS)
    assert big.threads == tv_fused.MAX_THREADS and big.strips == 4
    assert big.strips * len(big.bands) == tv_fused.BLOCKS_PER_SM * SMS
    assert tv_plan(1, 1, SMS).scratch_doubles == 0


@pytest.mark.parametrize("H,W,sms", [(0, 4, 1), (4, 0, 1), (4, 4, 0)])
def test_tv_plan_refuses_empty_shapes(H, W, sms):
    with pytest.raises(ValueError, match="tv_plan needs"):
        tv_plan(H, W, sms)


# --------------------------------------------------------------------------
# K-B8's tile plan: which rows of the channel matrices each block keeps on
# the chip, and which kernel runs
# --------------------------------------------------------------------------

# The H100's shared memory for rows a block of each kernel has
# (microsolver_planar.row_budget at the H100's opt-in and static shared
# memory, which a card test holds against the card's own numbers).
_budget = microsolver_planar.row_budget


def test_row_budget_counts_the_state_of_each_kernel():
    """The budget is the opt-in less the static shared memory and the
    block's state: 14 vectors of 2·n4 floats up to WIDE_N, 6 + R − 1 up
    to STATE_MAX_N, the wide kernel's one past it, none on the column
    fallback."""
    rb = microsolver_planar.row_budget
    assert rb(256, 100000, 1000) == 100000 - 1000 - 8 * 256 * 14
    assert rb(512, 100000, 1000) == 100000 - 1000 - 8 * 512 * 14
    assert rb(516, 100000, 1000) == 100000 - 1000 - 8 * 516 * (6 + 2)
    assert rb(1024, 100000, 1000) == 100000 - 1000 - 8 * 1024 * (6 + 1)
    assert rb(2048, 200000, 1000) == 200000 - 1000 - 8 * 2048 * 6
    assert rb(2052, 100000, 1000) == 100000 - 1000 - 8 * 2052
    assert rb(8192, 100000, 1000) == 100000 - 1000 - 8 * 8192
    assert rb(8196, 100000, 1000) == 0
    assert rb(2048, 50000, 1000) == 0
    optin = microsolver_planar.H100_SMEM_OPTIN
    static = microsolver_planar.H100_STATIC_SMEM
    assert rb(256) == optin - static[0] - 8 * 256 * 14
    assert rb(1024) == optin - static[1] - 8 * 1024 * 7
    assert rb(4096) == optin - static[2] - 8 * 4096
    for n4 in (0, 6, -4):
        with pytest.raises(ValueError, match="row_budget"):
            rb(n4)


@pytest.mark.parametrize("m,n4,nblocks,budget", [
    (16384, 256, SMS, None), (8192, 640, SMS, None), (1, 4, SMS, None),
    (100, 8, SMS, 0), (4099, 256, 7, 10000), (2048, 1024, SMS, 3 * 8192),
    (37, 512, 64, 4096), (12288, 512, SMS, None), (256, 8192, SMS, 65536)])
def test_tile_plan_places_every_row_once(m, n4, nblocks, budget):
    budget = _budget(n4) if budget is None else budget
    plan = tile_plan(m, n4, nblocks, budget)
    assert plan.kernel in ("rows", "wide") and len(plan.bands) == nblocks
    # contiguous bands over all m rows, the kernel's own formula
    assert plan.bands == tuple((k * m // nblocks, (k + 1) * m // nblocks)
                               for k in range(nblocks))
    placed = np.zeros(m, np.int64)
    where = np.zeros(m, np.int64)     # 1 registers, 2 shared, 3 streamed
    for (r0, r1), g, s in zip(plan.bands, plan.reg_rows, plan.smem_rows):
        assert 0 <= g and 0 <= s and g + s <= r1 - r0
        placed[r0:r1] += 1
        where[r0:r0 + g] = 1
        where[r0 + g:r0 + g + s] = 2
        where[r0 + g + s:r1] = 3
        # the shared-memory rows within the budget
        assert s * 8 * n4 <= budget
        # registers hold a band's first rows, up to REG_N columns only
        want = min(r1 - r0, microsolver_planar.REG_ROWS) \
            if n4 <= microsolver_planar.REG_N else 0
        assert g == want
        # a block streams rows only when its shared memory is full
        if r1 - r0 > g + s:
            assert (s + 1) * 8 * n4 > budget
    assert np.all(placed == 1)
    streamed = int((where == 3).sum())
    assert plan.streamed_rows == streamed
    assert plan.route == ("streamed" if streamed else "resident")
    assert plan.streamed_bytes == 8 * n4 * streamed
    assert plan.resident_share == pytest.approx(1 - streamed / m)


def test_tile_plan_route_boundaries():
    """n4 = 512 is the last width of the route whose blocks hold the
    n-sized state, 516 the first of the wide route; 8192 the last of the
    wide route, 8196 the column fallback; registers hold rows up to 256
    columns."""
    WIDE_N, WIDE_MAX_N = microsolver_planar.WIDE_N, \
        microsolver_planar.WIDE_MAX_N
    assert (WIDE_N, WIDE_MAX_N) == (512, 8192)
    kernels = [tile_plan(2048, n4, SMS, _budget(n4)).kernel
               for n4 in (256, 260, WIDE_N, WIDE_N + 4, WIDE_MAX_N,
                          WIDE_MAX_N + 4)]
    assert kernels == ["rows", "rows", "rows", "wide", "wide", "columns"]
    assert max(tile_plan(2048, 256, SMS, _budget(256)).reg_rows) == 16
    assert max(tile_plan(8192, 256, SMS, _budget(256)).reg_rows) == 32
    assert max(tile_plan(8192, 260, SMS, _budget(260)).reg_rows) == 0
    cols = tile_plan(300, 9000, SMS, 0)
    assert (cols.route, cols.bands, cols.streamed_rows) == ("columns", (),
                                                            300)
    assert cols.streamed_bytes == 2 * 8 * 9000 * 300
    assert cols.resident_share == 0.0
    # the route agrees with the wrappers' width test
    for n in (512, 513, 516):
        assert microsolver_planar._wide(n) == (
            tile_plan(64, (n + 3) // 4 * 4, SMS, 1 << 16).kernel != "rows")


@pytest.mark.parametrize("m,n,kernel,route", [
    (16384, 256, "rows", "resident"), (2048, 1024, "wide", "resident"),
    (8192, 640, "wide", "streamed"), (256, 8192, "wide", "resident"),
    (2048, 516, "wide", "resident")])
def test_tile_plan_on_the_h100_keeps_the_main_shapes_on_the_chip(m, n,
                                                                 kernel,
                                                                 route):
    """At the H100's 132 SMs and its shared memory: 16384×256 keeps all
    its rows on the chip (32 a block in registers, the rest of its 124 or
    125 in shared memory), 2048×1024 and 256×8192 too (two rows of 64 KB a
    block), 8192×640 more than half (62–63 rows of 5 KB a block beside the
    n-sized state)."""
    plan = tile_plan(m, n, SMS, _budget(n))
    assert (plan.kernel, plan.route) == (kernel, route)
    if route == "streamed":
        assert 0.5 < plan.resident_share < 0.75
        assert plan.streamed_bytes == 8 * n * plan.streamed_rows


@pytest.mark.parametrize("m,n4,nblocks,budget", [
    (0, 256, SMS, 1000), (16, 0, SMS, 1000), (16, 6, SMS, 1000),
    (16, 256, 0, 1000), (16, 256, SMS, -1), (1 << 20, 1 << 12, SMS, 0)])
def test_tile_plan_refuses_empty_or_impossible_shapes(m, n4, nblocks,
                                                      budget):
    with pytest.raises(ValueError, match="tile_plan"):
        tile_plan(m, n4, nblocks, budget)
