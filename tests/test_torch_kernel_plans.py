"""The launch plans of kernels K-B1 (the dense whole solve), K-B4 (the
fused shrink step), K-B5 (the fused TV gradient map), K-B7 (the fused
planar gradient map) and K-B8 (the planar whole solve), which the wrappers
compute on the host and the CUDA kernels obey: every shape lands on one
route, and every element (K-B4) or row (K-B1, K-B5, K-B7, K-B8) is covered
exactly once.  The plans are pure functions of
the shape and the card's SM count, so they are held here, on the CPU, at
the H100's 132 SMs and at others."""

import numpy as np
import pytest
import torch

from fasta_tpu_torch.kernels import (microsolver, microsolver_planar,
                                     planar_fused, prox_fused, tv_fused)
from fasta_tpu_torch.kernels.microsolver import dense_plan
from fasta_tpu_torch.kernels.planar_fused import gradmap_plan
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


# --------------------------------------------------------------------------
# K-B1's dense plan: the rows each block keeps on the chip
# --------------------------------------------------------------------------

_dense_budget = microsolver.dense_budget


def test_dense_lanes_spread_a_row_over_whole_warps():
    """A row takes its float4 slots rounded up to a warp (at most 512
    threads), the block's other threads are further row lanes, and a
    thread takes 1, 2 or 4 slots (the instantiations)."""
    lanes = microsolver.dense_lanes
    assert lanes(4) == (32, 16, 1) and lanes(16) == (32, 16, 1)
    assert lanes(100) == (32, 16, 1) and lanes(500) == (128, 4, 1)
    assert lanes(1000) == (256, 2, 1) and lanes(2000) == (512, 1, 1)
    assert lanes(2048) == (512, 1, 1) and lanes(2052) == (512, 1, 2)
    assert lanes(4096) == (512, 1, 2) and lanes(6000) == (512, 1, 4)
    assert lanes(8192) == (512, 1, 4)
    for n4 in range(4, 8196, 4):
        tg, R, S = lanes(n4)
        assert tg % 32 == 0 and tg * R <= 512 and tg * S >= n4 // 4


def test_dense_budget_counts_the_state_of_the_row_kernel():
    """The budget is the opt-in less the static shared memory and the
    block's state: x and g twice, x_acc and the R − 1 other row lanes'
    shares, n4 floats each; none past STATE_MAX_N or where the state
    alone does not fit."""
    db = microsolver.dense_budget
    assert db(16, 100000, 1000) == 100000 - 1000 - 4 * 16 * (4 + 16)
    assert db(500, 100000, 1000) == 100000 - 1000 - 4 * 500 * (4 + 4)
    assert db(1000, 100000, 1000) == 100000 - 1000 - 4 * 1000 * (4 + 2)
    assert db(2000, 100000, 1000) == 100000 - 1000 - 4 * 2000 * 5
    assert db(8192, 200000, 1000) == 200000 - 1000 - 4 * 8192 * 5
    assert db(8196, 200000, 1000) == 0
    assert db(8192, 100000, 1000) == 0
    optin, static = microsolver.H100_SMEM_OPTIN, microsolver.H100_STATIC_SMEM
    assert db(2000) == optin - static - 4 * 2000 * 5
    for n4 in (0, 6, -4):
        with pytest.raises(ValueError, match="dense_budget"):
            db(n4)


@pytest.mark.parametrize("m,n4,nblocks,budget", [
    (1000, 2000, SMS, None), (1000, 500, SMS, None), (800, 100, SMS, None),
    (500, 1000, SMS, None), (6000, 1000, SMS, None), (1000, 6000, SMS, None),
    (128, 16, SMS, None), (1, 4, SMS, None), (6000, 1000, SMS, 0),
    (6000, 1000, SMS, 50000), (4099, 256, 7, 10000), (37, 8192, 64, 4096),
    (1500000, 4, SMS, None)])
def test_dense_plan_places_every_row_once(m, n4, nblocks, budget):
    budget = _dense_budget(n4) if budget is None else budget
    plan = dense_plan(m, n4, nblocks, budget)
    assert plan.kernel == "rows" and len(plan.bands) == nblocks
    # contiguous bands over all m rows, the kernel's own formula
    assert plan.bands == tuple((k * m // nblocks, (k + 1) * m // nblocks)
                               for k in range(nblocks))
    _, R, S = microsolver.dense_lanes(n4)
    placed = np.zeros(m, np.int64)
    where = np.zeros(m, np.int64)     # 1 registers, 2 shared, 3 streamed
    for (r0, r1), g, s in zip(plan.bands, plan.reg_rows, plan.smem_rows):
        assert 0 <= g and 0 <= s and g + s <= r1 - r0
        placed[r0:r1] += 1
        where[r0:r0 + g] = 1
        where[r0 + g:r0 + g + s] = 2
        where[r0 + g + s:r1] = 3
        assert s * 4 * n4 <= budget
        # registers hold a band's first step of rows, at one slot a thread
        assert g == (min(r1 - r0, 8 * R) if S == 1 else 0)
        # a block streams rows only when its shared memory is full
        if r1 - r0 > g + s:
            assert (s + 1) * 4 * n4 > budget
    assert np.all(placed == 1)
    streamed = int((where == 3).sum())
    assert plan.streamed_rows == streamed
    assert plan.route == ("streamed" if streamed else "resident")
    assert plan.streamed_bytes == 4 * n4 * streamed
    assert plan.resident_share == pytest.approx(1 - streamed / m)


def test_dense_plan_gives_empty_bands_nothing():
    """128 rows over 132 blocks: four blocks own no row, keep none, and
    the other bands hold one row each, in registers."""
    plan = dense_plan(128, 16, SMS, _dense_budget(16))
    sizes = [r1 - r0 for r0, r1 in plan.bands]
    assert sizes.count(0) == 4 and sizes.count(1) == 128
    assert all(g == r1 - r0 and s == 0 for (r0, r1), g, s in
               zip(plan.bands, plan.reg_rows, plan.smem_rows))
    assert plan.route == "resident" and plan.streamed_bytes == 0


def test_dense_plan_route_boundaries():
    """n4 = 8192 is the last width of the row kernel, 8196 the column
    fallback; registers hold rows up to 2048 columns (one slot a
    thread)."""
    assert microsolver.STATE_MAX_N == 8192
    kernels = [dense_plan(500, n4, SMS, _dense_budget(n4)).kernel
               for n4 in (4, 2048, 2052, 8192, 8196)]
    assert kernels == ["rows", "rows", "rows", "rows", "columns"]
    assert max(dense_plan(2000, 2048, SMS, 0).reg_rows) == 8
    assert max(dense_plan(2000, 2052, SMS, 1 << 20).reg_rows) == 0
    assert max(dense_plan(8000, 500, SMS, 0).reg_rows) == 32
    cols = dense_plan(100, 60000, SMS, 0)
    assert (cols.route, cols.bands, cols.streamed_rows) == ("columns", (),
                                                            100)
    assert cols.streamed_bytes == 2 * 4 * 60000 * 100
    assert cols.resident_share == 0.0


@pytest.mark.parametrize("m,n,route", [
    (1000, 2000, "resident"), (1000, 500, "resident"),
    (800, 100, "resident"), (500, 1000, "resident"),
    (6000, 1000, "resident"), (1000, 6000, "streamed"),
    (100, 60000, "columns")])
def test_dense_plan_on_the_h100_keeps_the_main_shapes_on_the_chip(m, n,
                                                                  route):
    """At the H100's 132 SMs and its shared memory: LASSO 1000×2000,
    NNLS and logistic 1000×500, SVM 800×100 and 500×1000 keep every row
    in registers; 6000×1000 keeps 16 rows a block in registers and the
    rest of its 45–46 in shared memory; 1000×6000, at the gate, streams
    what does not fit beside the n-sized state; 100×60000 takes the
    column fallback."""
    n4 = (n + 3) // 4 * 4
    plan = dense_plan(m, n4, SMS, _dense_budget(n4))
    assert plan.route == route
    if (m, n) in ((1000, 2000), (1000, 500), (800, 100), (500, 1000)):
        assert sum(plan.smem_rows) == 0 and sum(plan.reg_rows) == m
    if route == "streamed":
        assert 0.4 < plan.resident_share < 0.75


def _gate_shapes():
    """Shapes at and below the reference's 24 MB gate: for widths from 1
    to 6·2²⁰ the tallest m the gate admits, and a quarter of it."""
    cap = (24 << 20) // 4
    widths = sorted({1, 3, 4, 5, 16, 100, 500, 513, 1000, 2000, 2047, 2048,
                     2049, 4096, 6000, 8189, 8192, 8193, 8196, 20000,
                     60000, 1 << 20, cap} | {int(1.6 ** k) for k in
                                             range(34)})
    return [(m, n) for n in widths if n <= cap
            for m in {max(1, cap // n), max(1, cap // n // 4)}]


def test_every_shape_the_gate_admits_has_a_plan_on_the_h100():
    """Every shape inside ``supports_microsolver``'s 24 MB gate has a plan
    at the H100's budget whose shared memory fits the opt-in; the widths
    that fit beside the state take the row kernel."""
    optin, static = microsolver.H100_SMEM_OPTIN, microsolver.H100_STATIC_SMEM
    for m, n in _gate_shapes():
        assert microsolver.supports_microsolver(m, n)
        n4 = (n + 3) // 4 * 4
        plan = dense_plan(m, n4, SMS, _dense_budget(n4))
        if n4 > microsolver.STATE_MAX_N:
            assert plan.kernel == "columns", (m, n)
            continue
        R = microsolver.dense_lanes(n4)[1]
        dyn = 4 * n4 * (4 + R) + 4 * n4 * max(plan.smem_rows)
        assert plan.kernel == "rows" and static + dyn <= optin, (m, n)
    assert not microsolver.supports_microsolver(1000, 6292)


@pytest.mark.parametrize("m,n4,nblocks,budget", [
    (0, 256, SMS, 1000), (16, 0, SMS, 1000), (16, 6, SMS, 1000),
    (16, 256, 0, 1000), (16, 256, SMS, -1), (1 << 20, 1 << 12, SMS, 0)])
def test_dense_plan_refuses_empty_or_impossible_shapes(m, n4, nblocks,
                                                       budget):
    with pytest.raises(ValueError, match="dense_plan"):
        dense_plan(m, n4, nblocks, budget)


# --------------------------------------------------------------------------
# K-B7's plan: one kernel a call over whole clusters of blocks
# --------------------------------------------------------------------------

# cluster slots of the H100 (cudaOccupancyMaxActiveClusters, clusters of
# 8 blocks of 512 threads): 15 at one block an SM, 30 at two
H100_SLOTS = (15, 30)


def _gradmap_rows(plan, m):
    """How often the kernel's grid-stride walk (csrc/planar_fused.cu)
    visits each row: route 1 warp w of block k rows k·WARPS + w, + blocks·
    WARPS, …; route 2 block k rows k, k + blocks, …; route 3 block k tiles
    k, k + blocks, … of tile_rows rows.  Returns (visits, rows a block)."""
    visits = np.zeros(m, np.int64)
    per_block = np.zeros(plan.blocks, np.int64)
    for k in range(plan.blocks):
        if plan.route == 1:
            for w in range(planar_fused.WARPS):
                rows = np.arange(k * planar_fused.WARPS + w, m,
                                 plan.blocks * planar_fused.WARPS)
                visits[rows] += 1
                per_block[k] += rows.size
        elif plan.route == 2:
            rows = np.arange(k, m, plan.blocks)
            visits[rows] += 1
            per_block[k] = rows.size
        else:
            ntiles = -(-m // plan.tile_rows)
            for t in range(k, ntiles, plan.blocks):
                r0 = t * plan.tile_rows
                visits[r0:min(m, r0 + plan.tile_rows)] += 1
                per_block[k] += min(m, r0 + plan.tile_rows) - r0
    return visits, per_block


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("slots", H100_SLOTS + (1, 7))
@pytest.mark.parametrize("m,n", [
    (16384, 256), (1000, 37), (4099, 256), (5, 3), (1, 1), (1000, 1024),
    (300, 2046), (40, 9000), (33, 3001), (16384, 4096), (1024, 16384),
    (64, 9000), (1000, 511), (1000, 512), (7, 8193), (129, 8)])
def test_gradmap_plan_places_every_row_once(m, n, slots, bf16):
    """Every row once on every route; the grid a whole number of clusters,
    no more than the card holds at once, and no whole cluster without
    rows; the scratch holds the ticket, the clusters' f partials and,
    16-byte aligned, their gradient partials (and route 3's block rows)."""
    plan = gradmap_plan(m, n, bf16, slots)
    C = planar_fused.CLUSTER
    assert plan.blocks % C == 0 and C <= plan.blocks <= C * slots
    visits, per_block = _gradmap_rows(plan, m)
    assert np.all(visits == 1)
    clusters = plan.blocks // C
    assert per_block.reshape(clusters, C).sum(axis=1).min() >= 1
    if plan.route != 3 and plan.blocks < C * slots:
        # fewer clusters only for want of rows
        rows = planar_fused.WARPS if plan.route == 1 else 1
        assert plan.blocks == C * -(-m // (rows * C))
    head = (clusters + 2) & ~1        # doubles: ticket, f partials, pad
    assert head % 2 == 0 and head >= 1 + clusters
    floats = 2 * n * (clusters + (plan.blocks if plan.route == 3 else 0))
    assert 2 * (plan.scratch_doubles - head) >= floats
    assert 2 * (plan.scratch_doubles - head) - floats <= 1
    if plan.route == 3:
        assert 1 <= plan.tile_rows <= planar_fused.WIDE_TILE
        # the tiles as even as the tile size allows
        rounds = -(-m // (plan.blocks * planar_fused.WIDE_TILE))
        assert per_block.max() <= rounds * plan.tile_rows
    else:
        assert plan.tile_rows == 1


@pytest.mark.parametrize("bf16,edges", [
    # (n, route, vec, cpt) at each boundary: 16-byte rows take 512 columns
    # a warp and 8192 a block; other rows 512 and 2048, a value a group
    (False, [(4, 1, 4, 1), (128, 1, 4, 1), (132, 1, 4, 2), (512, 1, 4, 4),
             (516, 2, 4, 1), (2048, 2, 4, 1), (2052, 2, 4, 2),
             (8192, 2, 4, 4), (8196, 3, 4, 0), (511, 1, 1, 16),
             (513, 2, 1, 2), (2047, 2, 1, 4), (2049, 3, 1, 0),
             (37, 1, 1, 2), (3, 1, 1, 1)]),
    (True, [(8, 1, 8, 1), (256, 1, 8, 1), (264, 1, 8, 2), (512, 1, 8, 2),
            (520, 2, 8, 1), (4096, 2, 8, 1), (4104, 2, 8, 2),
            (8192, 2, 8, 2), (8200, 3, 8, 0), (516, 2, 1, 2),
            (2044, 2, 1, 4), (2052, 3, 1, 0), (500, 1, 1, 16)])])
def test_gradmap_plan_route_boundaries(bf16, edges):
    for n, route, vec, cpt in edges:
        plan = gradmap_plan(1000, n, bf16, 30)
        assert (plan.route, plan.vec, plan.cpt) == (route, vec, cpt), n
        # route 1 the warps' shares and the block's; route 2 the block's
        assert plan.smem_bytes == 4 * 2 * n * {1: 17, 2: 1, 3: 0}[route]


def test_gradmap_plan_on_the_h100_main_shapes():
    """The phase-retrieval loop's 16384×256 takes route 1 on 30 clusters
    of 8 (two blocks an SM), 16384×4096 route 2 on 30, 1024×16384 in
    bfloat16 route 3 on 15 (one block an SM) with tiles of 5 rows."""
    loop = gradmap_plan(16384, 256, False, 30)
    assert (loop.route, loop.vec, loop.cpt, loop.blocks) == (1, 4, 2, 240)
    big = gradmap_plan(16384, 4096, False, 30)
    assert (big.route, big.cpt, big.blocks) == (2, 2, 240)
    wide = gradmap_plan(1024, 16384, True, 15)
    assert (wide.route, wide.vec, wide.blocks, wide.tile_rows) == \
        (3, 8, 104, 5)
    # 5 rows a tile: 205 tiles, at most two a block (10 rows), where 8-row
    # tiles on 15 clusters would leave 8 blocks 16
    assert _gradmap_rows(wide, 1024)[1].max() == 10


@pytest.mark.parametrize("m,n,slots", [(0, 256, 30), (16, 0, 30),
                                       (16, 256, 0), (-1, 4, 30)])
def test_gradmap_plan_refuses_empty_shapes(m, n, slots):
    with pytest.raises(ValueError, match="gradmap_plan"):
        gradmap_plan(m, n, False, slots)
