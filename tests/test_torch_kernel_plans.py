"""The launch plans of kernels K-B1 (the dense whole solve), K-B3 / K-B3p
(the fused gradient maps), K-B4 (the fused shrink step), K-B5 (the fused
TV gradient map), K-B7 (the fused planar gradient map), K-B8 (the planar
whole solve) and the probes K-P3 (the tail ladder), K-P4 (the
bfloat16-storage probe) and K-P1's gradmap form, which the wrappers
compute on the host and the CUDA kernels obey: every shape lands on one
route, and every element (K-B4) or row (K-B1, K-B3, K-B5, K-B7, K-B8,
K-P3, K-P4, K-P1) is covered exactly once.  The plans are pure functions of
the shape and the card's SM count, so they are held here, on the CPU, at
the H100's 132 SMs and at others."""

import numpy as np
import pytest
import torch

from fasta_tpu_torch.kernels import (bf16_probe, lstsq_fused, matvec_probe,
                                     microsolver, microsolver_planar,
                                     planar_fused, prox_fused, tail_probe,
                                     tv_fused)
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


# --------------------------------------------------------------------------
# K-B3's plan: one kernel a call, routes by row width
# --------------------------------------------------------------------------

# slots of the H100 (132 SMs): routes 1 and 2 BLOCKS_PER_SM blocks an SM;
# route 3 at 16384 float32 columns one 192 KB block an SM; route 4 the SMs
B3_ROW_SLOTS = lstsq_fused.BLOCKS_PER_SM * SMS


def _b3_rows(plan, m):
    """How often the kernel's walk (csrc/lstsq_fused.cu) visits each row:
    routes 1 and 2 block k steps k, k + blocks, … of R·tr rows, group r <
    R the tr rows from r·tr in each (tr = tile_rows);
    route 3 cluster c tiles c, c + clusters, …; route 4 block k tiles k,
    k + blocks, ….  Returns (visits, rows a block — a cluster on route
    3)."""
    visits = np.zeros(m, np.int64)
    if plan.route in (1, 2):
        R = plan.threads // (32 if plan.route == 1 else plan.threads)
        step, tr = R * plan.tile_rows, plan.tile_rows
        per = np.zeros(plan.blocks, np.int64)
        for k in range(plan.blocks):
            for base in range(k * step, m, plan.blocks * step):
                for r in range(R):
                    rows = np.arange(base + r * tr, min(m, base + r * tr + tr))
                    visits[rows] += 1
                    per[k] += rows.size
        return visits, per
    parts = plan.blocks // plan.cluster
    per = np.zeros(parts, np.int64)
    ntiles = -(-m // plan.tile_rows)
    for c in range(parts):
        for t in range(c, ntiles, parts):
            r0 = t * plan.tile_rows
            visits[r0:min(m, r0 + plan.tile_rows)] += 1
            per[c] += min(m, r0 + plan.tile_rows) - r0
    return visits, per


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("slots", [B3_ROW_SLOTS, 132, 1, 7])
@pytest.mark.parametrize("m,n", [
    (256, 1024), (1000, 2000), (1000, 500), (800, 100), (3, 5), (1, 1),
    (1000, 1003), (997, 1999), (333, 511), (4096, 8192), (50, 6000),
    (37, 16385), (300, 20000), (64, 131072), (9, 70001), (40, 200000),
    (7, 150001), (1000, 131073)])
def test_lstsq_gradmap_plan_places_every_row_once(m, n, slots, bf16):
    """Every row once on every route; the grid a whole number of
    clusters, no more units than the slots, none without rows; the
    scratch holds the grid barrier's counters, an f partial a part and,
    16-byte aligned, an (n,) gradient partial a part."""
    plan = lstsq_fused.gradmap_plan(m, n, bf16, slots)
    assert plan.blocks % plan.cluster == 0
    parts = plan.blocks // plan.cluster
    assert 1 <= parts <= slots
    visits, per = _b3_rows(plan, m)
    assert np.all(visits == 1)
    assert per.min() >= 1
    if plan.route in (1, 2):
        assert plan.cluster == 1
        assert plan.tile_rows == lstsq_fused.rows_at_once(
            plan.cpt, plan.vec, plan.threads)
    else:
        assert 1 <= plan.tile_rows <= lstsq_fused.TILE_MAX
    head = (parts + 2) & ~1            # doubles: counters, f partials, pad
    assert head % 2 == 0 and head >= 1 + parts
    assert 2 * (plan.scratch_doubles - head) >= parts * n
    assert 2 * (plan.scratch_doubles - head) - parts * n <= 1


@pytest.mark.parametrize("bf16,edges", [
    # (n, route, vec, cpt, threads) at each boundary: 16-byte float32
    # rows take 512 columns a warp, 2048 a group of 128 and 8192 of 512;
    # ragged rows 512 a warp and 2048 a group of 512, a value a slot
    (False, [(4, 1, 4, 1, 128), (128, 1, 4, 1, 128), (132, 1, 4, 2, 128),
             (512, 1, 4, 4, 128), (516, 2, 4, 2, 128), (1024, 2, 4, 2, 128),
             (1028, 2, 4, 4, 128), (2048, 2, 4, 4, 128),
             (2052, 2, 4, 2, 512), (4096, 2, 4, 2, 512),
             (4100, 2, 4, 4, 512), (8192, 2, 4, 4, 512),
             (8196, 3, 4, 8, 512), (16384, 3, 4, 8, 512),
             (16388, 3, 4, 8, 512), (131072, 3, 4, 8, 512),
             (131076, 4, 4, 0, 512), (3, 1, 1, 1, 128), (37, 1, 1, 2, 128),
             (511, 1, 1, 16, 128), (513, 2, 1, 2, 512),
             (2047, 2, 1, 4, 512), (2049, 3, 1, 8, 512),
             (16385, 3, 1, 32, 512), (131073, 4, 1, 0, 512)]),
    (True, [(8, 1, 8, 1, 128), (256, 1, 8, 1, 128), (264, 1, 8, 2, 128),
            (512, 1, 8, 2, 128), (520, 2, 8, 1, 128), (1024, 2, 8, 1, 128),
            (1032, 2, 8, 2, 128), (2048, 2, 8, 2, 128),
            (2056, 2, 8, 1, 512), (4096, 2, 8, 1, 512),
            (4104, 2, 8, 2, 512), (8192, 2, 8, 2, 512),
            (8200, 3, 8, 4, 512), (16384, 3, 8, 4, 512),
            (500, 1, 1, 16, 128), (1003, 2, 1, 2, 512),
            (2052, 3, 1, 8, 512)])])
def test_lstsq_gradmap_plan_route_boundaries(bf16, edges):
    for n, route, vec, cpt, threads in edges:
        plan = lstsq_fused.gradmap_plan(1000, n, bf16, 30)
        assert (plan.route, plan.vec, plan.cpt, plan.threads) == \
            (route, vec, cpt, threads), n
        if route == 1:    # the four warps' shares
            assert plan.smem_bytes == 4 * 4 * n
        elif route == 2:  # the threads' own columns straight to the scratch
            assert plan.smem_bytes == 0
        elif route == 4:
            assert plan.smem_bytes == 0 and plan.cluster == 1


def test_lstsq_gradmap_plan_on_the_h100_main_shapes():
    """At the main paths' shapes a group takes 4 rows at once and the grid
    is the fewest blocks that hold the rows in one step, at most one an
    SM: democratic's 256×1024 a row a group of 128 threads on 64 blocks,
    NNLS's and logistic's 1000×500 and SVM's 800×100 a warp a row on 63
    and 50, LASSO's 1000×2000 on all 132 SMs in two steps — fewer blocks,
    fewer partials to sum at the end (on the card, 64 blocks of 4 rows at
    256×1024 4.65 µs a call against 132 of 1 row 5.58 µs; PERF.md §6);
    the 8192×16384 stream on route 3, one tile row a block a step on the
    132 SMs, 192 KB of ring each; 1024×200000 in bfloat16 on route 4."""
    want = {(256, 1024): (2, 2, 128, 4, 64), (1000, 2000): (2, 4, 128, 4, 132),
            (1000, 500): (1, 4, 128, 4, 63), (800, 100): (1, 1, 128, 4, 50)}
    for (m, n), got in want.items():
        plan = lstsq_fused.gradmap_plan(m, n, False, B3_ROW_SLOTS)
        assert (plan.route, plan.cpt, plan.threads, plan.tile_rows,
                plan.blocks) == got, (m, n)
        rows = plan.threads // (32 if plan.route == 1 else plan.threads)
        step = rows * plan.tile_rows
        assert plan.blocks == min(SMS, -(-m // step))
        # every block has a row at every step but the last
        assert plan.blocks * step * (-(-m // (plan.blocks * step)) - 1) < m
    big = lstsq_fused.gradmap_plan(8192, 16384, False, SMS)
    assert (big.route, big.cluster, big.blocks, big.tile_rows,
            big.smem_bytes) == (3, 1, 132, 1, 3 * 16384 * 4)
    wide = lstsq_fused.gradmap_plan(1024, 200000, True, SMS)
    assert (wide.route, wide.blocks, wide.tile_rows) == (4, 128, 8)


def test_gradmap_plans_at_the_sharded_blocks():
    """Two ranks of the row-sharded main paths each hold half the rows:
    LASSO's 500×2000 takes K-B3's route 2 on 125 blocks (one step of 4
    rows a block), logistic's 500×500 K-B3p's route 1 on 32 blocks (a warp
    a row, 4 rows at once), planar phase retrieval's 8192×256 K-B7's route
    1 on 30 clusters of 8, as the whole 16384×256 does; every row once."""
    want = {(500, 2000): (2, 4, 128, 4, 125), (500, 500): (1, 4, 128, 4, 32)}
    for (m, n), got in want.items():
        plan = lstsq_fused.gradmap_plan(m, n, False, B3_ROW_SLOTS)
        assert (plan.route, plan.cpt, plan.threads, plan.tile_rows,
                plan.blocks) == got, (m, n)
        assert np.all(_b3_rows(plan, m)[0] == 1)
    half = gradmap_plan(8192, 256, False, 30)
    assert (half.route, half.vec, half.cpt, half.blocks) == (1, 4, 2, 240)
    assert half == gradmap_plan(16384, 256, False, 30)
    assert np.all(_gradmap_rows(half, 8192)[0] == 1)


@pytest.mark.parametrize("m,n,slots", [(0, 256, 30), (16, 0, 30),
                                       (16, 256, 0), (-1, 4, 30)])
def test_lstsq_gradmap_plan_refuses_empty_shapes(m, n, slots):
    with pytest.raises(ValueError, match="gradmap_plan"):
        lstsq_fused.gradmap_plan(m, n, False, slots)


# --------------------------------------------------------------------------
# K-P3's and K-P4's plans: K-B1's dense plan at each probe's own budget
# --------------------------------------------------------------------------

def _held_once(plan, m, budget, row_bytes):
    """Every row in exactly one band, each band's rows in registers, then
    shared memory within the budget, then streamed; returns the streamed
    count."""
    placed = np.zeros(m, np.int64)
    streamed = 0
    for (r0, r1), g, s in zip(plan.bands, plan.reg_rows, plan.smem_rows):
        assert 0 <= g and 0 <= s and g + s <= r1 - r0
        assert s * row_bytes <= budget
        if r1 - r0 > g + s:
            assert (s + 1) * row_bytes > budget
        placed[r0:r1] += 1
        streamed += r1 - r0 - g - s
    assert np.all(placed == 1)
    assert plan.streamed_rows == streamed
    assert plan.route == ("streamed" if streamed else "resident")
    return streamed


@pytest.mark.parametrize("m,n4,nblocks,budget", [
    (1000, 2000, SMS, None), (200, 300, SMS, None), (16, 16, SMS, None),
    (3000, 2000, SMS, None), (3000, 2000, SMS, 0), (600, 2052, SMS, None),
    (600, 2052, SMS, 0), (1000, 8192, SMS, None), (4099, 256, 7, 10000)])
def test_tail_plan_places_every_row_once(m, n4, nblocks, budget):
    """The ladder's plan is K-B1's dense plan at the probe's budget: the
    same bands, every row placed once, 8R rows a band in registers at one
    slot a thread."""
    budget = tail_probe.tail_budget(n4) if budget is None else budget
    plan = tail_probe.tail_plan(m, n4, nblocks, budget)
    assert plan == dense_plan(m, n4, nblocks, budget)
    _, R, S = microsolver.dense_lanes(n4)
    for (r0, r1), g in zip(plan.bands, plan.reg_rows):
        assert g == (min(r1 - r0, 8 * R) if S == 1 else 0)
    _held_once(plan, m, budget, 4 * n4)


def test_tail_budget_counts_the_probe_state():
    """The ladder's state is K-B1's less x_acc: x, x₁, g twice and the
    R − 1 other row lanes' shares, n4 floats each — 4 n4 bytes more room
    for rows than K-B1 has; none past STATE_MAX_N."""
    tb = tail_probe.tail_budget
    assert tb(16, 100000, 1000) == 100000 - 1000 - 4 * 16 * (3 + 16)
    assert tb(300, 100000, 1000) == 100000 - 1000 - 4 * 300 * (3 + 5)
    assert tb(2000, 100000, 1000) == 100000 - 1000 - 4 * 2000 * 4
    assert tb(2000, 100000, 0) == microsolver.dense_budget(2000, 100000, 0) \
        + 4 * 2000
    assert tb(8192, 100000, 1000) == 0
    assert tb(2000) == (microsolver.H100_SMEM_OPTIN
                        - tail_probe.H100_STATIC_SMEM - 4 * 2000 * 4)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m,n,nblocks,budget", [
    (1000, 2000, SMS, None), (37, 1003, SMS, None), (64, 8, SMS, None),
    (4753, 2000, SMS, None), (5000, 2000, SMS, 0), (3000, 2000, SMS, 40000),
    (300, 8192, SMS, None), (1, 1, SMS, None), (4099, 260, 7, 10000)])
def test_bf16_probe_plan_places_every_row_once(m, n, nblocks, budget, bf16):
    """K-P4's plan is K-B1's dense plan at the width of a row in 16-byte
    slots (``probe_width``: a bfloat16 row takes half the slots of a
    float32 one) and the probe's budget: every row placed once, a row's
    bytes on the chip its slots' 16 each."""
    w = bf16_probe.probe_width(n, bf16)
    assert w == 4 * -(-n // (8 if bf16 else 4))
    budget = bf16_probe.bf16_probe_budget(n, bf16) if budget is None \
        else budget
    plan = bf16_probe.bf16_probe_plan(m, n, bf16, nblocks, budget)
    assert plan == dense_plan(m, w, nblocks, budget)
    _held_once(plan, m, budget, 4 * w)


def test_bf16_probe_budget_bf16_against_float32():
    """Shares of g are float32 either way (one a padded column); a
    bfloat16 row takes half a float32 row's threads and bytes, so at
    n = 2000 a block keeps twice the register rows (two row lanes) and
    about twice the shared-memory rows."""
    bb = bf16_probe.bf16_probe_budget
    # n = 2000: float32 one row lane (no shares), bfloat16 two
    assert bb(2000, False, 100000, 1000) == 100000 - 1000
    assert bb(2000, True, 100000, 1000) == 100000 - 1000 - 4 * 2000
    # n = 1003 pads to 1004 (float32) or 1008 (bfloat16) columns
    assert bb(1003, False, 100000, 1000) == 100000 - 1000 - 4 * 1004 * 1
    assert bb(1003, True, 100000, 1000) == 100000 - 1000 - 4 * 1008 * 3
    f32 = bf16_probe.bf16_probe_plan(9000, 2000, False, SMS, bb(2000, False))
    b16 = bf16_probe.bf16_probe_plan(9000, 2000, True, SMS, bb(2000, True))
    assert max(f32.reg_rows) == 8 and max(b16.reg_rows) == 16
    cap32 = bb(2000, False) // (4 * 2000)
    cap16 = bb(2000, True) // (4 * 1000)
    assert 1.9 < cap16 / cap32 < 2.0


def test_bf16_probe_second_shape_on_the_h100():
    """At n = 2000 on the H100 the smallest m whose float32 plan streams a
    remainder keeps every row on the chip in bfloat16: 36 rows a block in
    float32 (8 in registers, 28 in shared memory), 71 in bfloat16 (16 and
    55), so the first streamed float32 shape is 36·132 + 1 = 4753 rows."""
    def plan(m, bf16):
        return bf16_probe.bf16_probe_plan(
            m, 2000, bf16, SMS, bf16_probe.bf16_probe_budget(2000, bf16))
    assert plan(4752, False).route == "resident"
    assert plan(4753, False).route == "streamed"
    assert plan(4753, True).route == "resident"
    assert plan(71 * SMS, True).route == "resident"
    assert plan(71 * SMS + 1, True).route == "streamed"


@pytest.mark.parametrize("what,args", [
    ("tail_plan", (100, 8196, SMS, 0)), ("tail_plan", (0, 16, SMS, 0)),
    ("tail_plan", (16, 18, SMS, 0)), ("tail_budget", (8196,)),
    ("tail_budget", (6,)), ("bf16_probe_plan", (100, 8193, True, SMS, 0)),
    ("bf16_probe_plan", (100, 8193, False, SMS, 0)),
    ("bf16_probe_plan", (0, 100, False, SMS, 0)),
    ("bf16_probe_plan", (100, 0, True, SMS, 0)),
    ("bf16_probe_budget", (9000, True))])
def test_probe_plans_refuse_what_the_kernels_do_not_take(what, args):
    """Past 8192 columns neither probe has a plan (every block keeps the
    n-sized state or its share of g), nor for empty or unpadded shapes."""
    fn = getattr(tail_probe if what.startswith("tail") else bf16_probe, what)
    with pytest.raises(ValueError):
        fn(*args)


# --------------------------------------------------------------------------
# K-P1's gradmap form: K-B1's dense plan at the kernel's own budget
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m,n4,nblocks,budget", [
    (1000, 2048, SMS, None), (16, 16, SMS, None), (4621, 2048, SMS, None),
    (6000, 2048, SMS, None), (6000, 2048, SMS, 0), (2000, 1500, SMS, None),
    (500, 4096, SMS, None), (300, 8192, SMS, None), (37, 100, SMS, None),
    (4099, 260, 7, 10000)])
def test_gradmap_probe_plan_places_every_row_once(m, n4, nblocks, budget):
    """The gradmap form's plan is K-B1's dense plan at the kernel's budget:
    the same bands, every row placed once, 8R rows a band in registers at
    one slot a thread (n ≤ 2048), none past it."""
    budget = matvec_probe.gradmap_probe_budget(n4) if budget is None \
        else budget
    plan = matvec_probe.gradmap_probe_plan(m, n4, nblocks, budget)
    assert plan == dense_plan(m, n4, nblocks, budget)
    _, R, S = microsolver.dense_lanes(n4)
    for (r0, r1), g in zip(plan.bands, plan.reg_rows):
        assert g == (min(r1 - r0, 8 * R) if S == 1 else 0)
    _held_once(plan, m, budget, 4 * n4)


def test_gradmap_probe_budget_counts_the_kernel_state():
    """The kernel's state is the R − 1 other row lanes' shares of g, n4
    floats each (b and the rest are static): a row lane alone from 1024
    columns up, 16 at 16 columns, nothing past 8192."""
    gb = matvec_probe.gradmap_probe_budget
    assert gb(2048, 100000, 1000) == 100000 - 1000
    assert gb(8192, 100000, 1000) == 100000 - 1000
    assert gb(1500, 100000, 1000) == 100000 - 1000
    assert gb(300, 100000, 1000) == 100000 - 1000 - 4 * 300 * 4
    assert gb(16, 100000, 1000) == 100000 - 1000 - 4 * 16 * 15
    assert gb(16, 1000, 1000) == 0
    assert gb(2048) == (microsolver.H100_SMEM_OPTIN
                        - matvec_probe.H100_STATIC_SMEM)
    # the same arithmetic as K-P4's float32 budget but for the static part
    for n in (16, 300, 1500, 2048, 4096, 8192):
        assert gb(n, 100000, 3000) == \
            bf16_probe.bf16_probe_budget(n, False, 100000, 3000)


def test_gradmap_probe_plan_on_the_h100():
    """On the H100 (132 SMs) 1000×2048 keeps every row in registers (bands
    of 7 or 8 rows, 8 a block); at n = 2048 a block keeps 8 rows in
    registers and 27 in shared memory, so the plan first streams at
    35·132 + 1 = 4621 rows; 500×4096 and 300×8192 keep their rows in
    shared memory (no register rows past 2048 columns)."""
    def plan(m, n):
        return matvec_probe.gradmap_probe_plan(
            m, n, SMS, matvec_probe.gradmap_probe_budget(n))
    main = plan(1000, 2048)
    assert main.route == "resident" and sum(main.smem_rows) == 0
    assert {r1 - r0 for r0, r1 in main.bands} == {7, 8}
    assert max(main.reg_rows) == 8
    assert (matvec_probe.gradmap_probe_budget(2048) // (4 * 2048)) == 27
    assert plan(4620, 2048).route == "resident"
    streamed = plan(4621, 2048)
    assert streamed.route == "streamed" and streamed.streamed_rows == 1
    assert max(streamed.smem_rows) == 27
    for m, n in ((500, 4096), (300, 8192)):
        p = plan(m, n)
        assert p.route == "resident" and max(p.reg_rows) == 0


@pytest.mark.parametrize("what,args", [
    ("gradmap_probe_plan", (100, 8196, SMS, 0)),
    ("gradmap_probe_plan", (100, 8192 + 4, SMS, 10 ** 6)),
    ("gradmap_probe_plan", (16, 18, SMS, 0)),
    ("gradmap_probe_plan", (0, 16, SMS, 0)),
    ("gradmap_probe_plan", (16, 0, SMS, 0)),
    ("gradmap_probe_budget", (8196,)), ("gradmap_probe_budget", (6,)),
    ("gradmap_probe_budget", (0,))])
def test_gradmap_probe_plan_refuses_what_the_kernel_does_not_take(what, args):
    """Past 8192 columns the gradmap kernel has no plan (every block keeps
    its share of g), nor for empty or unpadded widths; the limit is named."""
    with pytest.raises(ValueError, match="8192|dense_plan"):
        getattr(matvec_probe, what)(*args)
