"""The phase-retrieval cell at a CPU test's size: its inputs come from the
seed, each request carries its own magnitudes, anchors and starts, the
judge reads `correct` false for an answer solved under one shared anchor
and for a lane left at its start, and ``planar_products_roofline`` reads
a synthetic trace."""

import collections

import pytest
import torch

import fasta_tpu_torch as ftt
from conftest import ROOT, small
from portbench import control, harness, roofline, tracing
from portbench.kinds import phase_retrieval

NAME = "phase-retrieval-16384x256.batch64"
SIZES = dict(m=256, n=16, batch=4, pool=3, kept_requests=3,
             kept_per_request=2, traced_requests=1)


@pytest.fixture
def cell():
    return small(harness.load_cell(ROOT, NAME), **SIZES)


def inputs(cell, seed):
    gen = torch.Generator().manual_seed(seed % 2 ** 64)
    return phase_retrieval.make_inputs(cell.cfg, cell.traffic, gen, "cpu")


def test_a_seed_repeats_and_seeds_differ(cell):
    a, b = inputs(cell, 2 ** 31 + 21), inputs(cell, 2 ** 31 + 21)
    c = inputs(cell, 2 ** 31 + 22)
    pool = a["pool"]
    assert isinstance(pool, ftt.InstanceBatch)
    assert pool.shape == (3, 4, 256) and len(pool[1]) == 4
    assert pool.prox.shape == pool.x0.shape == (3, 4, 16, 2)
    assert a["Ar"].shape == a["Ai"].shape == (256, 16)
    for k in ("Ar", "Ai", "x_true"):
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    for k in ("data", "prox", "x0"):
        assert torch.equal(getattr(pool, k), getattr(b["pool"], k))
        assert not torch.equal(getattr(pool, k), getattr(c["pool"], k))
    # every instance its own: unit-norm starts, anchors δ times them, and
    # the magnitudes of its own planted signal
    starts = pool.x0.reshape(12, 16, 2)
    norms = torch.linalg.vector_norm(starts, dim=(1, 2))
    torch.testing.assert_close(norms, torch.ones(12))
    torch.testing.assert_close(pool.prox, cell.cfg["delta"] * pool.x0)
    assert len({float(s.sum()) for s in starts}) == 12
    d = phase_retrieval.ref.forward(a["Ar"], a["Ai"], a["x_true"][2, 1:2])
    torch.testing.assert_close(torch.linalg.vector_norm(d, dim=-1)[0],
                               pool.data[2, 1])


def test_the_request_route_is_the_batch_loop(cell):
    data = inputs(cell, 5)
    p = phase_retrieval.problem(cell.cfg, data, ftt)
    assert ftt.recommend_path(p, cell.traffic["batch"]).path == "batch_solver"


def correct(cell, seed):
    s = harness.Session(cell, seed, "cpu", ftt, log=lambda t: None)
    s.setup()
    s.window(count=2)
    checks, _ = s.judge()
    return harness.passed(checks)


def shared_anchor(real):
    def solve_serving(self, bs=None, **kwargs):
        return real(self, bs.data, **kwargs)
    return solve_serving


def lane_left_at_its_start(real):
    def solve_serving(self, bs=None, **kwargs):
        out = real(self, bs, **kwargs)
        x = out.solution.clone()
        x[1:] = bs.x0[1:]
        return out._replace(solution=x)
    return solve_serving


def test_a_sound_run_is_correct(cell):
    assert correct(cell, 2 ** 31 + 101)


@pytest.mark.parametrize("fault", [shared_anchor, lane_left_at_its_start])
def test_a_broken_run_is_not_correct(cell, fault, monkeypatch):
    monkeypatch.setattr(ftt.Problem, "solve_serving",
                        fault(ftt.Problem.solve_serving))
    assert not correct(cell, 2 ** 31 + 101)


def test_the_product_yardstick():
    # one product over 64 lanes at 16384×256: A's two channels once and
    # each lane's vectors in and out; operations bound it at about 32 µs
    nbytes = phase_retrieval.product_bytes(16384, 256, 64)
    assert nbytes == 2 * 16384 * 256 * 4 + 64 * (256 + 16384) * 2 * 4
    ops = phase_retrieval.product_flops(16384, 256, 64)
    assert ops == 8 * 16384 * 256 * 64
    H100 = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert roofline.bound_s(nbytes, ops, H100) == pytest.approx(ops / 67e12)
    assert 3.0e-5 < ops / 67e12 < 3.3e-5


def readings(cell, trace, rates):
    return harness.Readings(cell.cfg, cell.traffic, rates, harness.Tally(),
                            harness.Tally(), trace, {}, [])


def synthetic_trace(kernels_per_span=2):
    """Three planar products in 10 ms, each its span with its kernels of
    1 ms, and one elementwise kernel that the metric does not read."""
    ms = 1_000_000
    host = [("portbench.traced", 0, 10 * ms)]
    device = [("void at::native::vectorized_elementwise_kernel", 0, ms)]
    for i, name in enumerate(("fasta.op.planar.forward",
                              "fasta.op.planar.adjoint",
                              "fasta.op.planar.forward")):
        s = (1 + 3 * i) * ms
        host.append((name, s, s + 3 * ms))
        for k in range(kernels_per_span):
            device.append(("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n",
                           s + k * ms, s + (k + 1) * ms))
    return tracing.Trace(device, collections.Counter(), (0, 10 * ms), host)


def test_planar_products_roofline_reads_a_synthetic_trace():
    cell = harness.load_cell(ROOT, NAME)
    reader = harness.reader("planar_products_roofline")
    H100 = roofline.peaks("NVIDIA H100 80GB HBM3")
    r = readings(cell, synthetic_trace(), H100)
    least = 3 * roofline.bound_s(
        phase_retrieval.product_bytes(16384, 256, 64),
        phase_retrieval.product_flops(16384, 256, 64), H100)
    assert reader.read(r) == pytest.approx(100 * least / 6e-3)
    assert r.notes == []
    odd = readings(cell, synthetic_trace(kernels_per_span=1), H100)
    assert reader.read(odd) == pytest.approx(100 * least / 3e-3)
    assert "3 matrix kernels for 3 planar products" in odd.notes[0]
    assert reader.read(readings(cell, synthetic_trace(), None)) is None
    empty = tracing.Trace([], collections.Counter(), (0, 1), [])
    assert reader.read(readings(cell, empty, H100)) is None


def test_bfloat16_control_fails(cell):
    """The plain reference in bfloat16 in the program's place comes out
    not correct (the configuration's control; TF32 products do not
    separate the solution from the program's)."""
    assert cell.cfg["control"] == "bfloat16"
    r = control.readings(cell, 2 ** 31 + 7, "cpu", ftt, 2, 2, control=True)
    limits = cell.cfg["limits"]
    assert any(r[k] > limits[k] for k in limits)
