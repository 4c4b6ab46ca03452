"""The yardstick at the cells' shapes: operations, bytes and bounds, and
the trace arithmetic (busy union, idle gaps by host event)."""

import collections

import pytest

from portbench import roofline, tracing

H100 = roofline.peaks("NVIDIA H100 80GB HBM3")


def test_peaks_by_device_name():
    assert H100 == {"hbm_bytes_per_s": 3.35e12, "f32_flops": 67e12}
    assert roofline.peaks("NVIDIA H100 PCIe") is None
    assert roofline.peaks("cpu") is None


def test_kb4_at_the_lasso_cell():
    # 16384 lanes of 2000: x, g read and x̂ written, 4 B each, and 28 B
    # a lane for τ and three float64 sums
    nbytes = roofline.kb4_bytes(16384, 2000)
    assert nbytes == 12 * 16384 * 2000 + 28 * 16384
    assert roofline.bound_s(nbytes, 0.0, H100) == pytest.approx(
        393674752 / 3.35e12)


def test_kb6b_at_the_tv_cell():
    # 8 images of 512×512, 2160 trials and 2136 iterations each
    h = w = 512
    ops = roofline.tv_flops(h, w, 8 * 2160, 8)
    assert ops == h * w * (8 * 2160 * 53 + 8 * 11)
    nbytes = roofline.kb6b_bytes(8, h, w, 8 * 2136)
    assert nbytes == 4 * (8 * h * w + 2 * h * w + 1 + 16 * h * w
                          + 3 * 8 * 2136)
    # operations bound it, about 3.6 ms for the batch
    assert roofline.bound_s(nbytes, ops, H100) == pytest.approx(ops / 67e12)
    assert 3.0e-3 < ops / 67e12 < 4.0e-3


def synthetic_trace():
    ms = 1_000_000
    device = [("k1", 1 * ms, 3 * ms), ("k2", 2 * ms, 4 * ms),
              ("k1", 6 * ms, 7 * ms), ("Memcpy DtoH", 9 * ms, 10 * ms)]
    host = [("portbench.traced", 0, 10 * ms),
            ("portbench.request", 0, 10 * ms),
            ("aten::mm", 4 * ms, 5.5 * ms),
            ("cudaStreamSynchronize", 7 * ms, 9 * ms)]
    return tracing.Trace(device, collections.Counter(
        {"cudaLaunchKernel": 3, "cudaStreamSynchronize": 1}), (0, 10 * ms),
        host)


def test_busy_is_the_union_of_device_operations():
    t = synthetic_trace()
    assert t.busy_intervals() == [(1_000_000, 4_000_000),
                                  (6_000_000, 7_000_000),
                                  (9_000_000, 10_000_000)]
    assert t.busy_s == pytest.approx(5e-3)
    assert t.window_s == pytest.approx(10e-3)
    assert t.kernels(r"^k1$") == pytest.approx([2e-3, 1e-3])


def test_idle_gaps_go_to_the_innermost_host_event():
    gaps = dict(synthetic_trace().idle_gaps())
    # a gap goes whole to the event open at its middle: 0–1 ms to the
    # request, 4–6 ms to aten::mm, 7–9 ms to the synchronize
    assert gaps == pytest.approx({"portbench.request": 1e-3,
                                  "aten::mm": 2e-3,
                                  "cudaStreamSynchronize": 2e-3})


def test_device_ops_rank_by_time():
    ops = synthetic_trace().device_ops()
    assert ops[0] == ["k1", pytest.approx(3e-3)]
    assert [n for n, _ in ops] == ["k1", "k2", "Memcpy_DtoH"]
