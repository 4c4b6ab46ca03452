"""K-B4's (``csrc/prox_fused.cu``) share of its roofline: the least time
of its calls in the traced requests, x and g read and x̂₁ written once
with each lane's τ and sums (``roofline.kb4_bytes``) over the memory
rate, over its kernels' device time in the trace.  Every call covers the
batch's lanes (rows) of n unknowns."""

from portbench import roofline

KERNELS = r"shrink_(row|stream)_kernel"


def read(r):
    if r.trace is None or r.rates is None:
        return None
    times = r.trace.kernels(KERNELS)
    if not times:
        return None
    calls = r.counters.get("prox_fused.LAUNCHES", 0)
    if len(times) != calls:
        r.note(f"kb4_roofline: the trace holds {len(times)} K-B4 kernels "
               f"for {calls} calls")
    least = len(times) * roofline.kb4_bytes(
        r.traffic["batch"], r.cfg["n"]) / r.rates["hbm_bytes_per_s"]
    return 100.0 * least / sum(times)
