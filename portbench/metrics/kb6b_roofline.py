"""K-B6b's (``csrc/microsolver_tv.cu``) share of its roofline: for each
traced request, the larger of the float32 operations its trials need at
the image size over the float32 peak and its bytes over the memory rate
(``roofline.tv_flops``, ``roofline.kb6b_bytes``), summed, over the
kernel's device time in the trace."""

from portbench import roofline

KERNELS = r"microsolve_tv_kernel"


def read(r):
    if r.trace is None or r.rates is None:
        return None
    times = r.trace.kernels(KERNELS)
    calls = r.counters.get("microsolver_tv.BATCH_LAUNCHES", 0)
    if not times or not calls:
        return None
    if len(times) != calls:
        r.note(f"kb6b_roofline: the trace holds {len(times)} K-B6 kernels "
               f"for {calls} K-B6b calls")
    h, w = r.cfg["h"], r.cfg["w"]
    least = sum(roofline.bound_s(roofline.kb6b_bytes(n, h, w, accepted),
                                 roofline.tv_flops(h, w, trials, n),
                                 r.rates)
                for n, trials, accepted in r.traced.per_request)
    return 100.0 * least * len(times) / calls / sum(times)
