"""The planar lane products' share of their roofline: the traced requests'
least time for them, the count of ``fasta.op.planar.forward`` and
``.adjoint`` spans (``PlanarDenseOp.lanes`` and ``.rmatvec_lanes``, one
product over every lane each) times the larger of one product's bytes
over the memory rate and its float32 operations over the float32 peak
(``kinds/phase_retrieval.py``: ``product_bytes``, ``product_flops``),
over the device time of the library's matrix kernels in the trace.  Each
product is two library calls, one a channel (Ar and Ai); a count of
kernels other than two a span is noted.  On an H100 80GB HBM3 the traced
cell holds exactly two a span, cuBLAS's ``sm80_xmma_gemm_f32f32`` in its
``nn`` form for the forward and ``nt`` for the adjoint, and no other
kernel matches."""

from portbench import roofline, spans
from portbench.kinds import phase_retrieval

SPANS = ("fasta.op.planar.forward", "fasta.op.planar.adjoint")
KERNELS = r"gemm|gemv"


def read(r):
    if r.trace is None or r.rates is None:
        return None
    calls = sum(spans.count(r.trace, name) for name in SPANS)
    times = r.trace.kernels(KERNELS)
    if not calls or not times:
        return None
    if len(times) != 2 * calls:
        r.note(f"planar_products_roofline: the trace holds {len(times)} "
               f"matrix kernels for {calls} planar products")
    m, n, lanes = r.cfg["m"], r.cfg["n"], r.traffic["batch"]
    least = calls * roofline.bound_s(
        phase_retrieval.product_bytes(m, n, lanes),
        phase_retrieval.product_flops(m, n, lanes), r.rates)
    return 100.0 * least / sum(times)
