"""Device operations the host launched (kernels and memsets, as
``tools/loop_profile.py`` counts them) a loop iteration, in the traced
requests; the loop's iterations are the slowest lane's count a request.
Nothing to read on a route without the loop."""

from portbench import tracing


def read(r):
    if r.trace is None or not r.trace.device or not r.traced.loop_iterations:
        return None
    launches = sum(r.trace.calls[c] for c in tracing.LAUNCH_CALLS)
    return launches / r.traced.loop_iterations
