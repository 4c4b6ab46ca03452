"""Times the host waited for the card (stream synchronizes, behind every
read of a device value, and synchronous copies) a loop iteration, in the
traced requests; the harness's own wait at a request's end
(``cudaDeviceSynchronize``) is not counted.  Nothing to read on a route
without the loop."""


def read(r):
    if r.trace is None or not r.trace.device or not r.traced.loop_iterations:
        return None
    waits = r.trace.calls["cudaStreamSynchronize"] + r.trace.calls[
        "cudaMemcpy"]
    return waits / r.traced.loop_iterations
