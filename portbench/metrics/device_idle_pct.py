"""The share of the traced segment in which no operation ran on the card:
one less the union of the device operations' intervals over the
segment."""


def read(r):
    if r.trace is None or not r.trace.device:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
