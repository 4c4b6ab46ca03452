"""The serving layer's own host time a request (ms): the mean over the
traced requests of the program's ``fasta.serve`` span less the
``fasta.route.*`` span inside it — the route's choice, the plan and the
request's data on their way to the route.  The harness waits for the card
at each request's end, so the card is idle for all of it.  Nothing to read
without the program's spans."""

from portbench import spans


def read(r):
    if r.trace is None:
        return None
    own = spans.serving_host_s(r.trace)
    if not own:
        return None
    return 1e3 * sum(own) / len(own)
