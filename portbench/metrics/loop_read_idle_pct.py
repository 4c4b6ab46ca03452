"""The card's idle share of the traced segment (%) in gaps that began
while the PyTorch loop waited on a device read: the innermost open
``fasta.*`` span was ``fasta.loop.read.backtrack``, ``.stop`` or
``.resume`` when the last device operation before the gap ended.  Each
such gap counts whole.  Nothing to read without the loop's spans."""

from portbench import spans


def read(r):
    share = spans.idle_pct(r, spans.READS)
    if share is not None:
        held, reads = spans.reads_holding_a_copy(r.trace)
        r.note(f"spans: a copy to the host ends inside {held} of {reads} "
               f"loop read spans")
    return share
