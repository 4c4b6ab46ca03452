"""The card's idle share of the traced segment (%) in gaps that began
while the PyTorch loop was issuing work: the innermost open ``fasta.*``
span was ``fasta.loop.iteration`` or ``fasta.loop.setup`` when the last
device operation before the gap ended: the host launched more slowly than
the card ran, or the card paused between two queued operations.  Each
such gap counts whole.  Nothing to read without the loop's spans."""

from portbench import spans


def read(r):
    return spans.idle_pct(r, spans.LAUNCHES)
