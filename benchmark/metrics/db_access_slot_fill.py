"""db_access_slot_fill: the share, in %, of the scan CTAs the cards hold
at once that the accessibility batches filled with sequences (counters
`access.rows` over `access.slots`, the slots of each batch's devices
summed over the batches)."""

from pbench import program


def read(run):
    return program.ratio("access.rows", "access.slots", 100.0)
