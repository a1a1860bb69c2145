"""ris_gapped_overflow_share: the share, in %, of the hits sent to the
gapped kernel that it flags for the host engine's re-run (counters
`ris.gapped.overflow` over `ris.gapped.hits`)."""

from pbench import program


def read(run):
    return program.ratio("ris.gapped.overflow", "ris.gapped.hits", 100.0)
