"""ris_mid_pool_share: the busy share, in %, of the host pool the mid
stage maps its (query, chunk) groups over: the `ris.mid.group` spans over
the maps' wall time times their busy-able threads (`ris.mid.pool_s`)."""

from pbench import program


def read(run):
    return program.pool_share(run, "ris.mid")
