"""ris_finish_pool_share: the busy share, in %, of the host pool the
finish stage maps its (query, chunk) groups over: the `ris.finish.group`
spans over the maps' wall time times their busy-able threads
(`ris.finish.pool_s`)."""

from pbench import program


def read(run):
    return program.pool_share(run, "ris.finish")
