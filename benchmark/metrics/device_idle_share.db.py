"""device_idle_share.db: the share of the traced window of the db cells,
in %, in which nothing ran on the card."""

from pbench import readers


def read(run):
    return readers.idle_share(run)
