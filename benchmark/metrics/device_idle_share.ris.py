"""device_idle_share.ris: the share of the traced window of the ris cells,
in %, in which nothing ran on the card."""

from pbench import readers


def read(run):
    return readers.idle_share(run)
