"""ris_dbpack_s_per_qmnt: the program's `ris.dbpack` span, each job's
packing of every page into flat buffers (`pipeline.DbPack`: the numpy
packing, the position maps and the copies to the card), in seconds per
million query nucleotides; inside the driver remainder."""

from pbench import readers


def read(run):
    return readers.span_per_mnt(run, "ris.dbpack")
