"""ris_driver_s_per_qmnt: the window's time outside the program's top-level
ris stages (the router, the db load, DbPack, the output's write, the
harness's own per-job work), in seconds per million query nucleotides."""

from pbench import readers


def read(run):
    return readers.outside_spans_per_mnt(run, readers.RIS_STAGES)
