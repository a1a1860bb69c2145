"""db_driver_s_per_mnt: the window's time outside the program's db
stages (the FASTA read, the .acc, .nam and .bas writes, the harness's
own per-page work), in seconds per million target nucleotides."""

from pbench import readers


def read(run):
    return readers.outside_spans_per_mnt(run, readers.DB_STAGES)
