"""ris_load_s_per_qmnt: the program's `ris.load` span, each job's load of
every page of the database from its files (`store.load_chunks`), in
seconds per million query nucleotides; inside the driver remainder."""

from pbench import readers


def read(run):
    return readers.span_per_mnt(run, "ris.load")
