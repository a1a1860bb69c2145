"""ris_gapped_d2h_bytes_per_hit: the bytes the gapped stage copies from
the card per hit sent to the kernel (counters `ris.gapped.d2h_bytes`
over `ris.gapped.hits`: the sizes of the four result tensors)."""

from pbench import program


def read(run):
    return program.ratio("ris.gapped.d2h_bytes", "ris.gapped.hits")
