"""FASTA input.

Parsing matches the reference's semantics (CRLF-tolerant, multi-line
sequences, name = full header line after '>'; reference:
src/fastafile_reader.cpp:76-133).
"""

from __future__ import annotations

from pathlib import Path


def read_fasta(path: str | Path) -> tuple[list[str], list[str]]:
    """Return (names, sequences) in file order."""
    names: list[str] = []
    seqs: list[str] = []
    cur: list[str] = []
    with open(path, "r", newline="") as f:
        for line in f:
            line = line.rstrip("\r\n")
            if line.startswith(">"):
                if names:
                    seqs.append("".join(cur))
                    cur = []
                names.append(line[1:])
            else:
                cur.append(line)
    if names:
        seqs.append("".join(cur))
    return names, seqs
