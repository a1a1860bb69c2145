"""FASTA input and sequence partitioning.

Parsing matches the reference's semantics (CRLF-tolerant, multi-line
sequences, name = full header line after '>'; reference:
src/fastafile_reader.cpp:76-133). The partitions stand in for the
reference's MPI distribution strategies (block / heap-LPT / area-sum;
src/fastafile_reader.cpp:135-409): every process reads the whole FASTA and
takes its own shard, chosen deterministically, which keeps the strategies'
load-balancing intent without a work-stealing counter
(parallel/multihost.py).
"""

from __future__ import annotations

import heapq
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


def sort_indices_by_length_desc(seqs: list[str]) -> list[int]:
    """Stable indices of sequences sorted by descending length — the
    guided-LPT ordering the reference applies before dispatch
    (reference: src/utils.cpp:56-63)."""
    return sorted(range(len(seqs)), key=lambda i: -len(seqs[i]))


def partition_block(n: int, parts: int) -> list[list[int]]:
    """Contiguous static blocks (reference 'pure-block',
    src/fastafile_reader.cpp:135-170)."""
    chunk = n // parts + 1
    return [list(range(i * chunk, min(n, (i + 1) * chunk)))
            for i in range(parts)]


def partition_lpt(lengths: list[int], parts: int) -> list[list[int]]:
    """Greedy longest-processing-time partitioning over sequence lengths,
    the static stand-in for the reference's 'heap' strategy
    (src/fastafile_reader.cpp:248-314)."""
    heap = [(0, p) for p in range(parts)]
    heapq.heapify(heap)
    out: list[list[int]] = [[] for _ in range(parts)]
    for idx in sorted(range(len(lengths)), key=lambda i: -lengths[i]):
        load, p = heapq.heappop(heap)
        out[p].append(idx)
        heapq.heappush(heap, (load + lengths[idx], p))
    for lst in out:
        lst.sort()
    return out


def partition_area(lengths: list[int], parts: int) -> list[list[int]]:
    """Greedy fill to the average char count ('area-sum',
    src/fastafile_reader.cpp:172-246): pack longest-first up to the mean
    area per part, spilling the remainder LPT-style."""
    total = sum(lengths)
    target = total / max(parts, 1)
    order = sorted(range(len(lengths)), key=lambda i: -lengths[i])
    out: list[list[int]] = [[] for _ in range(parts)]
    loads = [0] * parts
    p = 0
    rest: list[int] = []
    for idx in order:
        if p < parts and loads[p] + lengths[idx] <= target:
            out[p].append(idx)
            loads[p] += lengths[idx]
        else:
            if p < parts and not out[p]:
                out[p].append(idx)
                loads[p] += lengths[idx]
                p += 1
            else:
                rest.append(idx)
                if p < parts and loads[p] >= target:
                    p += 1
    heap = sorted((loads[q], q) for q in range(parts))
    heapq.heapify(heap)
    for idx in rest:
        load, q = heapq.heappop(heap)
        out[q].append(idx)
        heapq.heappush(heap, (load + lengths[idx], q))
    for lst in out:
        lst.sort()
    return out
