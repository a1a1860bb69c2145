"""The plain reference of a db page's index: the search encoding, the
suffix array (prefix doubling with numpy sorts) and the k-mer hash (the
suffix-array interval of every k-mer, k = 1 .. hash size), as the
reference binary's src/db_construction.cpp:97-145,337-421 lays them
out."""

from __future__ import annotations

import numpy as np

_CODE = np.ones(256, np.uint8)
for _c, _v in zip(b"ACGTU", (2, 3, 4, 5, 5)):
    _CODE[_c] = _v


def encode_page(seqs: list[str]) -> np.ndarray:
    """Each sequence reversed, in search codes (A 2, C 3, G 4, U 5), with
    a 0 after each."""
    parts = []
    for s in seqs:
        raw = np.frombuffer(s.encode("ascii"), np.uint8)[::-1]
        parts.append(_CODE[raw])
        parts.append(np.zeros(1, np.uint8))
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8)


def suffix_array(s: np.ndarray) -> np.ndarray:
    """The suffix array of `s` as it is (a shorter suffix first where one
    is a prefix of another), by prefix doubling."""
    n = len(s)
    rank = s.astype(np.int64)
    k = 1
    while True:
        nxt = np.zeros(n, np.int64)
        nxt[: n - k] = rank[k:] + 1 if k < n else 0
        key = rank * (int(rank.max()) + 2) + nxt
        order = np.argsort(key, kind="stable")
        ks = key[order]
        new = np.zeros(n, np.int64)
        new[order] = np.concatenate([[0], np.cumsum(ks[1:] != ks[:-1])])
        rank = new
        if int(rank.max()) == n - 1 or k >= n:
            return order.astype(np.int32)
        k *= 2


def kmer_hash(s: np.ndarray, sa: np.ndarray, hash_size: int):
    """(start, end) of the suffix-array interval of every k-mer of codes
    2..5, k = 1 .. hash_size, level after level, k-mers in base-4 order
    of their codes, the first base most significant; (1, 0) where no
    suffix starts with the k-mer."""
    n = len(s)
    code = np.zeros(n, np.int64)
    valid = np.ones(n, bool)
    starts, ends = [], []
    for k in range(1, hash_size + 1):
        c = np.zeros(n, np.int64)
        c[: n - k + 1] = s[k - 1:].astype(np.int64)
        valid &= (c >= 2) & (c <= 5)
        code = code * 4 + np.where(valid, c - 2, 0)
        pos = np.flatnonzero(valid[sa])
        keys = code[sa[pos]]
        kmers = np.arange(4 ** k)
        lo = np.searchsorted(keys, kmers, "left")
        hi = np.searchsorted(keys, kmers, "right")
        empty = hi == lo
        st = np.where(empty, 1, pos[np.minimum(lo, len(pos) - 1)]
                      if len(pos) else 1)
        en = np.where(empty, 0, pos[np.maximum(hi - 1, 0)]
                      if len(pos) else 0)
        starts.append(st)
        ends.append(en)
    return (np.concatenate(starts).astype(np.int32),
            np.concatenate(ends).astype(np.int32))
