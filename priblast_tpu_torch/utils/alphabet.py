"""Sequence encodings.

Two encodings exist, mirroring the reference:

1. *Accessibility codes* (0..4) fed to the Raccess DP: A=1, C=2, G=3, T/U=4,
   anything else 0; case-insensitive (reference: src/raccess.cpp:52-68).

2. *Search codes* (0..9) used by the suffix-array index and extensions
   (reference: src/encoder.hpp:36-80): 0 sentinel, 1 unknown, ACGT/U=2..5
   uppercase; repeat_flag selects lowercase handling:
     0 (hard mask): lowercase -> 1
     1 (soft mask): lowercase acgt/u -> 6..9
     2 (no mask):   lowercase acgt/u -> 2..5

   Database sequences are encoded REVERSED (3'->5') with a 0 sentinel after
   each; queries are encoded forward with one trailing sentinel
   (reference: src/encoder.cpp:27-44).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=1)
def _access_table() -> np.ndarray:
    t = np.zeros(256, dtype=np.uint8)
    for ch, v in (("Aa", 1), ("Cc", 2), ("Gg", 3), ("TtUu", 4)):
        for c in ch:
            t[ord(c)] = v
    return t


def access_codes(seq: str) -> np.ndarray:
    """Map a sequence string to Raccess codes 0..4."""
    raw = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
    return _access_table()[raw]


@functools.lru_cache(maxsize=8)
def _search_table(repeat_flag: int) -> np.ndarray:
    t = np.ones(256, dtype=np.uint8)  # unknown
    upper = {"A": 2, "C": 3, "G": 4, "T": 5, "U": 5}
    for c, v in upper.items():
        t[ord(c)] = v
    if repeat_flag == 1:
        for c, v in upper.items():
            t[ord(c.lower())] = v + 4
    elif repeat_flag == 2:
        for c, v in upper.items():
            t[ord(c.lower())] = v
    elif repeat_flag != 0:
        raise ValueError("repeat_flag must be 0, 1 or 2")
    return t


def encode_query(seq: str, repeat_flag: int) -> np.ndarray:
    """Forward search-encoding with one trailing sentinel
    (reference: src/encoder.cpp:38-44)."""
    raw = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
    out = np.zeros(len(raw) + 1, dtype=np.uint8)
    out[:-1] = _search_table(repeat_flag)[raw]
    return out


def encode_db(seqs: list[str], repeat_flag: int) -> np.ndarray:
    """Concatenated reversed search-encoding, 0 sentinel after each sequence
    (reference: src/encoder.cpp:27-36)."""
    total = sum(len(s) for s in seqs) + len(seqs)
    out = np.zeros(total, dtype=np.uint8)
    t = _search_table(repeat_flag)
    pos = 0
    for s in seqs:
        raw = np.frombuffer(s.encode("latin-1"), dtype=np.uint8)
        out[pos : pos + len(raw)] = t[raw[::-1]]
        pos += len(raw) + 1  # sentinel 0 already zero-filled
    return out
