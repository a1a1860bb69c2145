"""Database serialization, byte-compatible with the reference's
``.bas/.seq/.ind/.acc/.nam`` files.

Formats (all little-endian; reference writers in src/db_construction.cpp):
  .bas  4 int32: hash_size, repeat_flag, maximal_span, min_accessible_length
        (:423-436)
  .seq  per chunk: n_seqs int32, sizes int32[n], count int32, bytes uint8[count]
        (:371-392); the bytes are the reversed search-encoded sequences with
        a 0 sentinel after each
  .ind  per chunk: count int32, suffix array int32[count], start_hash levels
        1..h flattened, end_hash levels 1..h flattened (:394-421)
  .acc  per sequence: c1 int32, float32[c1] accessibilities, c2 int32,
        float32[c2] conditional accessibilities (:502-551, written originally
        at src/raccess.cpp:447-481)
  .nam  one name per line (:553-576)
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

_I4 = np.dtype("<i4")
_F4 = np.dtype("<f4")


def hash_total_slots(hash_size: int) -> int:
    return (4 ** (hash_size + 1) - 4) // 3


@dataclasses.dataclass
class DbChunk:
    """One database page, fully loaded (reference: src/db_wrapper.hpp:31-83
    plus the derived fields computed in src/db_reader.cpp:61-177)."""

    seq_sizes: np.ndarray      # int32[n_seqs] stored (masked) lengths
    seqs: np.ndarray           # uint8[total] reversed encoded + sentinels
    start_pos: np.ndarray      # int32[n_seqs] start of each seq in `seqs`
    seq_length_rep: np.ndarray # int32[n_seqs] unmasked length (codes 2..5)
    suffix_array: np.ndarray   # int32[total]
    hash_start: np.ndarray     # int32[hash_total_slots]
    hash_end: np.ndarray       # int32[hash_total_slots]
    acc: np.ndarray            # float32 flattened accessibilities
    cond: np.ndarray           # float32 flattened conditional accessibilities
    acc_off: np.ndarray        # int64[n_seqs+1]
    cond_off: np.ndarray       # int64[n_seqs+1]
    names: list[str]

    @property
    def n_seqs(self) -> int:
        return len(self.seq_sizes)


def compute_start_pos(seq_sizes: np.ndarray) -> np.ndarray:
    starts = np.zeros(len(seq_sizes), dtype=np.int32)
    if len(seq_sizes) > 1:
        starts[1:] = np.cumsum(seq_sizes[:-1].astype(np.int64) + 1)
    return starts


def compute_seq_length_rep(seqs: np.ndarray) -> np.ndarray:
    """Unmasked length per sequence: count of codes 2..5 between sentinels
    (reference: src/db_reader.cpp:122-131)."""
    sent = np.flatnonzero(seqs == 0)
    good = ((seqs >= 2) & (seqs <= 5)).astype(np.int64)
    cums = np.concatenate([[0], np.cumsum(good)])
    bounds = np.concatenate([[0], sent + 1])
    out = cums[sent + 1] - cums[bounds[:-1]]
    return out.astype(np.int32)


def write_bas(db_name: str, hash_size: int, repeat_flag: int,
              maximal_span: int, min_accessible_length: int) -> None:
    np.array([hash_size, repeat_flag, maximal_span, min_accessible_length],
             dtype=_I4).tofile(db_name + ".bas")


def append_seq_chunk(db_name: str, seq_sizes: np.ndarray, seqs: np.ndarray,
                     first: bool) -> None:
    with open(db_name + ".seq", "wb" if first else "ab") as f:
        np.array([len(seq_sizes)], dtype=_I4).tofile(f)
        seq_sizes.astype(_I4).tofile(f)
        np.array([len(seqs)], dtype=_I4).tofile(f)
        seqs.astype(np.uint8).tofile(f)


def append_ind_chunk(db_name: str, suffix_array: np.ndarray,
                     hash_start: np.ndarray, hash_end: np.ndarray,
                     first: bool) -> None:
    with open(db_name + ".ind", "wb" if first else "ab") as f:
        np.array([len(suffix_array)], dtype=_I4).tofile(f)
        suffix_array.astype(_I4).tofile(f)
        hash_start.astype(_I4).tofile(f)
        hash_end.astype(_I4).tofile(f)


def write_acc(db_name: str, accs: list[np.ndarray], conds: list[np.ndarray]) -> None:
    with open(db_name + ".acc", "wb") as f:
        for a, c in zip(accs, conds):
            np.array([len(a)], dtype=_I4).tofile(f)
            a.astype(_F4).tofile(f)
            np.array([len(c)], dtype=_I4).tofile(f)
            c.astype(_F4).tofile(f)


def write_nam(db_name: str, names: list[str]) -> None:
    with open(db_name + ".nam", "w") as f:
        for n in names:
            f.write(n + "\n")


def load_chunks(db_name: str, hash_size: int) -> list[DbChunk]:
    """Load every database page into memory
    (reference: src/db_reader.cpp:29-177)."""
    seq_raw = Path(db_name + ".seq").read_bytes()
    ind_raw = Path(db_name + ".ind").read_bytes()
    acc_raw = Path(db_name + ".acc").read_bytes()
    names_all = Path(db_name + ".nam").read_text().splitlines()

    chunks: list[DbChunk] = []
    spos = ipos = apos = 0
    name_idx = 0
    slots = hash_total_slots(hash_size)
    while spos < len(seq_raw):
        n_seqs = int(np.frombuffer(seq_raw, _I4, 1, spos)[0]); spos += 4
        sizes = np.frombuffer(seq_raw, _I4, n_seqs, spos).copy(); spos += 4 * n_seqs
        total = int(np.frombuffer(seq_raw, _I4, 1, spos)[0]); spos += 4
        seqs = np.frombuffer(seq_raw, np.uint8, total, spos).copy(); spos += total

        sa_n = int(np.frombuffer(ind_raw, _I4, 1, ipos)[0]); ipos += 4
        sa = np.frombuffer(ind_raw, _I4, sa_n, ipos).copy(); ipos += 4 * sa_n
        hstart = np.frombuffer(ind_raw, _I4, slots, ipos).copy(); ipos += 4 * slots
        hend = np.frombuffer(ind_raw, _I4, slots, ipos).copy(); ipos += 4 * slots

        accs, conds = [], []
        for _ in range(n_seqs):
            c1 = int(np.frombuffer(acc_raw, _I4, 1, apos)[0]); apos += 4
            accs.append(np.frombuffer(acc_raw, _F4, c1, apos).copy()); apos += 4 * c1
            c2 = int(np.frombuffer(acc_raw, _I4, 1, apos)[0]); apos += 4
            conds.append(np.frombuffer(acc_raw, _F4, c2, apos).copy()); apos += 4 * c2

        acc_off = np.zeros(n_seqs + 1, dtype=np.int64)
        cond_off = np.zeros(n_seqs + 1, dtype=np.int64)
        np.cumsum([len(a) for a in accs], out=acc_off[1:])
        np.cumsum([len(c) for c in conds], out=cond_off[1:])

        chunks.append(DbChunk(
            seq_sizes=sizes,
            seqs=seqs,
            start_pos=compute_start_pos(sizes),
            seq_length_rep=compute_seq_length_rep(seqs),
            suffix_array=sa,
            hash_start=hstart,
            hash_end=hend,
            acc=np.concatenate(accs) if accs else np.zeros(0, np.float32),
            cond=np.concatenate(conds) if conds else np.zeros(0, np.float32),
            acc_off=acc_off,
            cond_off=cond_off,
            names=names_all[name_idx : name_idx + n_seqs],
        ))
        name_idx += n_seqs
    return chunks
