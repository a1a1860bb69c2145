"""The reference's units of work, as functions a process pool can run:
the accessibility of one sequence, the search of one pair."""

from __future__ import annotations

import numpy as np

from . import raccess, search

_ACCESS = np.zeros(256, np.uint8)
for _c, _v in zip(b"ACGTU", (1, 2, 3, 4, 4)):
    _ACCESS[_c] = _v

_MODELS: dict = {}


def accessibility(args):
    """(seq, w, d) -> (acc, cond), float32: acc of the len - d + 1 windows
    of d nucleotides, cond of every position, in kcal/mol."""
    seq, w, d = args
    key = (w, d)
    if key not in _MODELS:
        _MODELS[key] = raccess.LinearRaccess(w, d)
    codes = _ACCESS[np.frombuffer(seq.encode("ascii"), np.uint8)]
    acc, cond = _MODELS[key].run(codes)
    return acc[: max(len(seq) - d + 1, 0)], cond


def search_pair(args):
    """(qseq, tseq, (qacc, qcond), (tacc, tcond), params) -> hits."""
    qseq, tseq, (qacc, qcond), (tacc, tcond), p = args
    return search.search_pair(qseq, tseq, qacc, qcond, tacc, tcond, p)


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest, ties to even), kept
    in float32: the check's control, the precision below the
    configuration's float32."""
    return search.bfloat16(x).astype(np.float32)
