"""Frozen copies of the traffic arithmetic: `markov_batch` (the
first-order Markov chain of transcript-like composition: GC ~0.47, CpG
odds ~0.3, UpA ~0.75) and the lognormal length model of GENCODE-like
transcripts, copied from the repository's tools/seqgen.py and
tools/gencode_scale.py so that a change there cannot move the
benchmark."""

from __future__ import annotations

import numpy as np

# base order A, C, G, U
_BASE_FREQ = np.array([0.265, 0.235, 0.245, 0.255])
# dinucleotide odds ratios rho[x, y] ~ f(xy) / (f(x) f(y)), human
# transcript-like: CpG strongly depleted, UpA mildly depleted, mirrored
# mild enrichments elsewhere
_ODDS = np.array([
    #  A     C     G     U
    [1.00, 1.05, 1.05, 0.95],   # A·
    [1.10, 1.05, 0.30, 1.10],   # C·  (CpG depletion)
    [0.95, 1.05, 1.05, 1.00],   # G·
    [0.75, 1.10, 1.10, 1.00],   # U·  (UpA depletion)
])
_BASES = np.frombuffer(b"ACGU", dtype=np.uint8)


def _transition() -> np.ndarray:
    t = _ODDS * _BASE_FREQ[None, :]
    return t / t.sum(axis=1, keepdims=True)


def markov_batch(rng: np.random.Generator, lengths) -> list[np.ndarray]:
    """Draw len(lengths) sequences as ACGU byte arrays, vectorized across
    the batch (one categorical draw per position over all sequences)."""
    lengths = np.asarray(lengths, np.int64)
    n = len(lengths)
    n_max = int(lengths.max()) if n else 0
    tcum = np.cumsum(_transition(), axis=1)
    fcum = np.cumsum(_BASE_FREQ)
    u = rng.random((n,))
    state = np.searchsorted(fcum, u).clip(0, 3)
    out = np.zeros((n, n_max), np.uint8)
    out[:, 0] = state
    urand = rng.random((n_max, n))
    for i in range(1, n_max):
        row = tcum[state]
        state = (urand[i][:, None] > row).sum(axis=1).clip(0, 3)
        out[:, i] = state
    return [_BASES[out[i, : lengths[i]]] for i in range(n)]


def lognormal_lengths(rng, n, median, sigma, lo, hi):
    x = rng.lognormal(mean=np.log(median), sigma=sigma, size=n)
    return np.clip(x, lo, hi).astype(np.int64)
