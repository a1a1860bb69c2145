"""The general traffic generator: sequences of a configuration's length
models from a seed, written as FASTA.

Lengths come from a fixed generator (the configuration's `length_seed`),
so every seed gets the same set of sizes; `--seed` draws their order and
the bases. Bases come from the frozen Markov chain, drawn for many
sequences at once as a few long chains cut to the lengths."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pbench import seqgen


def lengths(model: dict, n: int, rng) -> np.ndarray:
    return seqgen.lognormal_lengths(rng, n, model["median"], model["sigma"],
                                    model["min"], model["max"])


def sequences(rng, lens, chains: int = 1024,
              block_nt: int = 1 << 24) -> list[str]:
    """Markov sequences of the given lengths, made as at most `chains`
    parallel chains per block of about `block_nt` nucleotides."""
    lens = [int(x) for x in lens]
    out: list[str] = []
    i = 0
    while i < len(lens):
        j, tot = i, 0
        while j < len(lens) and (tot < block_nt or j == i):
            tot += lens[j]
            j += 1
        c = min(chains, j - i)
        per = -(-tot // c)
        flat = np.concatenate(seqgen.markov_batch(rng, [per] * c))
        at = 0
        for n in lens[i:j]:
            out.append(flat[at: at + n].tobytes().decode("ascii"))
            at += n
        i = j
    return out


def write_fasta(path: Path, names, seqs, width: int = 70) -> None:
    with open(path, "w") as f:
        for name, s in zip(names, seqs):
            f.write(">" + name + "\n")
            for k in range(0, len(s), width):
                f.write(s[k: k + width] + "\n")
