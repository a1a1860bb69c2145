"""Device path of the db step: batched accessibility over length buckets.

Sequences are sorted by length (descending — guided LPT like the
reference's scheduling, src/utils.cpp:56-63), grouped into batches, and
each batch is padded to a bucketed maximum length. Geometric buckets keep
the padding waste bounded (<= 12.5%) and the number of distinct batch
shapes small.
"""

from __future__ import annotations

import numpy as np

from priblast_tpu_torch.utils import alphabet


def bucket_length(n: int, quantum: int = 256) -> int:
    """Round a length up to a bucket boundary: 8 steps per octave (<=12.5%
    length padding), floored at `quantum`."""
    step = max(quantum, 1 << max((max(n, 2) - 1).bit_length() - 3, 0))
    return max(quantum, (n + step - 1) // step * step)


def adaptive_batch(bucket: int, cap: int = 128) -> int:
    """Batch size targeting ~128k padded nucleotides per device batch
    (keeps the device footprint flat across buckets), power-of-two
    quantized."""
    b = max(8, min(cap, (1 << 17) // max(bucket, 1)))
    p = 8
    while p * 2 <= b:
        p *= 2
    return p


def plan_batches(lengths: list[int]):
    """Yield (indices, batch_size, padded_len) from descending-length order."""
    order = sorted(range(len(lengths)), key=lambda i: -lengths[i])
    k = 0
    while k < len(order):
        bucket = bucket_length(lengths[order[k]])
        bsz = adaptive_batch(bucket)
        # tail trim: shrink the final batch to the next power of two that
        # still covers the remainder (fewer all-padding rows)
        rem = len(order) - k
        while bsz // 2 >= max(rem, 8):
            bsz //= 2
        yield order[k: k + bsz], bsz, bucket
        k += bsz


def compute_accessibilities(seqs: list[str], w: int, d: int, *, devices):
    """Per-sequence float32 accessibility via the batched device engine,
    each batch split over `devices`. Returns lists (accs, conds) in the
    original sequence order, matching the exact engine's layout (acc of
    length n - d + 1, cond of length n)."""
    from priblast_tpu_torch.accessibility.batched import BatchedRaccess

    engine = BatchedRaccess(w, d, devices=devices)
    n = len(seqs)
    accs: list[np.ndarray | None] = [None] * n
    conds: list[np.ndarray | None] = [None] * n
    lengths = [len(s) for s in seqs]

    for group, bsz, padded in plan_batches(lengths):
        codes = np.zeros((bsz, padded), np.uint8)
        lens = np.zeros(bsz, np.int32)
        for bi, idx in enumerate(group):
            codes[bi, : lengths[idx]] = alphabet.access_codes(seqs[idx])
            lens[bi] = lengths[idx]
        acc, cond = engine.run(codes, lens)
        for bi, idx in enumerate(group):
            ln = lengths[idx]
            accs[idx] = acc[bi, : max(ln - d + 1, 0)].copy()
            conds[idx] = cond[bi, :ln].copy()
    return accs, conds
