"""Device path of the db step: batched accessibility over length buckets.

Sequences are sorted by length (descending — guided LPT like the
reference's scheduling, src/utils.cpp:56-63), grouped into batches, and
each batch is padded to a bucketed maximum length. Geometric buckets keep
the padding waste bounded (<= 12.5%) and the number of distinct batch
shapes small.

The column scans run a CTA per row, and every CTA walks all the batch's
columns one dependent step after another, so a launch lasts as long
whether it holds 8 rows or as many as the card runs at once. On a card a
batch therefore holds as many rows as its devices hold scan CTAs at once
(`Limits`), within a budget of device memory; off a card the plan is the
plain one (`adaptive_batch` rows a batch). A row set that the plain plan
puts in one batch keeps that batch wherever the card takes at least as
many rows at its bucket, as the H100 does at every bucket. Each row gets
the same bits in any batch (accessibility/batched.py:_two_rows), so the
plan moves no output.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from priblast_tpu_torch.parallel import dist, multihost
from priblast_tpu_torch.utils import alphabet
from priblast_tpu_torch.utils import profiling as prof

# [N+1, B, band] planes of the working dtype alive at a batch's peak, the
# outside scan: the inside and the outside grids (15 each, and 2 of bool
# each, counted as one more plane), the inside scan's 6 and the outside
# scan's 5
PEAK_PLANES = 42
# at most this much device memory per card for one batch
BUDGET_CAP = 24 << 30
# every [N+1, B, band] plane of a batch has fewer elements than this
PLANE_ELEMS = 1 << 31


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


class Limits(NamedTuple):
    """What the cards allow a batch split over `shards` devices."""
    slots: int     # scan CTAs each device holds at once
    budget: int    # bytes of device memory each shard may take
    nt_bytes: int  # bytes per padded nt of a shard at its peak
    band: int      # the planes' last axis
    shards: int

    def rows(self, bucket: int) -> int:
        """Rows of a batch padded to `bucket`: every shard's rows within
        its slots and budget, every plane under PLANE_ELEMS; at least 1."""
        per = min(self.slots, self.budget // (bucket * self.nt_bytes))
        planes = (PLANE_ELEMS - 1) // ((bucket + 1) * self.band)
        return max(1, min(self.shards * per, planes))


def batch_limits(devices, band: int, dtype) -> Limits | None:
    """The Limits of a batch split over `devices`, or None unless every
    one is a card. A card's budget is half the memory it can give now
    (dist.card_budget), at most BUDGET_CAP, shared by the shards it holds
    and the processes that share it."""
    if any(dev.type != "cuda" for dev in devices):
        return None
    from priblast_tpu_torch.ops import access_scan

    slots = min(access_scan.slots(dev, dtype, band) for dev in devices)
    sharers = multihost.card_sharers()
    budget = min(min(dist.card_budget(dev, 0.5, spare=True), BUDGET_CAP)
                 // (devices.count(dev) * sharers) for dev in set(devices))
    item = torch.empty((), dtype=dtype).element_size()
    return Limits(slots, budget, PEAK_PLANES * band * item, band,
                  len(devices))


def plan_batches(lengths: list[int], limits: Limits | None = None):
    """Yield (indices, batch_size, padded_len) from descending-length
    order, each batch padded to its first row's bucket_length. A batch
    holds `limits.rows` rows where limits are given, else adaptive_batch;
    the last batch shrinks to the least power of two >= max(its rows, 8)
    under that (fewer all-padding rows)."""
    order = sorted(range(len(lengths)), key=lambda i: -lengths[i])
    cap = limits.rows if limits is not None else adaptive_batch
    k = 0
    while k < len(order):
        bucket = bucket_length(lengths[order[k]])
        bsz = cap(bucket)
        rem = len(order) - k
        if rem < bsz:
            bsz = min(bsz, 1 << (max(rem, 8) - 1).bit_length())
        yield order[k: k + bsz], bsz, bucket
        k += bsz


def run_planned(engine, seqs, lengths, idxs):
    """Accessibility of the sequences `idxs` through `engine` (an
    accessibility.batched.BatchedRaccess) in planned batches: yields (idx,
    acc, cond), each row's [padded] float32 views of its batch's output.
    Counts the batches, their rows and their devices' slots."""
    limits = batch_limits(engine.devices, engine.w + 2, engine.dtype)
    for group, bsz, padded in plan_batches([lengths[i] for i in idxs],
                                           limits):
        sel = [idxs[g] for g in group]
        codes = np.zeros((bsz, padded), np.uint8)
        lens = np.zeros(bsz, np.int32)
        for bi, idx in enumerate(sel):
            codes[bi, : lengths[idx]] = alphabet.access_codes(seqs[idx])
            lens[bi] = lengths[idx]
        prof.count("access.batches")
        prof.count("access.rows", len(sel))
        if limits is not None:
            prof.count("access.slots", limits.slots * limits.shards)
        acc, cond = engine.run(codes, lens)
        for bi, idx in enumerate(sel):
            yield idx, acc[bi], cond[bi]


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
    for idx, acc, cond in run_planned(engine, seqs, lengths, range(n)):
        ln = lengths[idx]
        accs[idx] = acc[: max(ln - d + 1, 0)].copy()
        conds[idx] = cond[:ln].copy()
    return accs, conds
