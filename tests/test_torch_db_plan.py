"""The accessibility batch plan (models/db_gpu.py:plan_batches) on the
CPU, with the cards' limits passed in: a row set that the plain plan puts
in one batch keeps that plan exactly; otherwise every row appears once in
descending order, and each batch keeps within the devices' scan slots,
the memory budget of each shard and 2^31 elements a plane. Off a card the
plan is the plain one."""

import numpy as np
import pytest
import torch

from priblast_tpu_torch.models import db_gpu

# lognormal length models (median, sigma, min, max): lncRNA queries and
# targets, mRNA-like targets
LNC = (800, 0.7, 200, 10000)
MRNA = (2500, 0.6, 200, 20000)
BAND = 72
NT_BYTES = db_gpu.PEAK_PLANES * BAND * 4


def _lengths(model, n, seed):
    median, sigma, lo, hi = model
    x = np.random.default_rng(seed).lognormal(np.log(median), sigma, n)
    return [int(v) for v in np.clip(x, lo, hi).astype(np.int64)]


CASES = [
    # queries of a ris job: one plain batch, kept as it is
    ("lnc", 1, 132, 1, 24 << 30, 11),
    ("lnc", 2, 132, 1, 24 << 30, 12),
    ("lnc", 16, 132, 1, 24 << 30, 13),
    ("lnc", 40, 132, 1, 24 << 30, 7),
    # ... and two plain batches, made one
    ("lnc", 40, 132, 1, 24 << 30, 14),
    # 500-row pages on one card, two CTAs an SM, four cards, a budget that
    # binds at long rows
    ("lnc", 500, 132, 1, 24 << 30, 21),
    ("lnc", 500, 264, 1, 24 << 30, 22),
    ("lnc", 500, 132, 4, 24 << 30, 23),
    ("lnc", 500, 132, 1, (1 << 20) * NT_BYTES, 24),
    ("mrna", 500, 132, 1, 24 << 30, 31),
    ("mrna", 500, 264, 1, 24 << 30, 32),
    ("mrna", 500, 132, 4, 24 << 30, 33),
    ("mrna", 500, 132, 1, (1 << 20) * NT_BYTES, 34),
    ("mrna", 500, 132, 2, 2 << 30, 35),
    ("mrna", 500, 100, 1, 24 << 30, 36),
]


@pytest.mark.parametrize("model,n,slots,shards,budget,seed", CASES)
def test_plan_keeps_rows_order_slots_and_budget(model, n, slots, shards,
                                                budget, seed):
    lengths = _lengths({"lnc": LNC, "mrna": MRNA}[model], n, seed)
    limits = db_gpu.Limits(slots, budget, NT_BYTES, BAND, shards)
    plain = list(db_gpu.plan_batches(lengths))
    plan = list(db_gpu.plan_batches(lengths, limits))
    if n <= 16 or seed == 7:
        assert len(plain) == 1
    if len(plain) == 1:
        assert plan == plain
    else:
        assert len(plan) < len(plain)
    order = [i for group, _, _ in plan for i in group]
    assert sorted(order) == list(range(n))
    got = [lengths[i] for i in order]
    assert got == sorted(lengths, reverse=True)
    for group, bsz, padded in plan:
        assert 1 <= len(group) <= bsz <= slots * shards
        assert padded == db_gpu.bucket_length(lengths[group[0]])
        assert -(-bsz // shards) * padded * NT_BYTES <= budget
        assert (padded + 1) * bsz * BAND < 1 << 31
    # off a card (any device of a batch not a card) the plan is the plain
    # one
    devs = [torch.device("cpu")] * shards
    assert db_gpu.batch_limits(devs, BAND, torch.float32) is None
    devs[-1:] = [torch.device("cuda", 0)]
    if shards > 1:
        assert db_gpu.batch_limits(devs, BAND, torch.float32) is None


SHARER_CASES = [
    # cards, processes, this process, hosts by process (None: one host),
    # processes on its card
    (4, 4, 2, None, 1),
    (1, 4, 3, None, 4),
    (2, 5, 0, None, 3),
    (2, 5, 1, None, 2),
    # two hosts of 4 cards, 4 processes each: a card each
    (4, 8, 5, ["a"] * 4 + ["b"] * 4, 1),
    # ... the hosts taking every other process: two on cards 0 and 2
    (4, 8, 4, ["a", "b"] * 4, 2),
    # no group
    (1, 1, 0, None, 1),
]


@pytest.mark.parametrize("cards,procs,pidx,hosts,want", SHARER_CASES)
def test_budget_is_shared_by_the_processes_on_a_card(monkeypatch, cards,
                                                     procs, pidx, hosts,
                                                     want):
    """multihost.card_sharers under a stubbed group and card count, and
    batch_limits' budget: half of what the card can give (free memory and
    the allocator's unused blocks), at most BUDGET_CAP, over the shards on
    the card and the processes that share it."""
    import torch.distributed as tdist

    from priblast_tpu_torch.ops import access_scan
    from priblast_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(tdist, "is_available", lambda: True)
    monkeypatch.setattr(tdist, "is_initialized", lambda: procs > 1)
    monkeypatch.setattr(tdist, "get_rank", lambda: pidx)
    monkeypatch.setattr(tdist, "get_world_size", lambda: procs)
    monkeypatch.setattr(multihost, "_HOSTS", list(hosts or []))
    assert multihost.card_sharers() == want

    gib = 1 << 30
    mem = {"free": 30 * gib, "reserved": 10 * gib, "allocated": 4 * gib}
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: (mem["free"], 80 * gib))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda dev: mem["reserved"])
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda dev: mem["allocated"])
    monkeypatch.setattr(access_scan, "slots", lambda dev, dtype, band: 132)
    card = torch.device("cuda", 0)
    lim = db_gpu.batch_limits([card, card], BAND, torch.float32)
    assert lim == db_gpu.Limits(132, 18 * gib // (2 * want), NT_BYTES, BAND,
                                2)
    mem["free"] = 70 * gib
    lim = db_gpu.batch_limits([card], BAND, torch.float64)
    assert lim.budget == db_gpu.BUDGET_CAP // want
    assert lim.nt_bytes == 2 * NT_BYTES


@pytest.mark.parametrize("total,free,want", [
    (85_000_000_000, 1 << 30, 1 << 23),
    (80_000_000_000, 70 << 30, 1 << 22),
    (4 << 30, 4 << 30, 1 << 21),
])
def test_search_caps_take_a_share_of_the_whole_card(monkeypatch, total,
                                                    free, want):
    """search/pipeline.py:_batch_cap reads the card through the same
    helper (dist.card_budget) as the batch plan, a share of its whole
    memory, whatever is free: the fused stage's cap (200 B a pair, 2% of
    the card, 2^21..2^23), and `lo` off a card."""
    from priblast_tpu_torch.search import pipeline

    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (free, total))
    card = torch.device("cuda", 0)
    assert pipeline._batch_cap(card, 200, 0.02, 1 << 21, 1 << 23) == want
    assert pipeline._batch_cap(torch.device("cpu"), 200, 0.02, 1 << 21,
                               1 << 23) == 1 << 21
