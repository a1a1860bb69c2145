"""Hit batches for the ungapped kernel's tests (tests/test_torch_kernel_emu.py
in emulation, tests/test_torch_gpu.py on the card): CPU tensors in the
argument order of ops/ungapped_extend.py:ungapped_extend, made with numpy
from a seed. A part is (the nine int64 columns q_sp, db_sp, length,
dbseq_start, qb, qab, dbb, aoff, coff; acc_e; hyb_e; (q_enc, q_acc,
q_cond); (db_seq, db_acc, db_cond)).
"""

import numpy as np
import torch

COLS = ("q_sp", "db_sp", "q_len", "dbseq_start", "qb", "qab", "dbb", "aoff",
        "coff")


def args_of(part, d=5, dropout=5):
    """The arguments of ungapped_extend for a part."""
    cols, acc_e, hyb_e, qbufs, dbufs = part
    return (*cols[:4], acc_e, hyb_e, *cols[4:], qbufs, dbufs, d, dropout)


def stage1_part(soa, qbufs, dbufs):
    """A part from a stage-1 hit stream's columns (pipeline.HitStream.soa,
    with the bases of pipeline._hit_bases) over the packs' flat buffers."""
    cols = tuple(torch.as_tensor(soa[k]).long().contiguous() for k in COLS)
    return (cols, torch.as_tensor(soa["acc_e"]).float().contiguous(),
            torch.as_tensor(soa["hyb_e"]).float().contiguous(),
            tuple(qbufs), tuple(dbufs))


def select(part, idx):
    """The hits `idx` of a part, over the same buffers."""
    cols, acc_e, hyb_e, qbufs, dbufs = part
    return (tuple(c[idx].contiguous() for c in cols),
            acc_e[idx].contiguous(), hyb_e[idx].contiguous(), qbufs, dbufs)


def tie_batch(n_hits=20000, length=24, seed=1):
    """Random query/db windows around a G-C seed with zero accessibility,
    so every energy change is a loop energy: some hits reach an earlier
    minimum again exactly (a loop energy and a later one cancel)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(2, 6, (n_hits, length))
    d = rng.integers(2, 6, (n_hits, length))
    mid = length // 2
    q[:, mid], d[:, mid] = 4, 3
    base = np.arange(n_hits) * (length + 1) + 1
    qbuf = np.zeros(n_hits * (length + 1) + 8, np.int64)
    dbuf = np.zeros_like(qbuf)
    qbuf[base[:, None] + np.arange(length)] = q
    dbuf[base[:, None] + np.arange(length)] = d
    zero = torch.zeros(len(qbuf), dtype=torch.float32)

    def i64(a):
        return torch.as_tensor(np.broadcast_to(a, (n_hits,)).copy(),
                               dtype=torch.int64)

    cols = (i64(mid), i64(mid), i64(1), i64(length // 4), i64(base),
            i64(base), i64(base), i64(0), i64(0))
    return (cols, torch.zeros(n_hits), torch.full((n_hits,), -4.0),
            (torch.as_tensor(qbuf), zero, zero),
            (torch.as_tensor(dbuf), zero, zero))


def join(parts):
    """One part over concatenated buffers: every part's hits in order,
    their base columns moved to their part's place in each buffer (q_acc
    and q_cond are padded to one length per part, since qab indexes
    both)."""
    cols, acc, hyb = [[] for _ in COLS], [], []
    bufs = [[] for _ in range(6)]
    sizes = [0] * 6   # q_enc, q_acc/q_cond, -, db_seq, db_acc, db_cond
    for c, acc_e, hyb_e, (q_enc, q_acc, q_cond), (db_seq, db_acc,
                                                  db_cond) in parts:
        n_qa = max(len(q_acc), len(q_cond))

        def pad(x, n):
            return torch.cat([x, x.new_zeros(n - len(x))])

        shift = {4: sizes[0], 5: sizes[1], 6: sizes[3], 7: sizes[4],
                 8: sizes[5]}
        for k, x in enumerate(c):
            cols[k].append(x + shift.get(k, 0))
        acc.append(acc_e)
        hyb.append(hyb_e)
        for k, x in enumerate((q_enc, pad(q_acc, n_qa), pad(q_cond, n_qa),
                               db_seq, db_acc, db_cond)):
            bufs[k].append(x)
        sizes = [sizes[0] + len(q_enc), sizes[1] + n_qa, 0,
                 sizes[3] + len(db_seq), sizes[4] + len(db_acc),
                 sizes[5] + len(db_cond)]
    flat = [torch.cat(b).contiguous() for b in bufs]
    return (tuple(torch.cat(c).contiguous() for c in cols),
            torch.cat(acc).contiguous(), torch.cat(hyb).contiguous(),
            tuple(flat[:3]), tuple(flat[3:]))


def mixed_batch(long_part, long_steps, short_part, n_long=96, every=4):
    """The n_long hits of long_part with the most steps (long_steps, from
    search/ungapped.py:extend_steps) among short_part's hits, one long hit
    in every `every`, so that long and short hits share warps: lanes stop,
    or go on to the right phase, while their neighbours still run."""
    idx = torch.argsort(long_steps, descending=True, stable=True)[:n_long]
    n_short = n_long * (every - 1)
    joined = join([select(long_part, idx),
                   select(short_part, torch.arange(n_short))])
    order = torch.arange(n_long + n_short).view(-1, every)
    order[:, 0] = torch.arange(n_long)
    order[:, 1:] = n_long + torch.arange(n_short).view(-1, every - 1)
    return select(joined, order.reshape(-1))


def clamp_batch(n_hits=256, n=40, seed=3):
    """Hits over short buffers with no pad at either end, whose steps read
    past both ends of every flat buffer (the loads clamp there): seeds at
    the buffers' first and last positions, bases from a few entries before
    a buffer's start to a few past its end. Both buffers end in A, so a
    right phase that runs past the end meets an unpaired A-A and stops at
    the dropout; a few pads (0) inside stop phases early."""
    rng = np.random.default_rng(seed)

    def chars(m):
        c = rng.integers(2, 6, m)
        c[rng.random(m) < 0.04] = 0
        c[0], c[-1] = rng.integers(2, 6), 2
        return torch.as_tensor(c, dtype=torch.int64)

    def acc(m):
        return torch.as_tensor(rng.normal(0.0, 0.6, m), dtype=torch.float32)

    q_enc, db_seq = chars(n), chars(n + 7)
    bufs = (q_enc, acc(n + 3), acc(n - 2))
    dbufs = (db_seq, acc(n + 11), acc(n + 5))
    half = n_hits // 2
    length = rng.integers(1, 5, n_hits)
    at_start = rng.integers(0, 4, half)
    at_end = n - length[half:] - rng.integers(-2, 3, n_hits - half)
    q_sp = np.concatenate([at_start, at_end])
    db_sp = np.concatenate([rng.integers(0, 4, half),
                            n + 7 - length[half:]
                            - rng.integers(-2, 3, n_hits - half)])

    def i64(a):
        return torch.as_tensor(a, dtype=torch.int64)

    cols = (i64(q_sp), i64(db_sp), i64(length),
            i64(rng.integers(-3, n + 6, n_hits)),
            *(i64(rng.integers(-4, 8, n_hits)) for _ in range(3)),
            *(i64(rng.integers(-4, 14, n_hits)) for _ in range(2)))
    acc_e = torch.as_tensor(rng.normal(0.5, 0.5, n_hits), dtype=torch.float32)
    hyb_e = torch.as_tensor(rng.normal(-3.0, 1.0, n_hits),
                            dtype=torch.float32)
    return cols, acc_e, hyb_e, bufs, dbufs
