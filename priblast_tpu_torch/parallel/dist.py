"""Several devices in one process.

The reference distributes sequences over MPI ranks (SURVEY §2/L4). Within
one process the port splits each device batch over a list of torch
devices instead:

- `local_devices` gives a process its devices: every card it owns, or the
  CPU (`--device cpu`);
- `split_rows` cuts a batch into contiguous slices, one per device (the
  shards), whose sizes differ by at most one; a slice may be empty, and an
  empty slice launches nothing;
- `run_sharded` runs each shard on its own host thread (inside
  `torch.cuda.device` for a card), since every stage waits on its card
  when it copies its results back: one thread running the shards in turn
  would run the cards one after another. Results come back in shard
  order, so concatenating them keeps the batch's order.

The device stages on this path (accessibility/batched.py:BatchedRaccess,
search/fused.py:fused_stage, search/pipeline.py:gapped_stage) use these.
There is no collective: every device computes its own rows (base pairs
never span sequences, pairs and hits are independent), and the host
concatenates. `sharded_accessibility` and `dryrun_multichip` check the
split: bit for bit where every shard is on one device type, since each
stage gives a row the same bits in any batch.
"""

from __future__ import annotations

import tempfile
import threading

import numpy as np
import torch

from priblast_tpu_torch.utils.params import DEVICES

# limits of the dry run where shards are on different device types: the
# float32 engine's noise in kcal/mol (accessibility and energies);
# integers exact
MIXED_TOL = 2e-3


def local_devices(device: str, pidx: int = 0, pcount: int = 1) -> list:
    """The devices of process `pidx` of `pcount` on this host: [cpu] for
    `cpu`; for `cuda`, with C visible cards, the cards c with c mod pcount
    == pidx when C >= pcount (one process takes every card), else
    [cuda:(pidx mod C)] (processes share the cards). No card is an error,
    never a silent switch to the CPU."""
    if device not in DEVICES:
        raise ValueError(f"unknown device {device!r}")
    if device == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the device engine (--engine gpu, and --engine auto, the "
            "default) needs a CUDA device and none is available; pass "
            "--device cpu to run the device engine on the CPU, or "
            "--engine exact for the host engine")
    n_cards = torch.cuda.device_count()
    if n_cards >= pcount:
        return [torch.device("cuda", c) for c in range(n_cards)
                if c % pcount == pidx]
    return [torch.device("cuda", pidx % n_cards)]


def card_sharers(pidx: int, pcount: int, hosts=None) -> int:
    """The processes of `pcount` that share process `pidx`'s card under
    local_devices' rule: 1 where each takes cards of its own, else those
    on its host whose index falls on its card. `hosts` names each
    process's host (one host where None)."""
    n_cards = torch.cuda.device_count()
    if n_cards >= pcount:
        return 1
    hosts = hosts or [None] * pcount
    return sum(hosts[q] == hosts[pidx] and q % n_cards == pidx % n_cards
               for q in range(pcount))


def card_budget(device, frac: float, *, spare: bool = False) -> int:
    """Bytes of the card `device` that a batch may take: `frac` of its
    memory, or with `spare` of what it can still give this process (its
    free memory and the blocks PyTorch's allocator holds unused, so that
    what earlier batches left cached does not shrink the budget). 0 off a
    card."""
    if device.type != "cuda":
        return 0
    free, total = torch.cuda.mem_get_info(device)
    if spare:
        total = (free + torch.cuda.memory_reserved(device)
                 - torch.cuda.memory_allocated(device))
    return int(total * frac)


def device_list(devices) -> list:
    """`devices` (one device or name, or a list of them) as a list of
    torch devices, each card with its index."""
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    out = []
    for dev in devices:
        dev = torch.device(dev)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    if not out:
        raise ValueError("no device given")
    return out


def distinct(devices) -> list:
    """The distinct devices of a list, in order of first appearance."""
    return list(dict.fromkeys(device_list(devices)))


def split_rows(n: int, k: int) -> list[tuple[int, int]]:
    """n rows cut into k contiguous [lo, hi) slices whose sizes differ by
    at most one, the larger first; slices are empty where n < k."""
    if k < 1 or n < 0:
        raise ValueError(f"cannot split {n} rows into {k} slices")
    q, r = divmod(n, k)
    bounds = np.cumsum([0] + [q + (i < r) for i in range(k)])
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(k)]


# CPU shards take turns: they share the host's cores, which PyTorch's own
# threads already use, and Python threads interleaving the plain
# versions' many small ops ran ~7x slower than the same shards in turn
# (8 one-row shards of tiny_db.fa: 53 s against 7.6 s)
_cpu_turn = threading.Lock()


def _on(device):
    if device.type == "cuda":
        return torch.cuda.device(device)
    return _cpu_turn


def run_sharded(fn, shards: list) -> list:
    """fn(*shard) for each shard (a tuple whose first item is its device),
    each on its own host thread, inside `torch.cuda.device` for a card and
    in turn with the other CPU shards for the CPU (one shard runs on the
    calling thread). Returns the results in shard order. Once every thread
    has joined, the first failed shard's exception (in shard order) is
    raised; a failed shard is not run again anywhere."""
    if len(shards) == 1:
        with _on(shards[0][0]):
            return [fn(*shards[0])]
    results: list = [None] * len(shards)
    errors: list = [None] * len(shards)

    def work(i):
        try:
            with _on(shards[i][0]):
                results[i] = fn(*shards[i])
        except BaseException as e:  # re-raised by the calling thread
            errors[i] = e

    threads = [threading.Thread(target=work, args=(i,), name=f"shard-{i}")
               for i in range(len(shards))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    return results


def sharded_accessibility(devices, w_span: int, min_acc_len: int,
                          codes: np.ndarray, lengths: np.ndarray,
                          dtype: str = "float32"):
    """Accessibility of a [B, n_max] batch split over `devices`: (acc,
    cond, total), acc and cond float32 [B, n_max] as BatchedRaccess.run
    gives them, and total the mean accessibility, sum(acc) /
    max(sum(lengths), 1), each shard's sum added on the host in shard
    order."""
    from priblast_tpu_torch.accessibility.batched import BatchedRaccess

    devices = device_list(devices)
    acc, cond = BatchedRaccess(w_span, min_acc_len, dtype,
                               devices=devices).run(codes, lengths)
    acc_sum = 0.0
    for lo, hi in split_rows(len(acc), len(devices)):
        acc_sum += float(acc[lo:hi].sum(dtype=np.float64))
    return acc, cond, acc_sum / max(int(np.sum(lengths)), 1)


# ---- the dry run ---------------------------------------------------------

def _tiny_workload(tmpdir: str):
    """A tiny db (6 sequences of 140-190 nt, exact engine) and 4 queries
    of 160-220 nt with their host accessibilities, from random.Random(11)."""
    import random

    from priblast_tpu_torch.models import db as db_model
    from priblast_tpu_torch.ops import native
    from priblast_tpu_torch.utils import alphabet, store
    from priblast_tpu_torch.utils.params import DbParams, RisParams

    rng = random.Random(11)

    def seq(n):
        return "".join(rng.choice("ACGU") for _ in range(n))

    fa = f"{tmpdir}/db.fa"
    with open(fa, "w") as f:
        for i in range(6):
            f.write(f">t{i}\n{seq(140 + 10 * i)}\n")
    db_model.run(DbParams(input=fa, db_name=f"{tmpdir}/db",
                          algorithm="block", engine="exact"))
    chunks = store.load_chunks(f"{tmpdir}/db", 8)

    p = RisParams(input="x", output="y", db_name=f"{tmpdir}/db",
                  algorithm="block")
    p.load_db_params()
    queries = []
    for i in range(4):
        s = seq(160 + 20 * i)
        q_acc, q_cond = native.raccess(alphabet.access_codes(s),
                                       p.maximal_span,
                                       p.min_accessible_length)
        q_enc = alphabet.encode_query(s, p.repeat_flag)
        queries.append((q_enc, native.sa_build(q_enc), q_acc, q_cond))
    return p, chunks, queries


def _run_pipeline(p, chunks, queries, devices):
    from priblast_tpu_torch.search import pipeline as pl

    qpack = pl.QueryPack([q[0] for q in queries], [q[2] for q in queries],
                         [q[3] for q in queries], [q[1] for q in queries],
                         devices=devices)
    dbpack = pl.DbPack(chunks, devices=devices)
    return pl.search_all(p, chunks, queries, qpack, dbpack, devices=devices)


def _held(name: str, a, b, exact: bool) -> float:
    """Raise AssertionError unless a and b are equal (bit for bit where
    `exact`, else integers equal and floats within MIXED_TOL); returns
    the largest difference."""
    a = np.ascontiguousarray(np.atleast_1d(a))
    b = np.ascontiguousarray(np.atleast_1d(b))
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{name}: {a.shape} {a.dtype} against "
                             f"{b.shape} {b.dtype}")
    if exact or a.dtype.kind != "f":
        if not np.array_equal(a.view(np.uint8), b.view(np.uint8)):
            raise AssertionError(f"{name} differs")
        return 0.0
    diff = float(np.abs(a.astype(np.float64) - b).max()) if a.size else 0.0
    if not diff <= MIXED_TOL:
        raise AssertionError(f"{name} differs by {diff} > {MIXED_TOL}")
    return diff


def dryrun_multichip(devices) -> dict:
    """The device path split over `devices` against the same path on
    `devices[0]` alone, on a tiny workload: the accessibility of a random
    [2 k, 96] batch (window 48, d 5), then the full device chain of `ris`
    (fused stage, mid, gapped kernel, finish) with the packs on every
    device. Every field, energies included, is held bit for bit where all
    the devices are of one type, else integers exactly and floats within
    MIXED_TOL. Raises AssertionError on a difference; returns the hit
    count, the largest float differences and whether the check was exact."""
    devices = device_list(devices)
    one = devices[:1]
    exact = len({dev.type for dev in devices}) == 1
    out = dict(devices=[str(dev) for dev in devices], exact=exact)
    with tempfile.TemporaryDirectory() as td:
        p, chunks, queries = _tiny_workload(td)

        B, n_max = 2 * len(devices), 96
        rng = np.random.default_rng(1)
        codes = rng.integers(1, 5, (B, n_max)).astype(np.uint8)
        lengths = np.full(B, n_max, dtype=np.int32)
        acc1, cond1, total1 = sharded_accessibility(one, 48, 5, codes,
                                                    lengths)
        acc2, cond2, total2 = sharded_accessibility(devices, 48, 5, codes,
                                                    lengths)
        out["acc_diff"] = max(_held("acc", acc1, acc2, exact),
                              _held("cond", cond1, cond2, exact))
        out["total_diff"] = _held("total", np.float64(total1),
                                  np.float64(total2), exact)

        stream1, fin1 = _run_pipeline(p, chunks, queries, one)
        stream2, fin2 = _run_pipeline(p, chunks, queries, devices)
        if stream1.groups != stream2.groups:
            raise AssertionError("the hit streams' groups differ")
        n_hits, e_diff = 0, 0.0
        for a, b in zip(fin1, fin2):
            if set(a) != set(b):
                raise AssertionError("the finished fields differ")
            for k in sorted(a):
                e_diff = max(e_diff, _held(k, a[k], b[k], exact))
            n_hits += len(a["q_sp"])
        if n_hits == 0:
            raise AssertionError("the dry run's workload produced no hits")
        out.update(hits=n_hits, energy_diff=e_diff)
    return out
