"""Back-to-back `db` builds, one page each.

Set-up makes the pool of pages from the seed (`pool_pages` pages of the
configuration's page size, lengths from the target length model) as
FASTA files, and warms up with one build of a page of its own. The window
builds the pages one after another, each `models.db.run` (engine gpu,
the configuration's chunk size) into the run's temporary directory,
until `--seconds` have passed; the last build runs to its end and the
window ends with it. A window that outruns the pool builds its pages
again from the first.

The check, against the plain reference: `check_pages` pages drawn from
the seed among those the window built, their .seq bytes, suffix array
and k-mer hash exactly; and the accessibility and conditional
accessibility of `check_seqs` sequences drawn from the same pages."""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from pbench import refpool, traffic
from pbench.window import measure


def _params(run):
    from priblast_tpu_torch.utils.params import DbParams

    return DbParams, dict(run.config["db"], engine="gpu",
                          device=run.device.type)


def setup(run):
    from priblast_tpu_torch.models import db as pdb

    cfg, tr = run.config, run.traffic
    size = cfg["targets"]["count"]
    fixed = np.random.default_rng(cfg["length_seed"])
    pool = tr["pool_pages"]
    lens = traffic.lengths(cfg["targets"], (pool + 1) * size, fixed)
    # the seed orders each page's own lengths: every seed gets the same
    # pages, sizes and all
    rng = np.random.default_rng(run.seed)
    lens = np.concatenate([rng.permutation(lens[k * size: (k + 1) * size])
                           for k in range(pool + 1)])
    t = time.perf_counter()
    seqs = traffic.sequences(rng, lens)
    pages = []
    for k in range(pool + 1):
        names = [f"p{k}_{i}" for i in range(size)]
        page = seqs[k * size: (k + 1) * size]
        traffic.write_fasta(run.tmp / f"page{k}.fa", names, page)
        pages.append(page)
    run.log(f"[setup] inputs {time.perf_counter() - t:.3f} s "
            f"({int(lens.sum())} nt)")
    DbParams, db = _params(run)
    # the warm-up builds the last page, which the window never builds
    t = time.perf_counter()
    pdb.run(DbParams(input=str(run.tmp / f"page{pool}.fa"),
                     db_name=str(run.tmp / "warm"), **db))
    run.log(f"[setup] warm-up build {time.perf_counter() - t:.3f} s")
    return {"pages": pages[:pool]}


def window(run, state):
    from priblast_tpu_torch.models import db as pdb

    DbParams, db = _params(run)
    pages = state["pages"]
    run.page_lengths = []

    def plan(i):
        k = i % len(pages)
        rec = {"page": k, "db": run.tmp / f"db{i}", "units": 1,
               "nt": sum(len(s) for s in pages[k])}
        run.page_lengths.extend(len(s) for s in pages[k])

        def call():
            pdb.run(DbParams(input=str(run.tmp / f"page{k}.fa"),
                             db_name=str(rec["db"]), **db))

        return rec, call, None

    measure(run, plan)


def end_to_end(run, name):
    if name == "db_nt_per_s":
        return run.work_nt / run.window_s
    return None


# ------------------------------------------------------------------ check

_I4, _F4 = np.dtype("<i4"), np.dtype("<f4")


def read_page(db: Path, hash_size: int):
    """The files of a one-page database: (sizes, codes, suffix array,
    hash start, hash end, [(acc, cond)])."""
    raw = Path(str(db) + ".seq").read_bytes()
    n = int(np.frombuffer(raw, _I4, 1, 0)[0])
    sizes = np.frombuffer(raw, _I4, n, 4)
    total = int(np.frombuffer(raw, _I4, 1, 4 + 4 * n)[0])
    codes = np.frombuffer(raw, np.uint8, total, 8 + 4 * n)
    ind = Path(str(db) + ".ind").read_bytes()
    m = int(np.frombuffer(ind, _I4, 1, 0)[0])
    sa = np.frombuffer(ind, _I4, m, 4)
    slots = (4 ** (hash_size + 1) - 4) // 3
    hs = np.frombuffer(ind, _I4, slots, 4 + 4 * m)
    he = np.frombuffer(ind, _I4, slots, 4 + 4 * m + 4 * slots)
    acc_raw = Path(str(db) + ".acc").read_bytes()
    at, accs = 0, []
    for _ in range(n):
        c1 = int(np.frombuffer(acc_raw, _I4, 1, at)[0])
        a = np.frombuffer(acc_raw, _F4, c1, at + 4)
        at += 4 + 4 * c1
        c2 = int(np.frombuffer(acc_raw, _I4, 1, at)[0])
        c = np.frombuffer(acc_raw, _F4, c2, at + 4)
        at += 4 + 4 * c2
        accs.append((a, c))
    return sizes, codes, sa, hs, he, accs


def index_mismatches(page: list[str], files, hash_size: int) -> int:
    """Entries of .seq, the suffix array and the hash that differ from the
    reference's (a length that differs counts as the longer length)."""
    from reference import index

    sizes, codes, sa, hs, he, _ = files
    enc = index.encode_page(page)
    rsa = index.suffix_array(enc)
    rhs, rhe = index.kmer_hash(enc, rsa, hash_size)

    def diff(a, b):
        if len(a) != len(b):
            return max(len(a), len(b))
        return int(np.count_nonzero(np.asarray(a) != np.asarray(b)))

    return (diff(sizes, [len(s) for s in page]) + diff(codes, enc)
            + diff(sa, rsa) + diff(hs, rhs) + diff(he, rhe))


def _widest(got, ref) -> float:
    if not len(ref):
        return 0.0
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref)))


def check(run, state, control=False):
    import torch
    from reference import jobs as rj

    cfg, tr = run.config, run.traffic
    hsz = cfg["db"]["hash_size"]
    w, d = cfg["db"]["maximal_span"], cfg["db"]["min_accessible_length"]
    rng = np.random.default_rng([run.seed, 1])
    built = [i for i, j in enumerate(run.jobs) if j["ok"]]
    picks = sorted(rng.choice(built, min(tr["check_pages"], len(built)),
                              replace=False).tolist()) if built else []
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    mism, todo = 0, []
    for n, i in enumerate(picks):
        page = state["pages"][run.jobs[i]["page"]]
        files = read_page(run.jobs[i]["db"], hsz)
        mism += index_mismatches(page, files, hsz)
        accs = files[5]
        if len(accs) != len(page):
            mism += abs(len(page) - len(accs))
            continue
        per = tr["check_seqs"] // len(picks) + (n < tr["check_seqs"]
                                               % len(picks))
        idx = rng.choice(len(page), per, replace=False).tolist()
        for k in sorted(idx):
            todo.append((page[k], accs[k]))
    gap = c_gap = 0.0
    if todo:
        with refpool.pool(run) as pool:
            ref = refpool.longest_first(pool, rj.accessibility,
                                        [(s, w, d) for s, _ in todo],
                                        [len(s) for s, _ in todo])
        for (s, (a, c)), (ra, rc) in zip(todo, ref):
            if len(a) != len(ra) or len(c) != len(rc):
                mism += 1
                continue
            gap = max(gap, _widest(a, ra), _widest(c, rc))
            c_gap = max(c_gap, _widest(rj.bf16(ra), ra),
                        _widest(rj.bf16(rc), rc))
    run.log(f"[check] pages {picks}, {len(todo)} sequences "
            f"({sum(len(s) for s, _ in todo)} nt), reference "
            f"{time.perf_counter() - t:.1f} s")
    lim = tr["limits"]
    if control:
        run.control = {"access_gap_kcal": c_gap}
        run.log(f"[control] the reference in bfloat16 in the program's "
                f"place: access_gap_kcal {c_gap!r}")
    return {"index_mismatches": {"value": mism,
                                 "limit": lim["index_mismatches"]},
            "access_gap_kcal": {"value": gap,
                                "limit": lim["access_gap_kcal"]}}
