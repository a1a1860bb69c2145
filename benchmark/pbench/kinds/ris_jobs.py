"""Back-to-back `ris` jobs against one database page.

Set-up makes the configuration's target page from the seed and builds it
with the port's `db` (engine gpu), writes the pool of jobs (each
`queries_per_job` new queries of the query length model, one FASTA), and
warms up with one job of `warmup_queries` queries of its own (a job of
the window's size: after a smaller one the window's first job grew the
process's memory, at twice the system CPU time of the jobs after it).
The window runs the jobs one after another, each `models.ris.run` with
the router's defaults, its output written to the run's temporary
directory, until `--seconds` have passed; the last job runs to its end
and the window ends with it.

The check: every output line of the window for what it says (names,
lengths, coordinates in range, energy = accessibility + hybridization,
energy under the final threshold), then one job drawn from the seed,
`check_queries` of its queries against `check_targets` targets, all drawn
from the seed, against the plain reference: the accessibility of those
sequences, then the search of each pair (reference/search.py), line for
line (`compare`)."""

from __future__ import annotations

import contextlib
import re
import resource
import time

import numpy as np

from pbench import refpool, traffic
from pbench.window import measure

LINE = re.compile(r"^(\d+),([^,]*),(\d+),([^,]*),(\d+),([^,]+),([^,]+),"
                  r"([^,]+),\((-?\d+)-(-?\d+):(-?\d+)-(-?\d+)\) $")


def _params(run):
    from priblast_tpu_torch.utils.params import DbParams, RisParams

    dev = run.device.type
    db = dict(run.config["db"], engine="gpu", device=dev)
    ris = dict(run.config["ris"], engine="gpu", device=dev)
    return DbParams, db, RisParams, ris


def setup(run):
    from priblast_tpu_torch.models import db as pdb
    from priblast_tpu_torch.models import ris as pris

    cfg, tr = run.config, run.traffic
    fixed = np.random.default_rng(cfg["length_seed"])
    tlens = traffic.lengths(cfg["targets"], cfg["targets"]["count"], fixed)
    qpj, pool = tr["queries_per_job"], tr["pool_jobs"]
    qlens = traffic.lengths(cfg["queries"], pool * qpj, fixed)
    wlens = traffic.lengths(cfg["queries"], tr["warmup_queries"], fixed)
    # the seed orders each page's and each job's own lengths, so every
    # seed gets the same page and the same jobs, sizes and all
    rng = np.random.default_rng(run.seed)
    tlens = rng.permutation(tlens)
    qlens = np.concatenate([rng.permutation(qlens[k * qpj: (k + 1) * qpj])
                            for k in range(pool)])
    t = time.perf_counter()
    targets = traffic.sequences(rng, tlens)
    queries = traffic.sequences(rng, qlens)
    warm = traffic.sequences(rng, wlens)
    tnames = [f"t{i}" for i in range(len(targets))]
    traffic.write_fasta(run.tmp / "page.fa", tnames, targets)
    jobs = []
    for k in range(pool):
        names = [f"q{k}_{i}" for i in range(qpj)]
        seqs = queries[k * qpj: (k + 1) * qpj]
        traffic.write_fasta(run.tmp / f"job{k}.fa", names, seqs)
        jobs.append((names, seqs))
    traffic.write_fasta(run.tmp / "warm.fa",
                        [f"w{i}" for i in range(len(warm))], warm)
    run.log(f"[setup] inputs {time.perf_counter() - t:.3f} s "
            f"({int(tlens.sum())} target nt, {int(qlens.sum())} query nt)")
    DbParams, db, RisParams, ris = _params(run)
    t = time.perf_counter()
    pdb.run(DbParams(input=str(run.tmp / "page.fa"),
                     db_name=str(run.tmp / "page"), **db))
    run.log(f"[setup] page build {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    pris.run(RisParams(input=str(run.tmp / "warm.fa"),
                       output=str(run.tmp / "warm.out"),
                       db_name=str(run.tmp / "page"), **ris))
    run.log(f"[setup] warm-up job {time.perf_counter() - t:.3f} s")
    return {"targets": dict(zip(tnames, targets)), "jobs": jobs}


@contextlib.contextmanager
def _routes(sink: list):
    """Records each wave's route (queries on the host chain, on the device
    chain) as the router hands it out."""
    from priblast_tpu_torch.models import ris_gpu

    orig = ris_gpu.route

    def route(*a, **k):
        split = orig(*a, **k)
        sink.append((len(split[0]), len(split[1])))
        return split

    ris_gpu.route = route
    try:
        yield
    finally:
        ris_gpu.route = orig


def window(run, state):
    from priblast_tpu_torch.models import ris as pris
    from priblast_tpu_torch.utils import profiling

    _, _, RisParams, ris = _params(run)
    jobs = state["jobs"]

    def plan(i):
        k = i % len(jobs)
        names, seqs = jobs[k]
        rec = {"job": k, "out": run.tmp / f"out{i}.txt", "units": len(seqs),
               "nt": sum(len(s) for s in seqs), "route": []}
        before = profiling.snapshot(), resource.getrusage(
            resource.RUSAGE_SELF)

        def call():
            with _routes(rec["route"]):
                pris.run(RisParams(input=str(run.tmp / f"job{k}.fa"),
                                   output=str(rec["out"]),
                                   db_name=str(run.tmp / "page"), **ris))

        def note(rec):
            return (f"{len(seqs)} queries {rec['nt']} nt {rec['s']:.3f} s "
                    f"route (host, device) per wave {rec['route']}; "
                    + _job_costs(*before))

        return rec, call, note

    measure(run, plan)


def _job_costs(spans0, use0) -> str:
    """A job's stage seconds and the process's CPU seconds, page faults and
    context switches over it, for the log."""
    from priblast_tpu_torch.utils import profiling

    spans = profiling.snapshot()
    use = resource.getrusage(resource.RUSAGE_SELF)
    stages = " ".join(f"{k} {spans[k] - spans0.get(k, 0.0):.3f}"
                      for k in sorted(spans) if k.count(".") == 1)
    return (f"stages {stages}; cpu user {use.ru_utime - use0.ru_utime:.2f} "
            f"sys {use.ru_stime - use0.ru_stime:.2f} s, minor faults "
            f"{use.ru_minflt - use0.ru_minflt}, context switches "
            f"{use.ru_nvcsw - use0.ru_nvcsw} + involuntary "
            f"{use.ru_nivcsw - use0.ru_nivcsw}")


def end_to_end(run, name):
    """None: the ris cells' end-to-end metrics other than setup_s are read
    from the window's device trace by their readers in metrics/."""
    return None


# ------------------------------------------------------------------ check

def _read_lines(path):
    lines = path.read_text().splitlines() if path.exists() else []
    return lines[:3], lines[3:]


def lines_by_what_they_say(run, state) -> int:
    """The count of output lines of the window that are malformed or say
    something impossible; a job's missing header counts once."""
    fin = float(run.config["ris"]["final_threshold"])
    targets = state["targets"]
    bad = 0
    for j in run.jobs:
        names, seqs = state["jobs"][j["job"]]
        qlen = dict(zip(names, (len(s) for s in seqs)))
        head, body = _read_lines(j["out"])
        if len(head) < 3 or head[0] != "RIblast ris result":
            bad += 1
        for n, line in enumerate(body):
            m = LINE.match(line)
            if not m:
                bad += 1
                continue
            g = m.groups()
            try:
                a, h, e = float(g[5]), float(g[6]), float(g[7])
            except ValueError:
                bad += 1
                continue
            q1, q2, t1, t2 = (int(x) for x in g[8:12])
            ql = qlen.get(g[1])
            tl = len(targets[g[3]]) if g[3] in targets else None
            tol = 1e-5 * (abs(a) + abs(h) + abs(e)) + 1e-6
            if (int(g[0]) != n or ql is None or int(g[2]) != ql
                    or tl is None or int(g[4]) != tl
                    or abs(e - (a + h)) > tol or e > fin + tol
                    or not (0 <= q1 < ql and 0 <= q2 < ql)
                    or not (0 <= t1 < tl and 0 <= t2 < tl)):
                bad += 1
    return bad


def reference_hits(run, qs, ts, control=False):
    """The reference's hits of every (query, target) pair of the sample,
    and with `control` those of the reference in bfloat16 in the
    program's place, by form. qs, ts: lists of (name, sequence)."""
    from reference import jobs as rj
    from reference import search

    cfg = run.config
    w, d = cfg["db"]["maximal_span"], cfg["db"]["min_accessible_length"]
    r = cfg["ris"]
    p = {"max_seed_length": r["max_seed_length"],
         "hybrid_thr": r["hybrid_energy_threshold"], "min_acc_len": d,
         "interaction_thr": r["interaction_energy_threshold"],
         "final_thr": r["final_threshold"],
         "dropout_wo_gap": r["drop_out_length_wo_gap"],
         "dropout_w_gap": r["drop_out_length_w_gap"],
         "min_helix": r["min_helix_length"]}
    seqs = [s for _, s in qs] + [s for _, s in ts]
    with refpool.pool(run) as pool:
        t = time.perf_counter()
        acc = refpool.longest_first(pool, rj.accessibility,
                            [(s, w, d) for s in seqs], [len(s) for s in seqs])
        run.log(f"[check] reference accessibility of {len(seqs)} sequences "
                f"({sum(map(len, seqs))} nt) {time.perf_counter() - t:.1f} s")
        qa, ta = acc[: len(qs)], acc[len(qs):]
        t = time.perf_counter()
        pairs = [(qi, ti) for qi in range(len(qs)) for ti in range(len(ts))]
        ref = pool.map(rj.search_pair, [
            (qs[qi][1], ts[ti][1], qa[qi], ta[ti], p) for qi, ti in pairs],
            chunksize=1)
        run.log(f"[check] reference search of {len(pairs)} pairs "
                f"{time.perf_counter() - t:.1f} s")
        ctl = None
        if control:
            # the reference in bfloat16: its accessibility stored in it
            # ("storage"), and also every energy its search accumulates
            # ("arithmetic")
            low = [(rj.bf16(a), rj.bf16(c)) for a, c in acc]
            ctl = {form: pool.map(rj.search_pair, [
                (qs[qi][1], ts[ti][1], low[qi], low[len(qs) + ti], pf)
                for qi, ti in pairs], chunksize=1)
                for form, pf in (("storage", p),
                                 ("arithmetic",
                                  dict(p, round=search.bfloat16)))}
    names = [(qs[qi][0], ts[ti][0]) for qi, ti in pairs]
    return names, ref, ctl


def _overlap(a, b) -> bool:
    """Whether two lines' query intervals and target intervals overlap."""
    def span(x, y):
        return min(x, y), max(x, y)

    (q0, q1), (t0, t1) = span(a[0], a[1]), span(a[2], a[3])
    (r0, r1), (u0, u1) = span(b[0], b[1]), span(b[2], b[3])
    return q0 <= r1 and r0 <= q1 and t0 <= u1 and u0 <= t1


def compare(ref, got, thr: float):
    """(widest energy gap in kcal/mol, counts) of the program's lines
    against the reference's hits, pair by pair. `ref` per pair the
    reference's hits; `got` per pair a list of (q1, q2, t1, t2, A, H, E)
    the program printed.

    A line at the reference's coordinates counts the largest gap of its
    three energies. A reference hit left over is then paired with the
    program's left-over line of the same pair that overlaps it with the
    nearest energy, and counts the gap of the energies (a near tie the
    redundancy removal broke the other way keeps the other of two
    overlapping hits). What is left on either side counts its distance
    to the final threshold: a line rounding could have kept or dropped
    lies within the rounding of it, and a missing or extra line anywhere
    else is as wrong as an energy off by that much."""
    n = dict(matched=0, overlapping=0, reference_only=0, program_only=0)
    gap = 0.0
    for hits, lines in zip(ref, got):
        left = list(lines)
        alone = []
        for h in hits:
            keys = [h["first_last"]]
            if h.get("first_last_raw") is not None:
                keys.append(h["first_last_raw"])
            at = next((i for i, ln in enumerate(left)
                       if tuple(ln[:4]) in keys), None)
            if at is None:
                alone.append(h)
                continue
            ln = left.pop(at)
            gap = max(gap, abs(ln[4] - h["acc"]), abs(ln[5] - h["hyb"]),
                      abs(ln[6] - h["energy"]))
            n["matched"] += 1
        for h in alone:
            near = [i for i, ln in enumerate(left)
                    if _overlap(ln, h["first_last"])]
            if near:
                at = min(near, key=lambda i: abs(left[i][6] - h["energy"]))
                gap = max(gap, abs(left.pop(at)[6] - h["energy"]))
                n["overlapping"] += 1
            else:
                gap = max(gap, abs(h["energy"] - thr))
                n["reference_only"] += 1
        for ln in left:
            gap = max(gap, abs(ln[6] - thr))
            n["program_only"] += 1
    return gap, n


def program_lines(run, job_index, pairs):
    """Per (query name, target name), the lines the program printed in
    the sampled job, as (q1, q2, t1, t2, A, H, E)."""
    want = {pair: [] for pair in pairs}
    _, body = _read_lines(run.jobs[job_index]["out"])
    for line in body:
        m = LINE.match(line)
        if not m:
            continue
        g = m.groups()
        key = (g[1], g[3])
        if key in want:
            want[key].append((int(g[8]), int(g[9]), int(g[10]), int(g[11]),
                              float(g[5]), float(g[6]), float(g[7])))
    return [want[pair] for pair in pairs]


def check(run, state, control=False):
    import torch

    tr = run.traffic
    bad = lines_by_what_they_say(run, state)
    rng = np.random.default_rng([run.seed, 1])
    ji = int(rng.integers(len(run.jobs)))
    tnames = sorted(state["targets"], key=lambda n: int(n[1:]))
    pick = rng.choice(len(tnames), tr["check_targets"], replace=False)
    names, seqs = state["jobs"][run.jobs[ji]["job"]]
    qpick = rng.choice(len(names), min(tr["check_queries"], len(names)),
                       replace=False)
    qs = [(names[i], seqs[i]) for i in sorted(qpick)]
    ts = [(tnames[i], state["targets"][tnames[i]]) for i in sorted(pick)]
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    pairs, ref, ctl = reference_hits(run, qs, ts, control)
    thr = float(run.config["ris"]["final_threshold"])
    gap, counts = compare(ref, program_lines(run, ji, pairs), thr)
    run.log(f"[check] job {ji} ({len(qs)} queries) x targets "
            f"{[n for n, _ in ts]}: {counts}, reference "
            f"{time.perf_counter() - t:.1f} s")
    lim = tr["limits"]
    if control:
        run.control = {}
        for form, hits in ctl.items():
            c_gap, c_counts = compare(ref, [
                [(*h["first_last"], h["acc"], h["hyb"], h["energy"])
                 for h in per] for per in hits], thr)
            run.control[form] = {"energy_gap_kcal": c_gap}
            run.log(f"[control] the reference in bfloat16 ({form}) in the "
                    f"program's place: {c_counts}, energy_gap_kcal "
                    f"{c_gap!r}")
    return {"bad_lines": {"value": bad, "limit": lim["bad_lines"]},
            "energy_gap_kcal": {"value": gap,
                                "limit": lim["energy_gap_kcal"]}}
