#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (priblast_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases (any failure ends the run with a non-zero exit code):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: the native host library (g++) and the gapped-extension CUDA
     kernel (nvcc, sm_90a), both from this checkout, started together;
  3. main path at full size: a seeded workload the size of bench.py's
     (100 queries of ~1,000 nt against 20 db sequences of ~5,000 nt,
     first-order Markov sequences of transcript-like composition) through
     `db --engine gpu` and `ris --engine gpu` on cuda; the gapped kernel's
     launch count and the peak device memory are read around that run;
  4. the device chain against the port's host chain (native search per
     query on the same device-computed accessibilities), and against
     `--engine exact` (the churn of the float32 device engine);
  5. the gapped kernel (one direction, from the characters to the
     traceback) against its plain PyTorch version on the card: on the
     inputs of the main path's first launch (its own batch shape, whose
     times go into the kernels' record), and on real mid-stage hits of
     phase 3 as a ragged 4096+37 batch in float32 and float64 and at
     max_ext=64; each with its time, the plain version's time and the
     card's least time for the same work.
The last lines are the kernels' JSON record, the card line from nvidia-smi
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM (NVIDIA data sheet)
PEAK_FLOPS = {"float32": 67e12,    # H100 SXM, outside the tensor cores
              "float64": 34e12}
N_Q, Q_LEN, N_DB, DB_LEN = 100, 1000, 20, 5000


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---- workload: first-order Markov sequences of transcript-like
# composition (~47% GC, CpG odds ~0.3, UpA ~0.75), the generator the repo
# uses for its benchmark workload
_BASE_FREQ = [0.265, 0.235, 0.245, 0.255]   # A, C, G, U
_ODDS = [[1.00, 1.05, 1.05, 0.95],
         [1.10, 1.05, 0.30, 1.10],
         [0.95, 1.05, 1.05, 1.00],
         [0.75, 1.10, 1.10, 1.00]]


def markov_batch(rng, lengths):
    import numpy as np

    t = np.asarray(_ODDS) * np.asarray(_BASE_FREQ)[None, :]
    tcum = np.cumsum(t / t.sum(axis=1, keepdims=True), axis=1)
    fcum = np.cumsum(_BASE_FREQ)
    lengths = np.asarray(lengths, np.int64)
    n, n_max = len(lengths), int(lengths.max())
    state = np.searchsorted(fcum, rng.random(n)).clip(0, 3)
    out = np.zeros((n, n_max), np.uint8)
    out[:, 0] = state
    u = rng.random((n_max, n))
    for i in range(1, n_max):
        state = (u[i][:, None] > tcum[state]).sum(axis=1).clip(0, 3)
        out[:, i] = state
    bases = np.frombuffer(b"ACGU", np.uint8)
    return [bases[out[i, : lengths[i]]].tobytes().decode() for i in range(n)]


def write_fasta(path: Path, prefix: str, seqs) -> int:
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">{prefix}{i}\n")
            for k in range(0, len(s), 70):
                f.write(s[k: k + 70] + "\n")
    return sum(len(s) for s in seqs)


def hit_key(line: str):
    """(query, query length, target, target length, base pairs) of an
    output line — everything but the running id and the energies."""
    f = line.split(",")
    return (f[1], f[2], f[3], f[4], ",".join(f[8:]))


def compare_lines(ref: list[str], got: list[str]):
    """Fraction of lines that agree on their hit key (multiset match), and
    the largest energy difference over matched lines."""
    ka, kb = Counter(map(hit_key, ref)), Counter(map(hit_key, got))
    matched = sum((ka & kb).values())
    frac = matched / max(len(ref), len(got), 1)
    first = {}
    for line in ref:
        first.setdefault(hit_key(line), line)
    de = 0.0
    for line in got:
        r = first.get(hit_key(line))
        if r is not None:
            a, b = r.split(","), line.split(",")
            de = max(de, *(abs(float(x) - float(y))
                           for x, y in zip(a[5:8], b[5:8])))
    return frac, matched, de


def body(path: Path) -> list[str]:
    return path.read_text().splitlines()[3:]


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def extend_bound_ms(a, k, ints):
    """Least time the card could take for one direction of the gapped
    extension on these hits (`gapped_extend_dir`'s arguments `a`, `k` and
    its results `ints`): the larger of the bytes it must move over the
    memory rate and its operations over the peak rate of the dtype.

    Bytes, each counted once, in 32-byte sectors where they are gathered:
    - the characters a hit needs, offsets 0..min(XW - 1, n + helix) of its
      query and db windows (n = diagonals it swept, helix =
      max(min_helix, 2)), in the int64 flat buffers;
    - the accessibility entries its prefix chains need, offsets 1..n (two
      acc entries and one cond entry on one side, one cond entry on the
      other), in the float32 flat buffers;
    - the hit's columns (8 int64 columns, energy0, acc0, valid);
    - once per launch (each block loads them, but after the first block
      they come from L2), the tables the kernel stages in shared memory:
      int21, int11, the small int32 tables and the loop constants;
    - of int22, which the kernel reads through L1, the sectors of the
      entries the band cells index where the (u1, u2) = (2, 2) combo can
      reach a predecessor value (i, j >= 4, or i = j = 3: the origin);
    - the outputs: ints, floats and both traceback lists.
    Operations: per band cell (i, j = L - i), max(1, L - maxd) <= i <=
    min(L - 1, maxq), L <= n, the (u1, u2) combos (u1 + u2 <= dropout)
    whose predecessor can hold a value: a band cell (u1 <= i - 2,
    u2 <= j - 2) or the origin (u1, u2) = (i - 1, j - 1); ~4 each.

    Returns (bound ms, "bytes" or "operations", mean band lanes per swept
    diagonal)."""
    import torch
    from priblast_tpu_torch.ops import gapped_sweep as sop

    (q_start, db_start, id_anchor, energy0, acc0, valid, qb, qab, dbb, aoff,
     coff, q_enc, db_seq, q_acc, q_cond, db_acc, db_cond) = a
    flag, d, dropout = k["flag"], k["d"], k["dropout"]
    max_ext, helix = k["max_ext"], max(k["min_helix"], 2)
    dtype = k.get("dtype", "float32")
    item = 4 if dtype == "float32" else 8
    dev = q_start.device
    B, W, ME1, XW = q_start.shape[0], max_ext, max_ext + 1, max_ext + helix
    n = ints[:, 4].long()
    sign = -1 if flag == 0 else 1

    def sectors(buf, pos, used):
        """Distinct 32-byte sectors of `buf` at in-bounds `pos` [B, X]."""
        ok = used & (pos >= 0) & (pos < buf.shape[0])
        sec = (pos[ok] * buf.element_size()) // 32
        return int(torch.unique(sec).numel())

    x = torch.arange(XW, device=dev)[None, :]
    need_c = x <= (n[:, None] + helix)
    nbytes = 32 * (sectors(q_enc, (qb + q_start)[:, None] + sign * x, need_c)
                   + sectors(db_seq, (dbb + db_start)[:, None] + sign * x,
                             need_c))
    need_a = (x >= 1) & (x <= n[:, None])
    qa, ca, aa = qab + q_start, coff + id_anchor, aoff + id_anchor
    if flag == 0:
        acc_pos = [(q_acc, qa[:, None] - x), (q_acc, qa[:, None] - x + 1),
                   (q_cond, qa[:, None] - x + d), (db_cond, ca[:, None] + x)]
    else:
        acc_pos = [(q_cond, qa[:, None] + x), (db_acc, aa[:, None] - x),
                   (db_acc, aa[:, None] - x + 1),
                   (db_cond, ca[:, None] - x + d)]
    # entries of one buffer read at several offsets count once
    by_buf = {}
    for buf, pos in acc_pos:
        by_buf.setdefault(id(buf), (buf, []))[1].append(pos)
    for buf, poss in by_buf.values():
        pos = torch.cat(poss, 1)
        nbytes += 32 * sectors(buf, pos, need_a.repeat(1, len(poss)))
    nbytes += B * (8 * 8 + energy0.element_size() + acc0.element_size() + 1)
    i21_at = {name: off for name, off, _ in sop.TABLES16}["i21"]
    consts = sop._kernel_consts(dropout, sop._DTYPES[dtype], dev)[0]
    nbytes += (sop.N_WORDS - i21_at) * 2 + consts.numel() * item
    nbytes += B * (5 * 4 + 2 * item + 2 * (max_ext // 2 + 1) * 4)

    raw_q, qm = sop._gather_chars(q_enc, qb + q_start, sign, XW)
    raw_d, dm = sop._gather_chars(db_seq, dbb + db_start, sign, XW)
    maxq = sop.max_ext_of(raw_q)[:, None, None]
    maxd = sop.max_ext_of(raw_d)[:, None, None]
    diag = torch.arange(ME1, device=dev)[:, None]
    lane = torch.arange(W, device=dev)[None, :]
    band = ((lane >= 1) & (lane <= diag - 1) & (lane <= maxq)
            & (diag - lane <= maxd) & (diag <= n[:, None, None])
            & valid[:, None, None])

    tabs = sop._tables_np()
    bp_t = torch.as_tensor(tabs["bp"], device=dev)
    rt_t = torch.as_tensor(tabs["rtype"], device=dev)

    def t0(a, b):
        t = bp_t[a * 5 + b]
        return rt_t[t] if flag else t

    i22_sec = torch.zeros(i21_at * 2 // 32, dtype=torch.bool, device=dev)
    for L in range(6, ME1 if dropout >= 4 else 0):
        i = torch.arange(3, L - 2, device=dev)          # i, j = L - i >= 3
        j = L - i
        cell = band[:, L, i] & ((i >= 4) & (j >= 4) | (i == 3) & (j == 3))
        T, tb = t0(qm[:, i], dm[:, j]), rt_t[t0(qm[:, i - 3], dm[:, j - 3])]
        q1, q2, d1, d2 = qm[:, i - 1], qm[:, i - 2], dm[:, j - 1], dm[:, j - 2]
        idx = ((((T * 8 + tb) * 5 + q1) * 5 + q2) * 5 + d2) * 5 + d1
        if flag:
            idx = ((((tb * 8 + T) * 5 + q2) * 5 + q1) * 5 + d1) * 5 + d2
        i22_sec[idx[cell] * 2 // 32] = True
    nbytes += 32 * int(i22_sec.sum())
    reach = torch.zeros((ME1, W), dtype=torch.long)
    for L in range(ME1):
        for i in range(1, min(L, W)):
            j = L - i
            reach[L, i] = (sum(max(0, min(j - 1, dropout - u1 + 1))
                               for u1 in range(min(i - 1, dropout + 1)))
                           + (i + j - 2 <= dropout))
    n_cells = band.sum(0).cpu()
    ops = int((n_cells * reach).sum()) * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    lanes = int(n_cells.sum()) / max(int(n.sum()), 1)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", lanes)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not (REPO / "priblast_tpu_torch" / "csrc" / "gapped_extend.cu").is_file():
        fail(f"no priblast_tpu_torch package beside {__file__}")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    sys.path.insert(0, str(REPO))
    import numpy as np

    from priblast_tpu_torch import cli
    from priblast_tpu_torch.accessibility import batched
    from priblast_tpu_torch.models import ris as ris_model
    from priblast_tpu_torch.models import ris_gpu
    from priblast_tpu_torch.ops import gapped_sweep, native
    from priblast_tpu_torch.search import gapped, pipeline
    from priblast_tpu_torch.utils import alphabet, fasta, store
    from priblast_tpu_torch.utils import profiling as prof
    from priblast_tpu_torch.utils.params import RisParams

    # ---- 1. device ---------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}",
          flush=True)
    dev = torch.device("cuda")

    # ---- 2. build, both toolchains started together -------------------------
    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    with cf.ThreadPoolExecutor(2) as ex:
        fut_n = ex.submit(timed, native.build)
        fut_k = ex.submit(timed, gapped_sweep.build)
        (so_n, t_n), (so_k, t_k) = fut_n.result(), fut_k.result()
    print(f"[build] native {so_n.name} {t_n:.1f}s | gapped_extend "
          f"{so_k.name} {t_k:.1f}s", flush=True)

    # ---- 3. main path at full size -----------------------------------------
    work = REPO / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    db_lens = DB_LEN + rng.integers(-DB_LEN // 25, DB_LEN // 25 + 1, N_DB)
    q_lens = Q_LEN + rng.integers(-Q_LEN // 25, Q_LEN // 25 + 1, N_Q)
    db_nt = write_fasta(work / "db.fa", "t", markov_batch(rng, db_lens))
    write_fasta(work / "q.fa", "q", markov_batch(rng, q_lens))

    # instrumentation: where accessibility ran, the query accessibilities
    # the device chain used, the mid-stage streams it extended, and the
    # inputs of the first gapped launch (the main path's own batch shape)
    acc_devices, q_access, mid_streams, first_sweep = set(), {}, [], []
    run0 = batched.BatchedRaccess.run
    access0 = ris_gpu._accessibility_batched
    gstage0 = pipeline.gapped_stage
    kernel = gapped_sweep.gapped_extend_dir

    def run_rec(self, codes, lengths):
        acc_devices.add(str(self.device))
        return run0(self, codes, lengths)

    def access_rec(engine, seqs, lengths, idxs):
        out = access0(engine, seqs, lengths, idxs)
        q_access.update(out)
        return out

    def gstage_rec(stream, *a, **k):
        mid_streams.append({key: v.copy() for key, v in stream.soa.items()})
        return gstage0(stream, *a, **k)

    def sweep_rec(*a, **k):
        if not first_sweep:
            first_sweep.append((a, k))
        return kernel(*a, **k)

    batched.BatchedRaccess.run = run_rec
    ris_gpu._accessibility_batched = access_rec
    pipeline.gapped_stage = gstage_rec
    gapped_sweep.gapped_extend_dir = sweep_rec

    db_gpu, out_gpu = work / "db_gpu", work / "ris_gpu.txt"
    prof.reset()
    torch.cuda.reset_peak_memory_stats()
    gapped_sweep.launches = 0
    t0 = time.perf_counter()
    cli.main(["db", "-i", str(work / "db.fa"), "-o", str(db_gpu)])
    t_db = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli.main(["ris", "-i", str(work / "q.fa"), "-o", str(out_gpu), "-d",
              str(db_gpu)])
    t_ris = time.perf_counter() - t0
    launches = gapped_sweep.launches
    stages = prof.snapshot()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batched.BatchedRaccess.run = run0
    ris_gpu._accessibility_batched = access0
    pipeline.gapped_stage = gstage0
    gapped_sweep.gapped_extend_dir = kernel

    check(acc_devices == {"cuda"}, f"accessibility ran on {acc_devices}")
    check(launches > 0, "the gapped kernel was never launched")
    gpu_lines = body(out_gpu)
    check(len(gpu_lines) > 100, f"only {len(gpu_lines)} hits")
    for line in gpu_lines:
        e = [float(x) for x in line.split(",")[5:8]]
        check(all(np.isfinite(e)), f"non-finite energy in {line}")
    tag = f"({card})"
    print(f"[main] db {db_nt} nt in {t_db:.3f}s = {db_nt / t_db:.1f} nt/s; "
          f"ris {N_Q} queries in {t_ris:.3f}s = {N_Q / t_ris:.4f} q/s; "
          f"{len(gpu_lines)} hits; gapped kernel launches {launches}; peak device "
          f"memory {peak_gb:.2f} GB {tag}", flush=True)
    print("[main] stage seconds " + json.dumps(
        {k: round(v, 4) for k, v in sorted(stages.items())}) + f" {tag}",
        flush=True)

    # ---- 4a. device chain vs the port's host chain on the same
    # device-computed accessibilities
    p = RisParams(input=str(work / "q.fa"), output="-", db_name=str(db_gpu),
                  engine="exact")
    p.load_db_params()
    chunks = store.load_chunks(p.db_name, p.hash_size)
    names, seqs = fasta.read_fasta(work / "q.fa")
    order = [int(i) for i in native.argsort_desc([len(s) for s in seqs])]

    def host_chain(idx):
        q_enc = alphabet.encode_query(seqs[idx], p.repeat_flag)
        q_acc, q_cond = q_access[idx]
        q_sa = native.sa_build(q_enc)
        q_length = int(np.count_nonzero((q_enc >= 2) & (q_enc <= 5)))
        lines = []
        for chunk in chunks:
            res = native.search_chunk(q_enc, q_sa, q_acc, q_cond, chunk, p)
            lines += ris_model.format_hits(p, res, chunk, names[idx],
                                           q_length)
        return lines

    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor() as ex:
        per_q = dict(zip(order, ex.map(host_chain, order)))
    host_lines = [f"0,{line}" for i in order for line in per_q[i]]
    t_host = time.perf_counter() - t0
    frac, matched, de = compare_lines(host_lines, gpu_lines)
    print(f"[chain] device chain vs host chain on the same accessibilities: "
          f"{matched}/{len(host_lines)} lines agree ({frac:.6f}), max energy "
          f"diff {de:.3g} kcal/mol (host chain {t_host:.2f}s)", flush=True)
    check(frac >= 0.999, f"device/host chain agreement {frac} < 0.999")
    check(de <= 1e-3, f"device/host chain energy diff {de} > 1e-3")

    # ---- 4b. churn against --engine exact (exact db and exact ris) --------
    db_ex, out_ex = work / "db_exact", work / "ris_exact.txt"
    t0 = time.perf_counter()
    cli.main(["db", "-i", str(work / "db.fa"), "-o", str(db_ex),
              "--engine", "exact"])
    cli.main(["ris", "-i", str(work / "q.fa"), "-o", str(out_ex), "-d",
              str(db_ex), "--engine", "exact"])
    t_ex = time.perf_counter() - t0
    ex_lines = body(out_ex)
    frac, matched, de = compare_lines(ex_lines, gpu_lines)
    print(f"[churn] gpu vs exact: {matched} of {len(ex_lines)} exact / "
          f"{len(gpu_lines)} gpu lines agree ({frac:.6f}), churn "
          f"{1 - frac:.6f}, max energy diff on matched lines {de:.3g} "
          f"kcal/mol (exact db+ris {t_ex:.2f}s on the host)", flush=True)
    check(frac >= 0.99, f"gpu/exact agreement {frac} < 0.99")
    check(de <= 1e-2, f"gpu/exact energy diff {de} > 1e-2")

    # ---- 5. the gapped kernel vs its plain version, on the card ---------
    def hold(label, a, k):
        """Kernel vs plain version on the same inputs: integers and
        traceback lists identical, floats to 1e-6 (float32) / 1e-12
        (float64); then both timed."""
        dtype = k.get("dtype", "float32")
        ik, fk, tk = kernel(*a, **k)
        ip, fp, tp = gapped_sweep.extend_dir_plain(*a, **k)
        torch.cuda.synchronize()
        check(torch.equal(ik, ip), f"ints differ ({label})")
        check(torch.equal(tk, tp), f"traceback lists differ ({label})")
        diff = float((fk - fp).abs().max())
        check(diff <= (1e-6 if dtype == "float32" else 1e-12),
              f"floats differ by {diff} ({label})")
        ms = cuda_ms(lambda: kernel(*a, **k), 20)
        plain = cuda_ms(lambda: gapped_sweep.extend_dir_plain(*a, **k), 1)
        bound, bound_by, lanes = extend_bound_ms(a, k, ik)
        print(f"[kernel] gapped_extend {label} {dtype} max_ext="
              f"{k['max_ext']} flag={k['flag']} B={a[0].shape[0]}: "
              f"{ms:.4f} ms, plain {plain:.2f} ms, bound {bound:.6f} ms "
              f"({bound_by}), {ms / bound:.1f}x bound, "
              f"{float(ik[:, 4].float().mean()):.2f} diagonals per hit, "
              f"{lanes:.2f} band lanes per diagonal, max |floats diff| "
              f"{diff:.3g} {tag}", flush=True)
        return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=bound_by,
                    err=diff)

    check(len(first_sweep) == 1, "no gapped kernel inputs captured")
    a0, k0 = first_sweep[0]
    main_rec = hold("main-path batch", a0, k0)
    err = main_rec["err"]
    first_sweep.clear()

    check(mid_streams and len(mid_streams[0]["q_sp"]) >= 4096 + 37,
          "too few mid-stage hits for the kernel phase")
    soa = mid_streams[0]
    qp = pipeline.QueryPack([alphabet.encode_query(seqs[i], p.repeat_flag)
                             for i in order],
                            [q_access[i][0] for i in order],
                            [q_access[i][1] for i in order], device=dev)
    dp = pipeline.DbPack(chunks, device=dev)
    keys = (*pipeline.STREAM_KEYS, "qb", "qab", "dbb", "aoff", "coff")
    sub = {k: soa[k][:4096 + 37] for k in keys}
    for dtype, max_ext in (("float32", 32), ("float64", 32),
                           ("float32", 64)):
        calls = []

        def capture(*a, **k):
            calls.append((a, k))
            return kernel(*a, **k)

        gapped_sweep.gapped_extend_dir = capture
        try:
            gapped.gapped_extend_flat_batch(
                sub, qp.bufs, dp.bufs, d=p.min_accessible_length,
                dropout=p.drop_out_length_w_gap,
                min_helix=p.min_helix_length, max_ext=max_ext, dtype=dtype,
                device=dev)
        finally:
            gapped_sweep.gapped_extend_dir = kernel
        for label, (a, k) in zip(("ragged left", "ragged right"), calls):
            err = max(err, hold(label, a, k)["err"])
    kernels = [{
        "name": "gapped_extend", "route": "cuda",
        "source": "priblast_tpu_torch/csrc/gapped_extend.cu",
        "replaces": "priblast_tpu/search/gapped_pl.py:51",
        "launches": launches, "max_abs_err": err,
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
