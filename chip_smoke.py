#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (priblast_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases (any failure ends the run with a non-zero exit code):
  1. device: the card's name and power limit, torch and CUDA versions, the
     host's core count (os.cpu_count() and the affinity mask), and the
     devices `--device cuda` gives this process (every card);
  2. build: the native host library (g++) and the seven CUDA kernel
     sources (nvcc, sm_90a: the gapped extension, the ungapped extension,
     the fused stage's expansion and threshold, the accessibility weight
     grids, inside scan, outside scan, and the probability pass, whose
     sum launch writes the window energies, with the epilogue kernel off
     the main path), all from this checkout, started together;
  3. main path at full size: a seeded workload the size of bench.py's
     (100 queries of ~1,000 nt against 20 db sequences of ~5,000 nt,
     first-order Markov sequences of transcript-like composition) through
     `db --engine gpu` and `ris --engine gpu` on cuda, with the router
     pinned to the device chain (PRIBLAST_DEVICE_EXTEND=1), whose search is
     the fused path (host seed DFS, the expansion kernel, the ungapped
     kernel, the threshold kernel, host mid, the gapped kernel, host
     finish) and whose accessibility runs the grid kernel's two launches,
     the two scan kernels and the probability kernel, whose sum launch
     writes the window energies (window_energies); the kernels' launch
     counts (the energies' against one per batch, the epilogue kernel's
     against none, the expansion's against one per pair block, the
     threshold's against the ungapped kernel's) and the calls of the
     plain versions that the kernels replace (make_grids,
     make_outside_grids, scan_probabilities,
     accessibility_from_probabilities, _expand_core, _thresh_core: none),
     the stage seconds (`ris.fused` split into its
     synchronised sub-stages), the peak device memory, and the mid stage's
     seconds and CPU seconds are read around that run; then the gapped
     kernel's overflow: the hits past max_ext, the host fallback's seconds
     by part (its native calls summed over its threads, which run beside
     the next hit batches; the wait for them after the last batch; its
     vectorised patch), its threads, and the sha256 of the `ris` body;
  4. the device chain against the port's host chain (native search per
     query on the same device-computed accessibilities), and against
     `--engine exact` (the churn of the float32 device engine); the mid
     stage and the fused stage's candidate packing again on the main
     path's inputs, warm and after the C heap's free pages went back to
     the OS (malloc_trim), which splits their first runs' excess; the
     fused stage's split by part (torch.profiler: host ms by part and
     CUDA runtime call, the card's ms by kernel and copy) in a fresh
     process (`--split-child`), its first and second `ris`; the pairs per
     candidate of the main path's first block; the main path's wave again
     through its pair blocks, two in flight, with the device memory per
     pair of a block held to fused.PAIR_BYTES and, run again, no pinned
     host allocation; on its first block the expansion kernel's survivors
     held bit for bit to _expand_core's and the threshold's records to
     _thresh_core's on the same ungapped output, also at grids of the
     card's SMs and twice that, each timed beside its plain version, its
     byte bound (the threshold's also by the 32-byte sectors its reads
     touch) and (the threshold) the library's compaction, torch.nonzero
     and boolean indexing; then the staged oracle
     (seed_stage -> ungapped_stage -> threshold_stage) against the fused
     stage on the first 20 queries, same packs and accessibilities:
     identical post-threshold streams;
  4f. fallback: the gapped stage's host overflow fallback again on the
     main path's overflowed hits, at one thread with every flag at once,
     and at the main path's thread count in the main path's hit batches:
     the same stream fields and base pairs;
  4g. router: the five rates of the ris router (models/ris_gpu.py) from
     the main path and the host chain on this host: pairs per host thread
     and second, device pairs per second of seed + fused, hits after the
     mid stage per pair, device hits per second of mid + gapped + finish,
     and the device chain's wall on a one-query wave;
  4h. host-extend: `ris` with PRIBLAST_DEVICE_EXTEND=0 (device
     accessibility, then the host chain): its body equals phase 4a's host
     chain byte for byte, and no extension kernel runs;
  4i. hybrid: `ris` with the router in auto and its hybrid split forced
     on (PRIBLAST_HYBRID=1; its default keeps the hybrid off where the
     device chain alone wins): per wave, each side's queries, pairs and
     wall, the rates before and after calibration, q/s; the split equals
     split_wave recomputed from the printed pairs and rates, the extension
     kernels ran if and only if the device side had queries, and the body
     agrees with the main path's as the device chain agrees with the host
     chain; then `ris` in the router's defaults: per wave the chains it
     chose (every query to the device chain where device_extend_wins says
     it wins alone), the wall, and the body against the main path's as
     above, with its sha256;
  4j. multiproc: two processes of `python -m priblast_tpu_torch` on this
     card (torch.distributed, gloo): `db --engine gpu -a block`, then
     `ris --engine gpu -a area` on the device chain; the db files and the
     ris body byte for byte against the main path's;
  4k. multidev: several devices in one process: `db` and `ris` (device
     chain) of the main path's workload through their Python entry points
     with `devices` = every card, or [cuda:0, cuda:0] on a machine of one
     card (two shards on the card, each on its own thread); the db files
     and the ris body byte for byte against the main path's, the
     kernels' launches equal to the plan (one per non-empty shard of every
     accessibility batch and pair block, two per non-empty shard of every
     gapped hit batch), no plain version called, the walls beside the main
     path's; then
     parallel/dist.py:dryrun_multichip with [cuda:0] * 2 and [cuda:0] * 4
     (bit for bit against one device) and [cuda:0, cpu] (within its
     tolerance; on one card, what shows a tensor on the wrong device);
     whether distinct cards were used;
  5. the gapped kernel (one direction, from the characters to the
     traceback) against its plain PyTorch version on the card: on the
     inputs of the main path's first launch (its own batch shape, whose
     times go into the kernels' record), and on real mid-stage hits of
     phase 3 as a ragged 4096+37 batch in float32 and float64 and at
     max_ext=64; each with its time, the plain version's time and the
     card's least time for the same work;
  6. the ungapped kernel (a thread per hit) against its plain version on
     the card, the same way: the main path's first launch, its first
     4096+37 stage-1 hits, its first 20, and a mixed batch (its 1,024 hits
     with the most steps, each among three with the fewest), with the
     steps per hit and the lane efficiency of one thread per hit (steps
     over 32 x the sum of each warp's largest step count);
  7. the accessibility kernels (the weight grids' two launches; the
     inside pass with both exterior scans; the outside pass; the
     probability pass) against their plain versions on the main path's
     first db batch and its first ris batch (their own shapes): the grid
     launches' planes bit for bit against make_grids and
     make_outside_grids (the seed within 2 ulps), each launch's time
     through its wrapper as the main path calls it (the lengths checked on
     the host) and with the wrapper's own range check, alone (from
     torch.profiler), and its wrapper's host time by part; each scan
     kernel's planes against its plain
     version's on the same inputs, and the window energies of the kernel
     chain against the plain chain's (2e-3 kcal/mol); the probability
     kernel's p_w and p_w1 against scan_probabilities on the scan
     kernels' planes (relative 1e-4, as the planes) and its window
     energies (2e-3 kcal/mol); each with its time, the plain version's
     and the card's least time for the same work; the probability
     kernel's device time by launch (window and sum kernels, from
     torch.profiler) and its window kernel's two instantiations (stem rows
     staged in shared memory, or read from device memory) held bit for
     bit and timed in turns; the epilogue kernel on the probability
     kernel's output against accessibility_from_probabilities, bit for
     bit, with its time, the plain version's and its byte bound, the
     launch alone (a CUDA graph of 100 launches, and torch.profiler over
     100 calls), and a
     check that PyTorch divides a tensor by a host scalar on this card as
     the kernel does (a product with the float32 reciprocal); then
     window_energies, the main path's call, whose sum launch writes the
     energies: bit for bit with accessibility_from_probabilities and with
     the epilogue kernel on window_probs' p_w and p_w1, within 2e-3
     kcal/mol of the whole plain chain, with p_w and p_w1 (where asked
     for) bit for bit with window_probs'; its time through the wrapper
     against window_probs + accessibility through theirs and against
     window_probs alone (in turns), and the sum launch's device time
     without the energies, with them and p_w, p_w1, and with them alone
     (torch.profiler, in turns); the access_prob record times
     window_energies, the access_epilogue record the energies' device
     increment against the bytes they write;
  7b. nosync: window_probabilities with the epilogue, and batch_energies
     (the main path's call), on the same db and ris batches, called as
     BatchedRaccess calls them (the lengths' range checked on the host),
     under torch.cuda.set_sync_debug_mode("error") from after the codes'
     and lengths' H2D to before the results' D2H, so that any
     synchronising call in the six accessibility wrappers fails the run;
     each accessibility kernel launched as planned, and the bits of the
     calls that check the lengths themselves.
The last lines are the kernels' JSON record, the card line from nvidia-smi
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import resource
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
N_STAGED = 20                      # queries of the staged-vs-fused phase
# energy limit (kcal/mol) of the accessibility kernel chain against the
# plain chain in float32: the repo's float32 bound
ACCESS_TOL = 2e-3
# relative limit of each scan kernel's planes against its plain version's
# in float32, as tests/test_torch_access_emu.py holds them
PLANE_RTOL = 1e-4
# the grid kernels' seed plane against make_outside_grids', in ulps (expf
# may round otherwise than PyTorch's exp); every other plane bit for bit
SEED_ULPS = 2
# integer and float operations of one unpaired step of the ungapped kernel
# (csrc/ungapped_extend.cu: position updates, 6 clamped loads with their
# address arithmetic, the break tests, 5 float adds, the pair type, the
# dropout test); a paired step adds its loop energy
UNGAPPED_OPS_PER_STEP = 40
# the port's CLI in a process of its own ([multiproc]), then one JSON line
# of the launch counts of its kernels over that run
COUNTING_CLI = """
import json, sys
from priblast_tpu_torch import cli
from priblast_tpu_torch.ops import (access_grids, access_prob, access_scan,
                                    fused_expand, gapped_sweep,
                                    ungapped_extend)
cli.main(sys.argv[1:])
print(json.dumps({"access_grids_inside": access_grids.inside_grids_launches,
                  "access_grids_outside":
                      access_grids.outside_grids_launches,
                  "access_inside": access_scan.inside_launches,
                  "access_outside": access_scan.outside_launches,
                  "access_prob": access_prob.prob_launches,
                  "access_epilogue": access_prob.energies_launches,
                  "epilogue_kernel": access_prob.epilogue_launches,
                  "fused_expand": fused_expand.expand_launches,
                  "fused_threshold": fused_expand.threshold_launches,
                  "ungapped_extend": ungapped_extend.launches,
                  "gapped_extend": gapped_sweep.launches}))
"""


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


def write_workload(work: Path, seed: int) -> int:
    """The main path's workload from `seed`: db.fa (N_DB sequences of
    DB_LEN nt +- 4%) and q.fa (N_Q of Q_LEN nt +- 4%) in `work`. Returns
    the db's nucleotides."""
    import numpy as np

    work.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    db_lens = DB_LEN + rng.integers(-DB_LEN // 25, DB_LEN // 25 + 1, N_DB)
    q_lens = Q_LEN + rng.integers(-Q_LEN // 25, Q_LEN // 25 + 1, N_Q)
    db_nt = write_fasta(work / "db.fa", "t", markov_batch(rng, db_lens))
    write_fasta(work / "q.fa", "q", markov_batch(rng, q_lens))
    return db_nt


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


def body_sha256(path: Path) -> str:
    """sha256 of an output's body: its lines after the three header
    lines, each ended by a newline."""
    import hashlib

    return hashlib.sha256("".join(line + "\n" for line in body(path))
                          .encode()).hexdigest()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def usage() -> tuple:
    """(wall, process user CPU, process system CPU) seconds now."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return time.perf_counter(), r.ru_utime, r.ru_stime


def since(u0: tuple) -> tuple:
    return tuple(b - a for a, b in zip(u0, usage()))


def show_usage(u: tuple) -> str:
    return f"{u[0]:.4f} s ({u[1]:.3f} user + {u[2]:.3f} sys CPU s)"


def trim_heap() -> None:
    """Give the C heap's free pages back to the OS (glibc malloc_trim), so
    that what is allocated next touches fresh pages, as on a first run."""
    import ctypes

    ctypes.CDLL("libc.so.6").malloc_trim(0)


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


def ungapped_bound_ms(a, steps):
    """Least time the card could take for the ungapped extension of these
    hits (`ungapped_extend`'s arguments `a`; `steps` = (left, right) steps
    per hit, from search/ungapped.py:extend_steps): the larger of the bytes
    it must move over the memory rate and its operations over the float32
    peak rate.

    Bytes, each counted once, in 32-byte sectors where they are gathered:
    the characters and accessibility entries of every step a hit took
    (left step s = 1..left steps: query and db characters at q_sp - s and
    db_sp - s, q_acc at q_sp - s and q_sp - s + 1, q_cond at q_sp - s + d,
    db_cond at the window end + s; right step s: characters at the seed's
    end + s, q_cond there, db_acc at dbseq_start - s and - s + 1, db_cond
    at dbseq_start - s + d); the hit's 11 input columns (9 int64, 2
    float32) and 7 output columns (q_sp, db_sp, the new length, which is
    q_len and db_len, dbseq_start as int64; acc_e, hyb_e, energy as
    float32); the small tables the kernel stages in shared memory, once.
    Operations: steps x UNGAPPED_OPS_PER_STEP.

    Returns (bound ms, "bytes" or "operations")."""
    import torch

    (q_sp, db_sp, length, dbseq_start, _acc_e, _hyb_e, qb, qab, dbb, aoff,
     coff, bufs, dbufs, d, _dropout) = a
    q_enc, q_acc, q_cond = bufs
    db_seq, db_acc, db_cond = dbufs
    dev, B = q_sp.device, q_sp.shape[0]

    def ragged(n):
        """(hit, step) for steps 1..n[hit] of every hit."""
        hit = torch.repeat_interleave(torch.arange(B, device=dev), n)
        start = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
        return hit, torch.arange(hit.numel(), device=dev) - start + 1

    hl, sl = ragged(steps[0])
    hr, sr = ragged(steps[1])
    k_r = (q_sp + length - 1)[hr] + sr                # right query pos
    reads = {
        "q_enc": (q_enc, [(qb + q_sp)[hl] - sl, qb[hr] + k_r]),
        "db_seq": (db_seq, [(dbb + db_sp)[hl] - sl,
                            (dbb + db_sp + length - 1)[hr] + sr]),
        "q_acc": (q_acc, [(qab + q_sp)[hl] - sl, (qab + q_sp)[hl] - sl + 1]),
        "q_cond": (q_cond, [(qab + q_sp)[hl] - sl + d, qab[hr] + k_r]),
        "db_acc": (db_acc, [(aoff + dbseq_start)[hr] - sr,
                            (aoff + dbseq_start)[hr] - sr + 1]),
        "db_cond": (db_cond, [(coff + dbseq_start + length - 1)[hl] + sl,
                              (coff + dbseq_start)[hr] - sr + d]),
    }
    nbytes = 0
    for buf, poss in reads.values():
        pos = torch.cat(poss).clamp(0, buf.shape[0] - 1)
        nbytes += 32 * int(torch.unique(pos * buf.element_size() // 32)
                           .numel())
    nbytes += B * (9 * 8 + 2 * 4) + B * (4 * 8 + 3 * 4)
    nbytes += 4 * (25 + 7 + 49 + 175 + 31)
    steps = hl.numel() + hr.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = steps * UNGAPPED_OPS_PER_STEP / PEAK_FLOPS["float32"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def lanes_one_per_hit(st) -> float:
    """Lane efficiency of one thread per hit, with `st` steps per hit: the
    steps over 32 x the sum, over warps of 32 consecutive hits, of the
    warp's largest step count."""
    import torch

    warps = torch.nn.functional.pad(st, (0, (-st.numel()) % 32)).view(-1, 32)
    return float(st.sum()) / (32 * float(warps.max(dim=1).values.sum()))


def prob_lanes(band: int, w: int, ml: int) -> dict:
    """Lane efficiency of the probability window kernel
    (csrc/access_prob.cu) on a column far from both ends of its sequence:
    the multiply-adds of its interior-loop sums and bulges, both sides,
    over its 8 lanes x the busiest lane's multiply-add slots, with the
    split the kernel uses: the spans j = 0 .. band-1-u of each (u, side)
    in blocks of J consecutive spans (the least odd J with 8 J covering
    them, at most 9; blocks blk, blk + 8, ... to lane blk), each block
    ML - u steps wide with its masked terms, and the bulge's spans j = blk,
    blk + 8, ...; beside it the split of one lane per loop size (a lane
    runs its side's loop to the warp's longest).
    Returns dict(efficiency, mean_terms, max_terms, slots, one_per_u)."""
    lanes, max_j = 8, 9  # kLanes, kMaxJ
    terms, slots = [0] * lanes, [0] * lanes
    per_u = []
    for u in range(w, ml + 1):
        n, T = band - 1 - u, ml - u
        if n < 0:
            continue
        J = -(-(n + 1) // lanes)
        J = min(J + (J % 2 == 0), max_j)
        own = sum(min(T, j) for j in range(1, n + 1)) + (n + 1) * (u >= 2)
        per_u.append(own)
        for blk in range(lanes):
            for jb in range(blk * J, n + 1, lanes * J):
                terms[blk] += 2 * sum(min(T, j) for j in range(jb, jb + J)
                                      if 1 <= j <= n)
                slots[blk] += 2 * J * T
            if u >= 2:
                bulge = len(range(blk, n + 1, lanes))
                terms[blk] += 2 * bulge
                slots[blk] += 2 * bulge
    return dict(efficiency=sum(terms) / (lanes * max(slots)),
                mean_terms=sum(terms) / lanes, max_terms=max(terms),
                slots=max(slots),
                one_per_u=sum(per_u) / (32 * max(per_u)) if per_u else 1.0)


def device_ms_by_kernel(fn, names: tuple[str, ...] = ()) -> dict:
    """Device time (ms) of each kernel that one call of `fn` launches,
    summed by name, from torch.profiler; empty where the profiler saw no
    device time. A kernel whose profiler name holds one of `names` is
    filed under that name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def short(name: str) -> str:
        for n in names:
            if n in name:
                return n
        name = name.replace("(anonymous namespace)::", "")
        return name.removeprefix("void ").split("(")[0][:60]

    out = Counter()
    for ev in prof.key_averages():
        if ev.device_time_total > 0:
            out[short(ev.key)] += ev.device_time_total / 1e3
    return dict(out)


def profiled(fn):
    """fn() under torch.profiler (host and card), where every
    profiling.stage is a record_function range of its name: (fn's result,
    the profiler's events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        out = fn()
    return out, p.events()


def stage_split(events, prefix: str = "ris.fused.") -> dict:
    """The sub-stages `prefix`* of a profiled() run, split by part: per
    stage its ranges' count and host ms; the entry wait (the first
    synchronising CUDA call of each range: the wait for the work queued
    before it); host ms by top-level part (the ranges' direct children:
    PyTorch ops and CUDA runtime calls such as the wrappers' launches);
    host ms of every CUDA runtime call by name (cudaHostAlloc pins host
    memory, cudaMalloc takes a new device segment, cudaMemcpyAsync and the
    synchronising calls read and copy); `python`, the rest of the ranges;
    and the card's ms by kernel and copy that start inside the ranges."""
    from torch.autograd import DeviceType

    wins = sorted((e for e in events if e.name.startswith(prefix)
                   and e.device_type == DeviceType.CPU),
                  key=lambda e: e.time_range.start)
    if not wins:
        fail(f"no {prefix}* stage range under the profiler")
    out = {w.name: {"ranges": 0, "ms": 0.0, "entry_wait": 0.0,
                    "parts": Counter(), "runtime": Counter(),
                    "device": Counter()} for w in wins}
    for w in wins:
        out[w.name]["ranges"] += 1
        out[w.name]["ms"] += (w.time_range.end - w.time_range.start) / 1e3
    syncs = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
             "cudaEventSynchronize")
    first_sync = set()
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e in wins:
            continue
        t = e.time_range.start
        w = next((w for w in wins
                  if w.time_range.start <= t < w.time_range.end), None)
        if w is None:
            continue
        d, ms = out[w.name], (e.time_range.end - t) / 1e3
        if e.device_type != DeviceType.CPU:
            d["device"][e.name[:48]] += ms
            continue
        if e.name.startswith("cuda"):
            d["runtime"][e.name] += ms
            if e.name in syncs and id(w) not in first_sync:
                first_sync.add(id(w))
                d["entry_wait"] += ms
        if e.cpu_parent is None or e.cpu_parent is w:
            d["parts"][e.name] += ms
    for d in out.values():
        d["python"] = d["ms"] - sum(d["parts"].values())
        for k in ("parts", "runtime", "device"):  # JSON-able, largest first
            d[k] = dict(d[k].most_common())
    return out


def show_split(split: dict) -> str:
    def top(c: dict, k: int = 6) -> str:
        return ", ".join(f"{n} {v:.4f}" for n, v in list(c.items())[:k])

    return "; ".join(
        f"{name}: {d['ranges']} ranges {d['ms']:.4f} ms (entry wait "
        f"{d['entry_wait']:.4f}; parts {top(d['parts'])}; python "
        f"{d['python']:.4f}; CUDA runtime {top(d['runtime'])}; card "
        f"{top(d['device'])})" for name, d in split.items())


def access_bound_ms(B: int, n1: int, band: int, item: int, inside: bool,
                    dtype: str = "float32"):
    """Least time the card could take for one accessibility column scan of
    a batch of B sequences over n1 columns (`item` bytes per value): the
    larger of the bytes it must move over the memory rate and its
    operations over the peak rate of the dtype.

    Bytes, each counted once: the grids the scan reads (15 planes in the
    dtype and 2 bool planes), for the outside scan also the inside pass's
    multi1; the planes it writes (inside: 6, plus A and B; outside: 5);
    the tables K2, Kb and the decay row.
    Operations, per sequence and column, 2 per multiply-add and 1 per add,
    only the terms the function needs (`access_ops_per_column`).

    Returns (bound ms, "bytes" or "operations")."""
    from priblast_tpu_torch.accessibility.batched import ML

    R = ML + 1
    cells = B * n1 * band
    if inside:
        nbytes = cells * (21 * item + 2) + 2 * B * n1 * item
    else:
        nbytes = cells * (21 * item + 2)
    nbytes += (R * R + R + band) * item
    # a column's terms depend on how many columns precede it (inside) or
    # follow it (outside), up to band; both run over c = 0 .. n1 - 1
    full = max(n1 - band, 0)
    ops = B * (sum(access_ops_per_column(band, ML, c, inside)
                   for c in range(n1 - full))
               + full * access_ops_per_column(band, ML, band, inside))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def access_ops_per_column(band: int, ml: int, c: int, inside: bool) -> int:
    """Operations of one column of one sequence of an accessibility scan,
    with c columns before it (inside) or after it (outside): 2 per
    multiply-add, 1 per add, counted from the kernels' loops with the
    terms that are zero by construction left out.

    - the interior-loop contraction: G[r][e] = sum_{u <= min(r, c)} K2[r][u]
      x[e], for r = 2 .. ML (K2's rows 0 and 1 are zero) and the band - r
      entries of row r that the skewed sum reads, then that sum (one add
      per entry);
    - the bulge sums, k = 2 .. ML within the band (Kb[0] = Kb[1] = 0), for
      the same column and the window of columns;
    - inside: the multibif sum over u = 1 .. min(W, d, c), the multi sum
      over e <= d, and the forward and backward exterior steps (5
      operations per term: a product, a difference, an exp, a product, an
      add; min(band - 1, c) terms each way);
    - outside: the multi sum over e >= d, bm1 over t = 1 .. min(W,
      band - 1 - d, c), and the same-column bifurcations over e = d + f <= W;
    - the element-wise terms per span: 28 (inside) and 31 (outside)."""
    import numpy as np

    W = band - 2
    r = np.arange(2, ml + 1)
    d = np.arange(band)
    ops = 2 * int(((np.minimum(r, c) + 1) * (band - r)).sum())
    ops += int((band - r).sum())
    room = d if inside else band - 1 - d   # spans within the band, one way
    ops += 2 * int(np.maximum(np.minimum(ml, room) - 1, 0).sum())
    ops += 2 * int(np.maximum(np.minimum(np.minimum(ml, room), c) - 1,
                              0).sum())
    ops += band
    if inside:
        ops += 2 * int(np.minimum(np.minimum(W, d), c).sum())
        ops += 2 * int((d + 1).sum())
        ops += 2 * 5 * min(band - 1, c)
        ops += 28 * band
    else:
        ops += 2 * int((band - d).sum())
        ops += 2 * int(np.minimum(np.minimum(W, band - 1 - d), c).sum())
        ops += 2 * int(np.maximum(W - d, 0).sum())
        ops += 31 * band
    return ops


def prob_bound_ms(B: int, n1: int, band: int, w: int, item: int,
                  dtype: str = "float32"):
    """Least time the card could take for the probability pass of a batch
    of B sequences over n1 columns at window size w (`item` bytes per
    value): the larger of the bytes it must move over the memory rate and
    its operations over the peak rate of the dtype.

    Bytes, each counted once: the planes it reads (stem_m, stem_a, multi,
    multi2, bse, bse_m, bse_a, b_multi, b_multi2 and the hairpin grid hpW;
    where w <= 2 also stem, the codes and the small-loop tables), A and B,
    logZ, the two kernels' tables; p_w and p_w1 written.
    Operations: `prob_ops_per_row`, once per sequence.

    Returns (bound ms, "bytes" or "operations")."""
    from priblast_tpu_torch.accessibility.batched import ML

    R = ML + 1
    planes = 10 + (w <= 2)
    nbytes = (planes * n1 * band + 2 * n1 + 1 + 2 * (n1 + 1)) * B * item
    nbytes += (R * R + R) * item
    if w <= 2:
        nbytes += B * (n1 + ML + 3) * 8 + 4 * (49 + 8 * 8 * (25 + 125 + 625))
    ops = B * prob_ops_per_row(n1, band, w, ML)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def prob_ops_per_row(n1: int, band: int, w: int, ml: int) -> int:
    """Operations of the probability pass for one sequence over n1 columns
    (N = n1 - 1): 2 per multiply-add, 1 per add, product or exp, counted
    from the loops of csrc/access_prob.cu, with the terms that lie past a
    sequence's columns left out (a loop there does not run).

    Per column c, window kernel:
    - for each loop size u = w .. ML, the interior contraction of each
      side: for the spans e = u+1 .. band-1, min(ML - u, e - u) inner
      terms, then the product with the outer cell and its add (the right
      side where c >= u, the left where c + e <= N);
    - the bulges (u >= 2): one multiply-add per span, then the weight and
      the add, each side;
    - the small-loop specials (w <= 2): two products and an add per span
      of each special that the window reaches;
    - the hairpin products and their suffix sums, the running sums of
      srcL / srcR;
    per window x, sum kernel: the two exterior terms, the multiloop
    products that lie within the sequence's columns, the hairpin, boundary
    and conditional sums, the branch."""
    import numpy as np

    N, W = n1 - 1, band - 2
    c = np.arange(n1)
    ops = np.zeros(n1, np.int64)
    for u in range(w, ml + 1):
        e = np.arange(u + 1, band)
        per = 2 * np.minimum(ml - u, e - u) + 2
        cum = np.concatenate([[0], np.cumsum(per)])
        ops += np.where(c >= u, int(per.sum()), 0)
        ops += cum[np.clip(N - c - u, 0, len(e))]
        if u >= 2:
            nb = band - u
            ops += np.where(c >= u, 2 * nb + 2, 0)
            ops += 2 * np.clip(N - c - u + 1, 0, nb) + 2
    for u1, u2 in ((1, 0), (0, 1), (1, 1), (1, 2), (2, 1), (2, 2)):
        spans = band - u1 - u2
        if u2 >= w:
            ops += np.where(c >= u2, 3 * spans + 1, 0)
        if u1 >= w:
            ops += 3 * np.clip(N - c - u1 - u2 + 1, 0, spans) + 1
    nu = max(ml - w + 1, 0)
    nt = max(nu - 1, 0)
    ops += band + sum(band - o for o in range(w, band - 1))
    ops += nt * (nt + 1) + nu
    x = c
    for wsz in (w, w + 1):
        ops += 3 + 2 * np.clip(N - x + 1 - wsz + 1, 0, max(band - wsz, 0))
        ops += np.where((x >= 1) & (x + wsz - 1 <= N),
                        2 * max(W - wsz + 1, 0), 0) + 1
    ops += np.clip(N - x + 2 - w, 0, max(band - 1 - w, 0)) * 2
    ops += np.minimum(x, nu) + 1 + 2 * nt + 8
    return int(ops.sum())


def grids_bound_ms(B: int, n1: int, band: int, S: int, item: int,
                   inside: bool, dtype: str = "float32"):
    """Least time the card could take for one launch of the weight grids
    (csrc/access_grids.cu) over B sequences, n1 columns and the band
    (`item` bytes per value): the larger of the bytes it must move over
    the memory rate and its operations over the peak rate of the dtype.

    Bytes, each counted once: the codes [B, S] (int64) and lengths read,
    the tables (bp and rtype[bp], stack, the two mismatch tables, int11,
    int21, int22, two dangle tables, AU, two rows of the band; 4 bytes a
    value); the planes written: inside 15 in the dtype and 2 bool,
    outside 14 and 2, which also reads multi2 [N+1, B, band], A and B
    [N+1, B] and logZ.
    Operations per cell, floating point only: inside 14 (the dangle's two
    products, the hairpin weight's, mlclose's two, the six specials' and
    ext_dot's), outside 17 (the seed's three adds, the product d lsig and
    the exp; contW's product, mlclose_o's two, the six specials', the
    last span's mask).

    Returns (bound ms, "bytes" or "operations")."""
    cells = B * n1 * band
    tables = 2 * 25 + 49 + 2 * 175 + 8 * 8 * (25 + 125 + 625) + 2 * 35 + 7
    nbytes = B * S * 8 + B * 8 + 4 * (tables + 2 * band)
    if inside:
        nbytes += cells * (15 * item + 2)
        ops = 14 * cells
    else:
        nbytes += cells * (15 * item + 2) + (2 * n1 + 1) * B * item
        ops = 17 * cells
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def expand_bound_ms(d: int, max_len: int, o: int, B: int, wb, qp, dp,
                    n_kept: int):
    """Least time the card could take for the fused stage's expansion of
    pairs o .. o + B - 1 (csrc/fused_expand.cu), by bytes, from this run's
    pairs: each input byte the block needs read once (its candidates' rows,
    hybrid energies and prefix entries; the suffix-array and position-map
    entries its pairs read, each distinct entry once; the accessibility
    entries their windows cover, each once) and the n_kept survivors' 13
    columns written once (104 bytes each). The kept flags and tile counts,
    scratch of the compaction, are not counted; its operations (a few adds
    and compares per pair) bound it far less. Returns (bound ms, "bytes",
    the bytes)."""
    import torch

    dev = wb.cum.device
    pid = torch.arange(o, o + B, device=dev)
    ci = torch.searchsorted(wb.cum, pid, right=True) - 1
    n_cand = int(ci[-1] - ci[0]) + 1
    row = wb.cand[:, ci]
    off = pid - wb.cum[ci]
    ki = torch.div(off, row[6], rounding_mode="floor")
    qsa, dsa = row[0] + off - ki * row[6], row[1] + ki
    q_sp, db_sp = qp.sa[qsa], dp.sa[dsa]
    length = row[2]
    pos = row[5] + db_sp
    start = dp.pos_ls[pos] - db_sp - length
    end = length.clamp(max=max_len)

    def covered(n: int, lo, hi) -> int:
        """Entries of a buffer of n that the intervals [lo, hi) cover."""
        lo, hi = lo.clamp(0, n), hi.clamp(0, n)
        keep = hi > lo
        mark = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        one = torch.ones(int(keep.sum()), dtype=torch.int32, device=dev)
        mark.index_add_(0, lo[keep], one)
        mark.index_add_(0, hi[keep], -one)
        return int((torch.cumsum(mark, 0)[:n] > 0).sum())

    qa = row[4] + q_sp
    da, dc = dp.pos_aoff[pos] + start, dp.pos_coff[pos] + start
    entries = (covered(qp.bufs[1].shape[0], qa, qa + 1)
               + covered(qp.bufs[2].shape[0], qa + d, qa + end)
               + covered(dp.bufs[1].shape[0], da, da + 1)
               + covered(dp.bufs[2].shape[0], dc + d, dc + end))
    distinct = (int(torch.unique(qsa).numel()) + int(torch.unique(
        dsa).numel())) * 8 + int(torch.unique(pos).numel()) * 32
    nbytes = (n_cand * (7 * 8 + 8 + 8) + 8 + distinct + 4 * entries
              + 104 * n_kept)
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", nbytes


def threshold_bound_ms(n: int, n_kept: int):
    """Least time the card could take for the fused stage's threshold of n
    ungapped hits of which n_kept pass (csrc/fused_expand.cu), by bytes,
    the copy to the host not included: every hit's float32 energy read
    once; each kept hit's fields read once (q_sp, db_sp, the new length,
    dbseq_start, dbseq_id and pid as int64, acc_e and hyb_e as float32: 56
    bytes) and its packed record written once (44 bytes). Returns (bound
    ms, "bytes", the bytes)."""
    nbytes = 4 * n + (56 + 44) * n_kept
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", nbytes


EP_REPS = 100    # launches over which the epilogue launch alone is timed


def epilogue_alone(call) -> dict:
    """The device ms of one launch of `call` (a wrapper that launches one
    kernel and synchronises nothing), without its host work, two ways:
    a CUDA graph of EP_REPS calls replayed between CUDA events, and
    torch.profiler's device time summed over EP_REPS eager calls; each
    over EP_REPS. A way that fails says why."""
    import torch

    out = {}
    try:
        call()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(EP_REPS):
                call()
        out["graph ms"] = f"{cuda_ms(g.replay, 5) / EP_REPS:.5f}"
    except Exception as e:  # reported, not fatal: a measurement only
        out["graph ms"] = f"not measured ({type(e).__name__}: {e})"[:160]
    by_kernel = device_ms_by_kernel(
        lambda: [call() for _ in range(EP_REPS)])
    out["profiler ms"] = (f"{sum(by_kernel.values()) / EP_REPS:.5f}"
                          if by_kernel else "not measured")
    return out


def threshold_sector_bound_ms(energy, cols, thr: float):
    """threshold_bound_ms counted by the 32-byte sectors the reads touch:
    the float32 energy of every hit read once; of each other input column
    (`cols`; a column passed twice, as q_len and db_len, counted once) the
    sectors that hold a kept hit's entry, each once; each kept hit's
    record written once (44 bytes). Returns (bound ms, "bytes", the
    bytes)."""
    import torch

    keep = torch.nonzero(energy.double() <= thr).squeeze(1)
    nbytes = 4 * energy.numel() + 44 * keep.numel()
    for ptr, col in {c.data_ptr(): c for c in cols}.items():
        per = 32 // col.element_size()
        nbytes += 32 * int(torch.unique_consecutive(keep // per).numel())
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", nbytes


def epilogue_bound_ms(B: int, n_max: int, item: int):
    """Least time the card could take for the accessibility epilogue of B
    rows of n_max columns (csrc/access_prob.cu: epilogue_kernel), by bytes:
    p_w and p_w1 at the n_max window starts read once (`item` bytes a
    value) and the lengths; acc and cond written once (float32). Its
    operations (two logs and a few products per element) bound it less.
    Returns (bound ms, "bytes")."""
    nbytes = 2 * B * n_max * item + 8 * B + 2 * B * n_max * 4
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def energies_bound_ms(B: int, n_max: int):
    """Least time the card could take for the window energies' work inside
    the probability pass's sum launch (csrc/access_prob.cu:
    sum_kernel<T, true>), by bytes: p_w and p_w1 stay in registers, so only
    the lengths are read once, and acc and cond written once (float32).
    Returns (bound ms, "bytes")."""
    nbytes = 8 * B + 2 * B * n_max * 4
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def grids_diff(got, ref):
    """(the planes that differ but the seed, the seed's largest distance in
    ulps, the largest |got - ref| over the float planes) of two grids
    tuples."""
    import torch

    differ, ulps, err = [], 0, 0.0
    for name, a, b in zip(ref._fields, got, ref):
        if name == "seed":
            it = torch.int32 if a.dtype == torch.float32 else torch.int64
            ulps = int((a.view(it).long() - b.view(it).long()).abs().max())
        elif not torch.equal(a, b):
            differ.append(name)
        if a.is_floating_point():
            err = max(err, float((a.double() - b.double()).abs().max()))
    return differ, ulps, err


def grids_wrapper_split(ag, side: str, gargs, oin=None,
                        reps: int = 200) -> dict:
    """Host microseconds per call of each part of a grid wrapper
    (ops/access_grids.py: inside_grids, or outside_grids with `oin` = (g,
    multi2, A, B, logZ)) on the card, each part alone in a loop of `reps`
    with the card idle before it: its tensor checks; the lengths' range
    check that a call without `checked` makes (a read from the card); the
    scalars (cached, and as computed before they were); the tables; the
    stream; the two torch.empty; the ctypes arrays of its pointers; the C
    call (the launch's enqueue); the output views; and the whole wrapper,
    as the main path calls it (`checked`) and without `checked` (where
    its read waits for the launches queued before it)."""
    import ctypes
    import math

    import torch
    from priblast_tpu_torch.ops import access_scan as acs
    from priblast_tpu_torch.ops import nvcc

    t, s, lens, n_max, band, dt = gargs
    dev, B = s.device, s.shape[0]
    n1 = n_max + 1
    shape = (n1, B, band)
    outside = None if oin is None else (oin[0], oin[2], oin[3], oin[4],
                                        oin[1])
    names = ag._INSIDE_F if oin is None else ag._OUTSIDE_F
    fn = ag._fn(side, dt)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def checks():
        nvcc.check_tensor(s, "s_padded", (B, s.shape[1]), torch.int64, dev)
        nvcc.check_tensor(lens, "lengths", (B,), torch.int64, dev)
        if oin is not None:
            nvcc.check_tensor(oin[0].dangle_ij, "dangle_ij", shape, dt, dev)
            nvcc.check_tensor(oin[1], "multi2", shape, dt, dev)
            for name, x in (("A_full", oin[2]), ("B_full", oin[3])):
                nvcc.check_tensor(x, name, (n1, B), dt, dev)
            nvcc.check_tensor(oin[4], "logZ", (B,), dt, dev)

    def empties():
        return (torch.empty((len(names), *shape), dtype=dt, device=dev),
                torch.empty((2, *shape), dtype=torch.bool, device=dev))

    planes, flags = empties()
    extra = () if outside is None else tuple(x.data_ptr()
                                             for x in outside[1:])

    def arrays():
        cells = math.prod(shape)
        p0, f0 = planes.data_ptr(), flags.data_ptr()
        item = planes.element_size()
        ptrs = (s.data_ptr(), lens.data_ptr(),
                *(x.data_ptr() for x in ag._tables(band - 2, dev)), *extra,
                *(p0 + k * cells * item for k in range(len(names))),
                f0, f0 + cells)
        sizes = (n1, B, band, s.shape[1], ag.THREADS, 0, ag.TILE)
        sc = ag._scalars(band - 2, dt)
        return ((ctypes.c_void_p * len(ptrs))(*ptrs),
                (ctypes.c_longlong * len(sizes))(*sizes),
                (ctypes.c_double * len(sc))(*sc))

    args = arrays()

    def outputs():
        out = dict(zip(names, planes.unbind(0)))
        m0, m1 = flags.unbind(0)
        return out, m0, m1

    def whole(**kw):
        if oin is None:
            return ag.inside_grids(*gargs, **kw)
        return ag.outside_grids(*gargs, *oin, **kw)

    parts = {"check_tensor": checks,
             "lengths_range": lambda: acs._check_lengths(lens, n_max, B, dev),
             "scalars": lambda: ag._scalars(band - 2, dt),
             "scalars_uncached": lambda: ag._scalars.__wrapped__(band - 2,
                                                                 dt),
             "tables": lambda: ag._tables(band - 2, dev),
             "stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
             "empty": empties, "ctypes_arrays": arrays,
             "c_call": lambda: fn(*args, stream), "outputs": outputs,
             "wrapper": lambda: whole(checked=True),
             "wrapper_range_check": whole}
    out = {}
    for name, part in parts.items():
        part()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            part()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
    return out


def split_child(db: str) -> None:
    """The main path's `ris` (device chain; the queries beside the db
    directory `db`) twice in this process, with the package beside this
    script, each fused stage under torch.profiler; prints the two
    stage_split()s as one JSON line. The split reads the ranges the
    package's stages open under a recording profiler, so the script splits
    only a package whose `profiling.stage` opens them."""
    import torch

    sys.path.insert(0, str(REPO))
    from priblast_tpu_torch import cli
    from priblast_tpu_torch.search import fused

    if not torch.cuda.is_available():
        fail("the split needs a GPU")
    os.environ["PRIBLAST_DEVICE_EXTEND"] = "1"
    work = Path(db).resolve().parent
    stage0, splits = fused.fused_stage, []

    def split(*a, **k):
        out, events = profiled(lambda: stage0(*a, **k))
        splits.append(stage_split(events))
        return out

    fused.fused_stage = split
    for _ in range(2):
        cli.main(["ris", "-i", str(work / "q.fa"), "-o",
                  str(work / "ris_split.txt"), "-d", db])
    print(json.dumps(splits))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--split-child", metavar="DB",
                        help="only split the fused stage of `ris` on the db "
                             "DB (and the q.fa beside it) in this process")
    args = parser.parse_args()
    if args.split_child:
        split_child(args.split_child)
        return 0

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
    from priblast_tpu_torch.ops import access_grids as ag
    from priblast_tpu_torch.ops import access_prob as ap
    from priblast_tpu_torch.ops import access_scan as acs
    from priblast_tpu_torch.ops import fused_expand as fexp
    from priblast_tpu_torch.ops import gapped_sweep, native
    from priblast_tpu_torch.ops import ungapped_extend as uop
    from priblast_tpu_torch.search import fused, gapped, pipeline, seed
    from priblast_tpu_torch.search import ungapped as ung
    from priblast_tpu_torch.utils import alphabet, fasta, store
    from priblast_tpu_torch.utils import profiling as prof
    from priblast_tpu_torch.models import db as db_model
    from priblast_tpu_torch.parallel import dist
    from priblast_tpu_torch.utils.params import DbParams, RisParams

    # ---- 1. device ---------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    cores, affinity = os.cpu_count(), len(os.sched_getaffinity(0))
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()} | "
          f"host cores {cores} (affinity {affinity})", flush=True)
    dev = torch.device("cuda")
    own = dist.local_devices("cuda")
    print(f"[device] --device cuda gives this process "
          f"{[str(d) for d in own]}", flush=True)
    check(own == [torch.device("cuda", i)
                  for i in range(torch.cuda.device_count())],
          f"--device cuda gives {own}, not every card")

    # ---- 2. build, both toolchains started together -------------------------
    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    builds = {"native": native.build, "gapped_extend": gapped_sweep.build,
              "ungapped_extend": uop.build, "access_inside": acs.build_inside,
              "access_outside": acs.build_outside,
              "access_prob": ap.build, "access_grids": ag.build,
              "fused_expand": fexp.build}
    with cf.ThreadPoolExecutor(len(builds)) as ex:
        futs = {k: ex.submit(timed, fn) for k, fn in builds.items()}
        built = {k: f.result() for k, f in futs.items()}
    print("[build] " + " | ".join(f"{k} {so.name} {t:.1f}s"
                                  for k, (so, t) in built.items()),
          flush=True)

    # the accessibility kernels' launch counters, in the order of a batch;
    # the window energies' work is the sum launches that carry it (the
    # epilogue kernel, off the main path, has a counter of its own)
    access_counters = {"access_grids_inside": (ag, "inside_grids_launches"),
                       "access_inside": (acs, "inside_launches"),
                       "access_grids_outside": (ag, "outside_grids_launches"),
                       "access_outside": (acs, "outside_launches"),
                       "access_prob": (ap, "prob_launches"),
                       "access_epilogue": (ap, "energies_launches")}

    def access_counts() -> dict:
        return {k: getattr(m, a) for k, (m, a) in access_counters.items()}

    def zero_access_counts() -> None:
        for m, a in access_counters.values():
            setattr(m, a, 0)
        ap.epilogue_launches = 0

    # the fused stage's kernels' launch counters
    def fused_counts() -> dict:
        return {"fused_expand": fexp.expand_launches,
                "fused_threshold": fexp.threshold_launches}

    def zero_fused_counts() -> None:
        fexp.expand_launches = fexp.threshold_launches = 0

    # calls of the plain versions that the card's kernels replace: none on
    # a path that runs on the card
    plain_calls = Counter()

    def recording(module, name: str):
        fn0 = getattr(module, name)

        def rec(*a, **k):
            plain_calls[name] += 1
            return fn0(*a, **k)

        return fn0, rec

    plain_fns = [(m, n, *recording(m, n)) for m, n in (
        (batched, "make_grids"), (batched, "make_outside_grids"),
        (batched, "scan_probabilities"),
        (batched, "accessibility_from_probabilities"),
        (fused, "_expand_core"), (fused, "_thresh_core"))]

    def record_plain_calls(on: bool) -> None:
        plain_calls.clear()
        for m, n, fn0, rec in plain_fns:
            setattr(m, n, rec if on else fn0)

    # ---- 3. main path at full size -----------------------------------------
    work = REPO / "build" / "chip_smoke"
    db_nt = write_workload(work, args.seed)

    # instrumentation: where accessibility ran, the query accessibilities
    # the device chain used, the mid stage's inputs and cost, the
    # mid-stage streams it extended, and the inputs of the first fused
    # stage and gapped and ungapped launches (the main path's own shapes)
    acc_devices, q_access, mid_streams, mid_runs = set(), {}, [], []
    access_batches = []     # (codes, lengths) of every accessibility batch
    first_sweep, first_ungapped, first_fused = [], [], []
    # the overflow fallback's submitted batches and its inputs at the patch;
    # the gapped stage's threads
    submits, fallbacks, gapped_threads = [], [], []
    run0 = batched.BatchedRaccess.run
    access0 = ris_gpu._accessibility_batched
    gstage0 = pipeline.gapped_stage
    kernel = gapped_sweep.gapped_extend_dir
    ukernel = uop.ungapped_extend
    fstage0 = fused.fused_stage
    mid0 = pipeline.mid_stage
    fb_submit0 = pipeline.OverflowFallback.submit
    fb_patch0 = pipeline.OverflowFallback.patch
    # the pair count of every wave (the fused stage's launch plan)
    wave_pairs = []
    wb_init0 = fused._WaveBuffers.__init__

    def wb_rec(self, *a, **kw):
        wb_init0(self, *a, **kw)
        wave_pairs.append(self.tot)

    def run_rec(self, codes, lengths):
        acc_devices.update(str(d) for d in self.devices)
        access_batches.append((codes.copy(), np.asarray(lengths).copy()))
        return run0(self, codes, lengths)

    def access_rec(engine, seqs, lengths, idxs):
        out = access0(engine, seqs, lengths, idxs)
        q_access.update(out)
        return out

    def gstage_rec(stream, *a, **k):
        mid_streams.append({key: v.copy() for key, v in stream.soa.items()})
        gapped_threads.append(k.get("threads"))
        return gstage0(stream, *a, **k)

    def fb_submit_rec(self, overflow, start=0):
        submits.append((self, start, overflow.copy()))
        return fb_submit0(self, overflow, start)

    def fb_patch_rec(self, segments):
        fallbacks.append((self, pipeline.HitStream(
            {key: v.copy() for key, v in self.stream.soa.items()},
            list(self.stream.groups)), segments))
        return fb_patch0(self, segments)

    def sweep_rec(*a, **k):
        if not first_sweep:
            first_sweep.append((a, k))
        return kernel(*a, **k)

    def ungapped_rec(*a):
        if not first_ungapped:
            first_ungapped.append(a)
        return ukernel(*a)

    def fstage_rec(*a, **k):
        if not first_fused:
            first_fused.append((a, k))
        return fstage0(*a, **k)

    def mid_rec(stream, *a, **k):
        u0 = usage()
        out = mid0(stream, *a, **k)
        mid_runs.append((stream, a, k, since(u0)))
        return out

    batched.BatchedRaccess.run = run_rec
    ris_gpu._accessibility_batched = access_rec
    pipeline.gapped_stage = gstage_rec
    gapped_sweep.gapped_extend_dir = sweep_rec
    uop.ungapped_extend = ungapped_rec
    fused.fused_stage = fstage_rec
    pipeline.mid_stage = mid_rec
    pipeline.OverflowFallback.submit = fb_submit_rec
    pipeline.OverflowFallback.patch = fb_patch_rec
    fused._WaveBuffers.__init__ = wb_rec
    record_plain_calls(True)

    db_gpu, out_gpu = work / "db_gpu", work / "ris_gpu.txt"
    # the main path is the device chain: the router's default, auto, may
    # send queries to the host chain
    os.environ["PRIBLAST_DEVICE_EXTEND"] = "1"
    prof.reset()
    torch.cuda.reset_peak_memory_stats()
    gapped_sweep.launches = uop.launches = 0
    zero_access_counts()
    zero_fused_counts()
    t0 = time.perf_counter()
    cli.main(["db", "-i", str(work / "db.fa"), "-o", str(db_gpu)])
    t_db = time.perf_counter() - t0
    n_db_batches = len(access_batches)
    t0 = time.perf_counter()
    cli.main(["ris", "-i", str(work / "q.fa"), "-o", str(out_gpu), "-d",
              str(db_gpu)])
    t_ris = time.perf_counter() - t0
    launches, ulaunches = gapped_sweep.launches, uop.launches
    alaunches = access_counts()
    epi_main = ap.epilogue_launches
    flaunches = fused_counts()
    plain_main = dict(plain_calls)
    stages = prof.snapshot()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batched.BatchedRaccess.run = run0
    ris_gpu._accessibility_batched = access0
    pipeline.gapped_stage = gstage0
    gapped_sweep.gapped_extend_dir = kernel
    uop.ungapped_extend = ukernel
    fused.fused_stage = fstage0
    pipeline.mid_stage = mid0
    pipeline.OverflowFallback.submit = fb_submit0
    pipeline.OverflowFallback.patch = fb_patch0
    fused._WaveBuffers.__init__ = wb_init0
    record_plain_calls(False)

    check(acc_devices == {"cuda:0"}, f"accessibility ran on {acc_devices}")
    check("ris.fused.ungapped" in stages,
          f"the main path did not run the fused stage: {sorted(stages)}")
    check(launches > 0, "the gapped kernel was never launched")
    check(ulaunches > 0, "the ungapped kernel was never launched")
    for name, n in alaunches.items():
        check(n == len(access_batches),
              f"{name} launched {n} times for {len(access_batches)} "
              "accessibility batches")
    check(epi_main == 0, f"the epilogue kernel launched {epi_main} times on "
          "the main path, whose sum launches write the energies")
    check(0 < n_db_batches < len(access_batches),
          "db or ris ran no accessibility batch")
    check(not plain_main, f"plain versions ran on the main path: "
          f"{plain_main}")
    # one expansion per block of every wave (one card: no shards), one
    # threshold per block with survivors, as the ungapped kernel
    main_block = fused.block_cap(dev)
    fused_plan = sum(-(-n // main_block) for n in wave_pairs)
    check(flaunches["fused_expand"] == fused_plan,
          f"the expansion launched {flaunches['fused_expand']} times for "
          f"{fused_plan} pair blocks of the waves of {wave_pairs} pairs")
    check(flaunches["fused_threshold"] == ulaunches > 0,
          f"the threshold launched {flaunches['fused_threshold']} times, "
          f"the ungapped kernel {ulaunches}")
    gpu_lines = body(out_gpu)
    check(len(gpu_lines) > 100, f"only {len(gpu_lines)} hits")
    for line in gpu_lines:
        e = [float(x) for x in line.split(",")[5:8]]
        check(all(np.isfinite(e)), f"non-finite energy in {line}")
    tag = f"({card})"
    print(f"[main] db {db_nt} nt in {t_db:.3f}s = {db_nt / t_db:.1f} nt/s; "
          f"ris {N_Q} queries in {t_ris:.3f}s = {N_Q / t_ris:.4f} q/s; "
          f"{len(gpu_lines)} hits; kernel launches: ungapped {ulaunches}, "
          f"gapped {launches}, "
          + ", ".join(f"{k} {n}" for k, n in {**flaunches,
                                               **alaunches}.items())
          + f" (access_epilogue: the sum launches that write the energies), "
          f"epilogue_kernel {epi_main} ({n_db_batches} db + "
          f"{len(access_batches) - n_db_batches} ris "
          f"batches; {len(wave_pairs)} wave(s) of {wave_pairs} pairs in "
          f"blocks of {main_block}, {fused_plan} planned); plain versions "
          f"called on the main path: "
          + ", ".join(f"{n} {plain_main.get(n, 0)}"
                      for _m, n, _f, _r in plain_fns)
          + f"; peak device memory {peak_gb:.2f} GB {tag}",
          flush=True)
    print("[main] stage seconds " + json.dumps(
        {k: round(v, 4) for k, v in sorted(stages.items())}) + f" {tag}",
        flush=True)
    n_gapped = sum(len(ms["q_sp"]) for ms in mid_streams)
    n_over = sum(int(np.count_nonzero(f[2])) for f in submits)
    main_sha = body_sha256(out_gpu)
    fb_s = {k: stages.get(f"ris.gapped.{k}", 0.0)
            for k in ("rerun", "rerun_wait", "patch")}
    print(f"[main] gapped overflow: {n_over} of {n_gapped} gapped hits past "
          f"max_ext ({n_over / max(n_gapped, 1):.4%}); host fallback: native "
          f"calls {fb_s['rerun']:.4f} s summed over a pool of "
          f"{submits[0][0].workers} threads (ris threads {gapped_threads}) "
          f"beside the next hit batches, then a wait of "
          f"{fb_s['rerun_wait']:.4f} s and a patch of {fb_s['patch']:.4f} s "
          f"(no per-hit loop), in ris.gapped {stages['ris.gapped']:.4f} s; "
          f"ris body sha256 {main_sha} {tag}", flush=True)

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

    threads = min(32, os.cpu_count() or 1)     # ris's default
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(threads) as ex:
        per_q = dict(zip(order, ex.map(host_chain, order)))
    host_lines = [f"0,{line}" for i in order for line in per_q[i]]
    t_host = time.perf_counter() - t0
    frac, matched, de = compare_lines(host_lines, gpu_lines)
    print(f"[chain] device chain vs host chain on the same accessibilities: "
          f"{matched}/{len(host_lines)} lines agree ({frac:.6f}), max energy "
          f"diff {de:.3g} kcal/mol (host chain {t_host:.2f}s on {threads} "
          "threads)", flush=True)
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

    # ---- 4c. the first runs' excess: the mid stage and the candidate
    # packing again on the main path's inputs, warm, then after the C
    # heap's free pages went back to the OS
    check(len(mid_runs) >= 1, "no mid stage captured")
    check(len(first_fused) == 1, "no fused stage inputs captured")
    m_stream, m_a, m_k, m_first = mid_runs[0]
    (f_p, f_cands, f_qp, f_dp), _fk = first_fused[0]
    again = {}
    for label in ("again", "after malloc_trim"):
        if label != "again":
            trim_heap()
        u0 = usage()
        mid0(m_stream, *m_a, **m_k)
        again["mid " + label] = since(u0)
        u0 = usage()
        wb = fused._WaveBuffers(f_cands, f_qp, f_dp, dev)
        torch.cuda.synchronize()
        again["pack " + label] = since(u0)
    print(f"[first use] the main path's mid stage ({len(mid_runs)} wave(s), "
          f"first {len(m_stream)} hits) {show_usage(m_first)}; "
          + "; ".join(f"{k} {show_usage(u)}" for k, u in again.items())
          + f"; main path's ris.fused.pack {stages['ris.fused.pack']:.4f} s "
          f"({wb.tot} pairs) {tag}", flush=True)
    mid_runs.clear()

    # ---- 4d. the fused stage's split by part on the main path (the
    # process's first) and again on the same wave (its second); then one
    # pair block of the main path's wave again, at the main path's block
    # size: its device memory per pair and its sub-stages
    child = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--split-child",
         str(db_gpu)], capture_output=True, text=True)
    check(child.returncode == 0, "the split of the main path in a fresh "
          f"process failed: {child.stderr[-2000:]}")
    for label, split in zip(("first", "second"), json.loads(
            child.stdout.strip().splitlines()[-1])):
        print(f"[fused] split of the main path's fused stage in a fresh "
              f"process, its {label} ris (torch.profiler over the stage): "
              f"{show_split(split)} {tag}", flush=True)
    block = min(fused.block_cap(dev), wb.tot)
    per_cand = torch.diff(wb.cum)
    # the candidates whose pairs start before the block's end
    n_in = int(torch.searchsorted(wb.cum[:-1], torch.tensor(
        [block], device=wb.cum.device)))
    in_block = per_cand[:n_in]
    in_block = in_block[in_block > 0].double()
    q = torch.quantile(in_block.cpu(), torch.tensor(
        [0.1, 0.5, 0.9, 0.99], dtype=torch.float64))
    print(f"[fused] pairs per candidate over the main path's first block: "
          f"{in_block.numel()} candidates, mean "
          f"{float(in_block.mean()):.3f}, quantiles 0.1/0.5/0.9/0.99 "
          + "/".join(f"{float(v):.0f}" for v in q)
          + f", max {int(in_block.max())}; share of the block's pairs in "
          f"candidates of >= 256 pairs "
          f"{float(in_block[in_block >= 256].sum() / in_block.sum()):.4f} "
          f"{tag}", flush=True)
    # the main path's wave again through its blocks, two in flight (a
    # block's records stay on the card until the next block's expansion
    # has been launched): the peak device memory per pair of a block,
    # against the stream of the main path's fused stage; then under
    # torch.profiler: no host memory pinned (the ring is the process's)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    prof.reset()
    stream_all = fused.run_blocks(f_p, wb, f_qp, f_dp, dev)
    per_pair = (torch.cuda.max_memory_allocated() - base) / block
    blocks_s = prof.snapshot()
    _again, events = profiled(lambda: fused.run_blocks(f_p, wb, f_qp, f_dp,
                                                       dev))
    pinned = sum(e.name in ("cudaHostAlloc", "cudaMallocHost")
                 for e in events)
    del _again, events
    print(f"[fused] the main path's wave again in blocks of {block} pairs "
          f"({-(-wb.tot // block)} blocks, two in flight): "
          f"{len(stream_all)} hits kept; peak device memory {per_pair:.1f} B "
          f"per pair of a block (PAIR_BYTES {fused.PAIR_BYTES}); pinned host "
          f"allocations in a second run {pinned}; seconds "
          + json.dumps({k: round(v, 4) for k, v in sorted(blocks_s.items())})
          + f" {tag}", flush=True)
    check(per_pair <= fused.PAIR_BYTES,
          f"a pair block takes {per_pair:.1f} B per pair, more than "
          f"fused.PAIR_BYTES = {fused.PAIR_BYTES}")
    check(pinned == 0, f"the fused stage pinned host memory {pinned} times "
          "after its first use")
    del stream_all
    # the expansion and threshold kernels against their plain versions on
    # that block, bit for bit, then timed beside their bounds
    d_acc, max_len = f_p.min_accessible_length, f_p.max_seed_length
    thr = f_p.interaction_energy_threshold
    eargs = (d_acc, max_len, 0, block, wb, f_qp, f_dp)
    hits_k, hits_p = fexp.expand(*eargs), fused._expand_core(*eargs)
    torch.cuda.synchronize()
    check(list(hits_k) == list(hits_p), "the expansion's columns differ")
    for key, a in hits_k.items():
        b = hits_p[key]
        check(a.dtype == b.dtype and torch.equal(
            a.view(torch.int64), b.view(torch.int64)),
            f"the expansion kernel's {key} differs from _expand_core's")
    del hits_p
    n_exp = len(hits_k["pid"])
    res = uop.ungapped_extend(
        hits_k["q_sp"], hits_k["db_sp"], hits_k["length"],
        hits_k["dbseq_start"], hits_k["acc_e"].float(),
        hits_k["hyb_e"].float(), hits_k["qb"], hits_k["qab"], hits_k["dbb"],
        hits_k["aoff"], hits_k["coff"], f_qp.bufs, f_dp.bufs, d_acc,
        f_p.drop_out_length_wo_gap)
    rec_k = fexp.threshold(f_p, res, hits_k)
    rec_p = fused._thresh_core(f_p, res, hits_k)

    def same_records(a: dict, b: dict) -> bool:
        return list(a) == list(b) and all(
            a[key].dtype == v.dtype and np.array_equal(
                a[key].view(np.uint8), v.view(np.uint8))
            for key, v in b.items())

    check(same_records(rec_k, rec_p),
          "the threshold's records differ from _thresh_core's")
    n_thr = len(rec_k["pid"])
    del rec_p
    flib, stream = fexp._lib(), torch.cuda.current_stream().cuda_stream
    # both kernels at other geometries, bit for bit, and timed: a CTA per
    # SM, a CTA per tile, and other threads per CTA (the main path: as many
    # CTAs as the card holds at once, of fexp.EXPAND_THREADS and
    # fexp.THRESH_THREADS threads)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = {"expansion": {}, "threshold launch": {}}
    for name, n_items, threads_all in (
            ("expansion", block, (fexp.EXPAND_THREADS, 64, 256, 512)),
            ("threshold launch", n_exp, (fexp.THRESH_THREADS, 128, 256,
                                         1024))):
        for threads, grid in ((threads_all[0], sms), (threads_all[0], -1),
                              *((t, 0) for t in threads_all[1:])):
            g = -(-n_items // threads) if grid < 0 else grid
            if name == "expansion":
                got = fexp.expand_call(flib, *eargs, stream, threads, g)
                check(all(torch.equal(got[key].view(torch.int64),
                                      a.view(torch.int64))
                          for key, a in hits_k.items()),
                      f"the expansion kernel differs at {g} CTAs of "
                      f"{threads}")
                del got

                def call():
                    fexp.expand_call(flib, *eargs, stream, threads, g)
            else:
                check(same_records(fexp.threshold_call(
                    flib, thr, res, hits_k, stream, threads, g), rec_k),
                    f"the threshold kernel differs at {g} CTAs of "
                    f"{threads}")

                def call():
                    fexp.threshold_launch(flib, thr, res, hits_k, stream,
                                          threads, g)
            shapes[name][f"{threads} threads " + (
                "a CTA per tile" if grid < 0 else
                f"{grid or 'default'} CTAs")] = cuda_ms(call, 5)
    ms_exp = cuda_ms(lambda: fexp.expand(*eargs), 5)
    plain_exp = cuda_ms(lambda: fused._expand_core(*eargs), 2)
    # the threshold's launch alone (no read, no copy), then the whole
    # wrapper (the count read and the records' copy to the host through
    # the pinned ring, into new host arrays)
    ms_thr = cuda_ms(lambda: fexp.threshold_launch(flib, thr, res, hits_k,
                                                   stream), 5)
    ms_thr_all = cuda_ms(lambda: fexp.threshold(f_p, res, hits_k), 5)
    plain_thr = cuda_ms(lambda: fused._thresh_core(f_p, res, hits_k), 2)
    thr_cols = (*(res[key] for key in (*uop.INT_KEYS, *uop.FLOAT_KEYS)),
                hits_k["dbseq_id"], hits_k["pid"])

    def compaction():
        """The threshold by the library: torch.nonzero and boolean
        indexing of the same columns."""
        keep = torch.nonzero(res["energy"].double() <= thr).squeeze(1)
        return [col[keep] for col in thr_cols]

    lib_thr = cuda_ms(compaction, 5)
    dev_exp = device_ms_by_kernel(lambda: fexp.expand(*eargs),
                                  ("expand_kernel",))
    dev_thr = device_ms_by_kernel(
        lambda: fexp.threshold_launch(flib, thr, res, hits_k, stream),
        ("thresh_kernel",))
    exp_bound, exp_by, exp_bytes = expand_bound_ms(
        d_acc, max_len, 0, block, wb, f_qp, f_dp, n_exp)
    thr_bound, thr_by, thr_bytes = threshold_bound_ms(n_exp, n_thr)
    sec_bound, _by, sec_bytes = threshold_sector_bound_ms(
        res["energy"], thr_cols[:7] + thr_cols[8:], thr)
    print(f"[fused] fused_expand on that block ({block} pairs, {n_exp} "
          f"survivors, every column bit for bit with _expand_core, also at "
          f"the geometries below): "
          f"{ms_exp:.4f} ms through the wrapper (its one read included), "
          f"plain {plain_exp:.2f} ms, bound {exp_bound:.6f} ms ({exp_by}, "
          f"{exp_bytes} bytes), {ms_exp / exp_bound:.1f}x bound; launches "
          f"by torch.profiler " + (", ".join(
              f"{k} {v:.4f}" for k, v in dev_exp.items()) or "not measured")
          + f"; library none {tag}", flush=True)
    print(f"[fused] fused_threshold on its ungapped output ({n_exp} hits, "
          f"{n_thr} kept, every record bit for bit with _thresh_core, also "
          f"at the geometries below): "
          f"{ms_thr:.4f} ms for the launch, {ms_thr_all:.4f} ms through "
          f"the wrapper (the count read and the records' "
          f"{fexp.RECORD_BYTES * n_thr} bytes to new host arrays through the "
          f"pinned ring), plain "
          f"{plain_thr:.2f} ms (with its ten copies), bound "
          f"{thr_bound:.6f} ms ({thr_by}, {thr_bytes} bytes, the copy not "
          f"included), {ms_thr / thr_bound:.1f}x bound; by the 32-byte "
          f"sectors its reads touch {sec_bound:.6f} ms ({sec_bytes} bytes), "
          f"{ms_thr / sec_bound:.2f}x that; library "
          f"(torch.nonzero and boolean indexing of the same columns) "
          f"{lib_thr:.4f} ms; launches by torch.profiler " + (", ".join(
              f"{k} {v:.4f}" for k, v in dev_thr.items()) or "not measured")
          + f" {tag}", flush=True)
    for name, times in shapes.items():
        print(f"[fused] the {name} at other geometries, ms (the expansion "
              "through its wrapper): " + "; ".join(
                  f"{k} {v:.4f}" for k, v in times.items()) + f" {tag}",
              flush=True)
    fused_rec = {
        "fused_expand": dict(ms=ms_exp, plain_ms=plain_exp,
                             bound_ms=exp_bound, bound_by=exp_by, err=0.0,
                             library_ms=None),
        "fused_threshold": dict(ms=ms_thr, plain_ms=plain_thr,
                                bound_ms=thr_bound, bound_by=thr_by, err=0.0,
                                library_ms=lib_thr)}
    n_pairs = wb.tot
    del wb, hits_k, res, rec_k, thr_cols
    first_fused.clear()

    # ---- 4e. the staged oracle against the fused stage, first queries ---
    queries = []
    for idx in order[:N_STAGED]:
        q_enc = alphabet.encode_query(seqs[idx], p.repeat_flag)
        queries.append((q_enc, native.sa_build(q_enc), *q_access[idx]))
    dp = pipeline.DbPack(chunks, devices=dev)
    qp = pipeline.QueryPack(*([q[k] for q in queries] for k in (0, 2, 3, 1)),
                            devices=dev)
    t0 = time.perf_counter()
    s_st = pipeline.seed_stage(p, chunks, queries, threads)
    pipeline._hit_bases(s_st, qp, dp)
    pipeline.ungapped_stage(s_st, qp, dp, p, device=dev)
    s_st = pipeline.threshold_stage(s_st, p)
    t_st = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_fu = fused.fused_stage(p, seed.seed_candidates(p, chunks, queries,
                                                     threads),
                             qp, dp, devices=dev)
    t_fu = time.perf_counter() - t0
    check(len(s_fu) > 0, "no post-threshold hits in the staged/fused phase")
    check(s_st.groups == s_fu.groups, "staged and fused groups differ")
    for k in pipeline.STREAM_KEYS:
        check(s_st.soa[k].dtype == s_fu.soa[k].dtype
              and np.array_equal(s_st.soa[k], s_fu.soa[k]),
              f"staged and fused streams differ in {k}")
    print(f"[staged] {N_STAGED} queries: the staged oracle and the fused "
          f"stage give identical post-threshold streams ({len(s_fu)} hits, "
          f"{len(s_fu.groups)} groups, all fields); staged {t_st:.3f}s, "
          f"seed DFS + fused stage {t_fu:.3f}s {tag}", flush=True)

    # ---- 4f. the overflow fallback at one thread (every flag at once)
    # and at the main path's thread count (in its hit batches), on the main
    # path's overflowed hits
    check(len(fallbacks) >= 1 and n_over > 0,
          "the main path sent no hit to the overflow fallback")
    fb_main, f_stream, f_segs = fallbacks[0]
    f_batches = [(start, flags) for obj, start, flags in submits
                 if obj is fb_main]
    f_threads = gapped_threads[0]
    outs = {}
    for th in (1, f_threads):
        st = pipeline.HitStream({key: v.copy() for key, v in
                                 f_stream.soa.items()}, f_stream.groups)
        t0 = time.perf_counter()
        with pipeline.OverflowFallback(st, fb_main.chunks, fb_main.queries,
                                       fb_main.p, th) as fb:
            if th == 1:
                fb.submit(np.concatenate([f for _, f in f_batches]))
            else:
                for start, flags in f_batches:
                    fb.submit(flags, start)
            bps = pipeline.assemble_bps(fb.patch(f_segs))
        outs[th] = (st, bps, time.perf_counter() - t0)
    (s1, b1, t1), (sn, bn, tn) = outs[1], outs[f_threads]
    for key in pipeline.STREAM_KEYS:
        check(s1.soa[key].dtype == sn.soa[key].dtype
              and np.array_equal(s1.soa[key], sn.soa[key]),
              f"fallback at 1 and {f_threads} threads: {key} differs")
    for key in ("bp_off", "bp_q", "bp_db"):
        check(np.array_equal(b1[key], bn[key]),
              f"fallback at 1 and {f_threads} threads: {key} differs")
    print(f"[fallback] {sum(int(np.count_nonzero(f)) for _, f in f_batches)}"
          f" overflowed of {len(s1)} hits of the main path's first wave: 1 "
          f"thread, every flag at once, {t1:.4f} s; {f_threads} threads (a "
          f"pool of {fb_main.workers}), in "
          f"the main path's {len(f_batches)} hit batches, {tn:.4f} s (native "
          f"calls, patch and assembly); stream fields and base pairs "
          f"({len(b1['bp_q'])} pairs) identical {tag}", flush=True)
    fallbacks.clear()
    submits.clear()
    del outs, s1, b1, sn, bn

    # ---- 4g. the router's rates, from the main path (device chain) and
    # the host chain of phase 4a, on this host
    post_mid = sum(len(ms["q_sp"]) for ms in mid_streams)
    q1 = order[-1]                      # the shortest query: a small wave
    q_enc = alphabet.encode_query(seqs[q1], p.repeat_flag)
    one = [(q_enc, native.sa_build(q_enc), *q_access[q1])]
    qp1 = pipeline.QueryPack(*([q[k] for q in one] for k in (0, 2, 3, 1)),
                             devices=dev)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipeline.search_all(p, chunks, one, qp1, dp, devices=dev,
                            threads=threads)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    rates = {
        "HOST_PAIR_RATE": n_pairs / (t_host * threads),
        "DEV_PAIR_RATE": n_pairs / (stages["ris.seed"] + stages["ris.fused"]),
        "HIT_DENSITY": post_mid / n_pairs,
        "DEV_HIT_RATE": post_mid / (stages["ris.mid"] + stages["ris.gapped"]
                                    + stages["ris.finish"]),
        "DEV_DISPATCH_S": sorted(walls)[1],
    }
    print(f"[router] rates measured on this host: {json.dumps(rates)} "
          f"(router constants: " + json.dumps(
              {k: getattr(ris_gpu, k) for k in rates}) + f"); {n_pairs} "
          f"candidate pairs, {post_mid} hits after the mid stage, host chain "
          f"{t_host:.3f} s on {threads} threads, one-query device waves "
          + ", ".join(f"{w:.4f}" for w in walls) + f" s; host cores {cores} "
          f"(affinity {affinity}) {tag}", flush=True)

    # ---- 4h. ris with the host chain on device accessibilities
    def run_ris(mode: str, out: Path) -> float:
        """`ris` in router mode `mode`, with every launch count set to 0
        just before it (read just after by the caller)."""
        os.environ["PRIBLAST_DEVICE_EXTEND"] = mode
        gapped_sweep.launches = uop.launches = 0
        zero_access_counts()
        zero_fused_counts()
        t0 = time.perf_counter()
        cli.main(["ris", "-i", str(work / "q.fa"), "-o", str(out), "-d",
                  str(db_gpu)])
        return time.perf_counter() - t0

    def scans_ran(phase: str) -> None:
        n_ris = len(access_batches) - n_db_batches
        counts = access_counts()
        check(all(n == n_ris for n in counts.values()),
              f"{phase}: the accessibility kernels launched "
              f"{json.dumps(counts)} times for {n_ris} ris batches")

    out_host = work / "ris_host.txt"
    t_he = run_ris("0", out_host)
    want = [f"{i},{line}" for i, line in
            enumerate(line for idx in order for line in per_q[idx])]
    got = body(out_host)
    n_diff = sum(a != b for a, b in zip(want, got)) + abs(len(want)
                                                          - len(got))
    print(f"[host-extend] ris with PRIBLAST_DEVICE_EXTEND=0: {N_Q} queries in "
          f"{t_he:.3f}s = {N_Q / t_he:.4f} q/s; {len(got)} lines, {n_diff} "
          f"differ from the host chain of phase 4a; extension kernel "
          f"launches: ungapped {uop.launches}, gapped {gapped_sweep.launches}"
          f", {json.dumps(fused_counts())} {tag}", flush=True)
    check(n_diff == 0, f"host-extend body differs from the host chain on "
          f"{n_diff} lines")
    check(uop.launches == 0 and gapped_sweep.launches == 0
          and not any(fused_counts().values()),
          "an extension kernel ran with PRIBLAST_DEVICE_EXTEND=0")
    scans_ran("host-extend")

    # ---- 4i. ris with the hybrid split (forced: the router's default
    # keeps it off where the device chain alone wins), then ris in the
    # router's default
    os.environ["PRIBLAST_HYBRID"] = "1"
    splits = []
    split0, cal0 = ris_gpu.split_wave, ris_gpu._calibrate

    def split_rec(pairs_by_q, threads_, n_dev):
        hd = split0(pairs_by_q, threads_, n_dev)
        splits.append(dict(pairs=dict(pairs_by_q), threads=threads_,
                           n_dev=n_dev, hr=ris_gpu._host_rate(threads_),
                           dr=ris_gpu._dev_rate(n_dev), split=hd))
        return hd

    def cal_rec(side, n, wall):
        # each side of a wave calibrates once, the device side on its own
        # thread; after the later of the two, "cal" holds both
        cal0(side, n, wall)
        splits[-1].setdefault("wall", {})[side] = wall
        splits[-1]["cal"] = dict(ris_gpu._CAL)

    ris_gpu._CAL.update(host=None, dev=None)
    ris_gpu.split_wave, ris_gpu._calibrate = split_rec, cal_rec
    out_hyb = work / "ris_hybrid.txt"
    try:
        t_hy = run_ris("auto", out_hyb)
    finally:
        ris_gpu.split_wave, ris_gpu._calibrate = split0, cal0
        os.environ.pop("PRIBLAST_HYBRID", None)
    check(len(splits) >= 1, "the hybrid split never ran")
    any_dev = False
    for wi, sp in enumerate(splits):
        host_q, dev_q = sp["split"]
        any_dev |= bool(dev_q)
        walls_w = sp.get("wall", {})
        print(f"[hybrid] wave {wi}: host {len(host_q)} queries "
              f"{sum(sp['pairs'][q] for q in host_q)} pairs wall "
              f"{walls_w.get('host')} s; device {len(dev_q)} queries "
              f"{sum(sp['pairs'][q] for q in dev_q)} pairs wall "
              f"{walls_w.get('dev')} s; rates at the split host "
              f"{sp['hr']:.1f} device {sp['dr']:.1f} pairs/s (dispatch "
              f"{ris_gpu.DEV_DISPATCH_S} s, {sp['threads']} threads); "
              f"calibrated {json.dumps(sp.get('cal'))} {tag}", flush=True)
        saved = dict(ris_gpu._CAL)
        ris_gpu._CAL.update(host=sp["hr"], dev=sp["dr"])
        again = ris_gpu.split_wave(sp["pairs"], sp["threads"], sp["n_dev"])
        ris_gpu._CAL.update(saved)
        check(again == sp["split"], f"wave {wi}: the split differs from "
              "split_wave on the printed pairs and rates")
    check((uop.launches > 0) == any_dev and (gapped_sweep.launches > 0)
          == any_dev and all((n > 0) == any_dev
                             for n in fused_counts().values()),
          f"extension kernels launched (ungapped {uop.launches}, "
          f"gapped {gapped_sweep.launches}, {json.dumps(fused_counts())}) "
          f"but the device side had {'some' if any_dev else 'no'} queries")
    scans_ran("hybrid")
    frac, matched, de = compare_lines(gpu_lines, body(out_hyb))
    print(f"[hybrid] ris {N_Q} queries in {t_hy:.3f}s = {N_Q / t_hy:.4f} q/s "
          f"(PRIBLAST_HYBRID=1); kernel launches ungapped {uop.launches}, gapped "
          f"{gapped_sweep.launches}; against the main path {matched}/"
          f"{len(gpu_lines)} lines agree ({frac:.6f}), max energy diff "
          f"{de:.3g} kcal/mol {tag}", flush=True)
    check(frac >= 0.999, f"hybrid/main agreement {frac} < 0.999")
    check(de <= 1e-3, f"hybrid/main energy diff {de} > 1e-3")

    # the router's default (PRIBLAST_HYBRID unset): per wave the chains it
    # chose, against device_extend_wins on the wave's pairs
    routes = []
    route0 = ris_gpu.route

    def route_rec(p_, chunks_, queries_, mode, devices, threads_):
        out = route0(p_, chunks_, queries_, mode, devices, threads_)
        n = sum(out[3].values())
        routes.append(dict(host=len(out[0]), dev=len(out[1]), pairs=n,
                           dev_wins=ris_gpu.device_extend_wins(
                               n, threads_, len(dist.distinct(devices)))))
        return out

    ris_gpu._CAL.update(host=None, dev=None)
    ris_gpu.route = route_rec
    out_def = work / "ris_default.txt"
    try:
        t_def = run_ris("auto", out_def)
    finally:
        ris_gpu.route = route0
    check(len(routes) >= 1, "the router never ran in its default")
    for wi, r in enumerate(routes):
        check(not r["dev_wins"] or r["host"] == 0,
              f"default wave {wi}: the device chain wins alone, yet the "
              f"host chain took {r['host']} queries")
    frac, matched, de = compare_lines(gpu_lines, body(out_def))
    def_sha = body_sha256(out_def)
    print(f"[default] ris with the router's defaults: {N_Q} queries in "
          f"{t_def:.3f}s = {N_Q / t_def:.4f} q/s; waves "
          f"{json.dumps(routes)}; against the main path {matched}/"
          f"{len(gpu_lines)} lines agree ({frac:.6f}), max energy diff "
          f"{de:.3g} kcal/mol, body sha256 {def_sha} "
          f"({'equal to' if def_sha == main_sha else 'not'} the main "
          f"path's) {tag}", flush=True)
    check(frac >= 0.999, f"default/main agreement {frac} < 0.999")
    check(de <= 1e-3, f"default/main energy diff {de} > 1e-3")
    os.environ["PRIBLAST_DEVICE_EXTEND"] = "1"

    # ---- 4j. two processes on this card
    mp = work / "mp"
    mp.mkdir(exist_ok=True)

    def two_procs(args, **env_extra):
        """`args` in two processes of the port's CLI, each of which prints
        its kernels' launch counts (from 0 at its start) after the run.
        Returns (wall s, [counts of process 0, of process 1])."""
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-c", COUNTING_CLI, *args],
            env=dict(os.environ, PRIBLAST_NUM_PROCS="2",
                     PRIBLAST_PROC_ID=str(i),
                     PRIBLAST_COORD=f"localhost:{port}",
                     PRIBLAST_DIST_TIMEOUT="600", **env_extra),
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for i in range(2)]
        t0 = time.perf_counter()
        counts = []
        try:
            for i, proc in enumerate(procs):
                out, err = proc.communicate(timeout=600)
                check(proc.returncode == 0, f"process {i} of `{args[0]}` "
                      f"exited {proc.returncode}: {err[-2000:]}")
                counts.append(json.loads(out.strip().splitlines()[-1]))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return time.perf_counter() - t0, counts

    t_mdb, c_db = two_procs(["db", "-i", str(work / "db.fa"), "-o",
                       str(mp / "db_gpu"), "-a", "block", "-p", str(mp)])
    t_mris, c_ris = two_procs(["ris", "-i", str(work / "q.fa"), "-o",
                        str(mp / "ris_gpu.txt"), "-d", str(db_gpu), "-a",
                        "area", "-p", str(mp)], PRIBLAST_DEVICE_EXTEND="1")
    diffs = {}
    for ext in ("bas", "seq", "ind", "nam", "acc"):
        a = np.frombuffer(Path(f"{db_gpu}.{ext}").read_bytes(), np.uint8)
        b = np.frombuffer((mp / f"db_gpu.{ext}").read_bytes(), np.uint8)
        diffs[ext] = (int((a != b).sum()) if len(a) == len(b)
                      else f"sizes {len(a)} and {len(b)}")
    main_body = out_gpu.read_text().splitlines()[2:]
    mp_body = (mp / "ris_gpu.txt").read_text().splitlines()[2:]
    n_diff = sum(a != b for a, b in zip(main_body, mp_body)) + abs(
        len(main_body) - len(mp_body))
    print(f"[multiproc] two processes on {card}: db {t_mdb:.3f}s, ris "
          f"{t_mris:.3f}s (walls with process start); bytes that differ from "
          f"the main path's db files {json.dumps(diffs)}; ris body "
          f"{len(mp_body)} lines, {n_diff} differ", flush=True)
    print(f"[multiproc] kernel launches per process: db {json.dumps(c_db)}; "
          f"ris {json.dumps(c_ris)}", flush=True)
    for step, counts, names in (
            ("db", c_db, tuple(access_counters)),
            ("ris", c_ris, (*access_counters, "fused_expand",
                            "fused_threshold", "ungapped_extend",
                            "gapped_extend"))):
        for i, c in enumerate(counts):
            check(all(c[k] > 0 for k in names), f"two-process {step}: "
                  f"process {i} launched no {[k for k in names if not c[k]]}")
            check(c["epilogue_kernel"] == 0, f"two-process {step}: process "
                  f"{i} launched the epilogue kernel {c['epilogue_kernel']} "
                  "times")
    check(all(v == 0 for v in diffs.values()),
          f"two-process db files differ from one process's: {diffs}")
    check(n_diff == 0, f"two-process ris body differs on {n_diff} lines")

    # ---- 4k. several devices in one process
    n_cards = torch.cuda.device_count()
    devs = ([torch.device("cuda", i) for i in range(n_cards)]
            if n_cards >= 2 else [torch.device("cuda", 0)] * 2)
    k = len(devs)
    md = work / "multidev"
    md.mkdir(exist_ok=True)
    # the plan's inputs: each accessibility batch's rows, each wave's
    # pairs, each gapped stage's hits
    sizes = {"rows": [], "pairs": [], "hits": []}

    def rows_rec(self, codes, lengths):
        sizes["rows"].append(codes.shape[0])
        return run0(self, codes, lengths)

    def wb_rec(self, *a, **kw):
        wb_init0(self, *a, **kw)
        sizes["pairs"].append(self.tot)

    def hits_rec(stream, *a, **kw):
        sizes["hits"].append(len(stream))
        return gstage0(stream, *a, **kw)

    batched.BatchedRaccess.run = rows_rec
    fused._WaveBuffers.__init__ = wb_rec
    pipeline.gapped_stage = hits_rec
    gapped_sweep.launches = uop.launches = 0
    zero_access_counts()
    zero_fused_counts()
    record_plain_calls(True)
    try:
        t0 = time.perf_counter()
        db_model.run(DbParams(input=str(work / "db.fa"),
                              db_name=str(md / "db_gpu")), devices=devs)
        t_kdb = time.perf_counter() - t0
        t0 = time.perf_counter()
        ris_model.run(RisParams(input=str(work / "q.fa"),
                                output=str(md / "ris_gpu.txt"),
                                db_name=str(db_gpu)), devices=devs)
        t_kris = time.perf_counter() - t0
    finally:
        batched.BatchedRaccess.run = run0
        fused._WaveBuffers.__init__ = wb_init0
        pipeline.gapped_stage = gstage0
        plain_md = dict(plain_calls)
        record_plain_calls(False)
    got_launches = {**access_counts(), **fused_counts(),
                    "epilogue_kernel": ap.epilogue_launches,
                    "ungapped_extend": uop.launches,
                    "gapped_extend": gapped_sweep.launches}

    def parts(n: int) -> int:
        """Non-empty shards of an n-row batch over the devices."""
        return sum(hi > lo for lo, hi in dist.split_rows(n, k))

    block = min(fused.block_cap(d) for d in dist.distinct(devs))
    gcap = pipeline.gapped_cap(devs)
    n_access = sum(parts(b) for b in sizes["rows"])
    n_blocks = sum(parts(min(block, n - o)) for n in sizes["pairs"]
                   for o in range(0, n, block))
    plan = {**dict.fromkeys(access_counters, n_access),
            "epilogue_kernel": 0,
            **dict.fromkeys(("fused_expand", "fused_threshold",
                             "ungapped_extend"), n_blocks),
            "gapped_extend": sum(2 * parts(min(gcap, n - o))
                                 for n in sizes["hits"]
                                 for o in range(0, n, gcap))}
    diffs = {}
    for ext in ("bas", "seq", "ind", "nam", "acc"):
        a = Path(f"{db_gpu}.{ext}").read_bytes()
        b = (md / f"db_gpu.{ext}").read_bytes()
        diffs[ext] = (int((np.frombuffer(a, np.uint8)
                           != np.frombuffer(b, np.uint8)).sum())
                      if len(a) == len(b) else f"sizes {len(a)}, {len(b)}")
    md_body = (md / "ris_gpu.txt").read_text().splitlines()[2:]
    n_diff = sum(a != b for a, b in zip(main_body, md_body)) + abs(
        len(main_body) - len(md_body))
    print(f"[multidev] {k} shards on {[str(d) for d in devs]}: db "
          f"{t_kdb:.3f}s, ris {t_kris:.3f}s (one device, [main]: db "
          f"{t_db:.3f}s, ris {t_ris:.3f}s); bytes that differ from [main]'s "
          f"db files {json.dumps(diffs)}; ris body {len(md_body)} lines, "
          f"{n_diff} differ {tag}", flush=True)
    print(f"[multidev] kernel launches: planned {json.dumps(plan)}, measured "
          f"{json.dumps(got_launches)} (one launch per non-empty shard of "
          f"{len(sizes['rows'])} accessibility batches of "
          f"{sizes['rows']} rows, of the pair blocks of {block} of "
          f"{sizes['pairs']} pairs, and two per non-empty shard of the hit "
          f"batches of {gcap} of {sizes['hits']} hits); plain versions "
          f"called {json.dumps(plain_md)}", flush=True)
    check(all(v == 0 for v in diffs.values()),
          f"db files on {k} shards differ from one device's: {diffs}")
    check(n_diff == 0, f"ris body on {k} shards differs on {n_diff} lines")
    check(got_launches == plan, f"kernel launches on {k} shards "
          f"{got_launches} differ from the plan {plan}")
    check(not plain_md, f"plain versions ran on {k} shards: {plain_md}")
    for label, ddevs in (("2 shards on cuda:0", [devs[0]] * 2),
                         ("4 shards on cuda:0", [devs[0]] * 4),
                         ("cuda:0 and the CPU", [devs[0],
                                                 torch.device("cpu")])):
        t0 = time.perf_counter()
        try:
            res = dist.dryrun_multichip(ddevs)
        except AssertionError as e:
            fail(f"dryrun_multichip with {label}: {e}")
        print(f"[multidev] dryrun_multichip {label}: "
              f"{'bit for bit' if res['exact'] else 'within tolerance'}, "
              f"{res['hits']} hits, max acc diff {res['acc_diff']:.3g}, max "
              f"energy diff {res['energy_diff']:.3g} kcal/mol (limit "
              f"{0 if res['exact'] else dist.MIXED_TOL}), "
              f"{time.perf_counter() - t0:.3f}s {tag}", flush=True)
    used = (f"yes, {k} cards" if n_cards >= 2 else
            "no: this machine has one card, so the shards shared cuda:0")
    print(f"[multidev] distinct cards used: {used}", flush=True)

    # ---- 5. the gapped kernel vs its plain version, on the card ---------
    def hold(label, a, k):
        """Kernel vs plain version on the same inputs: integers and
        traceback lists identical, floats to 1e-6 (float32) / 1e-12
        (float64); then both timed. Prints the kernel's form and, from the
        plain version's counts, the combos per hit and per diagonal and
        the work list's lane efficiency (combos / (32 x rounds))."""
        dtype = k.get("dtype", "float32")
        ik, fk, tk = kernel(*a, **k)
        work = {}
        ip, fp, tp = gapped_sweep.extend_dir_plain(*a, **k, counts=work)
        torch.cuda.synchronize()
        check(torch.equal(ik, ip), f"ints differ ({label})")
        check(torch.equal(tk, tp), f"traceback lists differ ({label})")
        diff = float((fk - fp).abs().max())
        check(diff <= (1e-6 if dtype == "float32" else 1e-12),
              f"floats differ by {diff} ({label})")
        ms = cuda_ms(lambda: kernel(*a, **k), 20)
        plain = cuda_ms(lambda: gapped_sweep.extend_dir_plain(*a, **k), 1)
        bound, bound_by, lanes = extend_bound_ms(a, k, ik)
        B = a[0].shape[0]
        form = gapped_sweep.kernel_form(k["max_ext"], a[0].device)
        eff = work["combos"] / max(32 * work["rounds"], 1)
        print(f"[kernel] gapped_extend {label} {dtype} max_ext="
              f"{k['max_ext']} flag={k['flag']} B={B} form {form}: "
              f"{ms:.4f} ms, plain {plain:.2f} ms, bound {bound:.6f} ms "
              f"({bound_by}), {ms / bound:.1f}x bound, "
              f"{float(ik[:, 4].float().mean()):.2f} diagonals per hit, "
              f"{lanes:.2f} band lanes per diagonal, combos "
              f"{work['combos'] / B:.2f} per hit, "
              f"{work['combos'] / max(work['diagonals'], 1):.3f} per "
              f"diagonal, admitted cells "
              f"{work['admitted'] / max(work['diagonals'], 1):.3f} per "
              f"diagonal, work-list lane efficiency {eff:.4f} "
              f"({work['rounds']} rounds), max |floats diff| {diff:.3g} "
              f"{tag}", flush=True)
        return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=bound_by,
                    err=diff, form=form, combos_per_hit=work["combos"] / B,
                    lane_efficiency=eff)

    check(len(first_sweep) == 1, "no gapped kernel inputs captured")
    a0, k0 = first_sweep[0]
    main_rec = hold("main-path batch", a0, k0)
    err = main_rec["err"]
    first_sweep.clear()

    check(mid_streams and len(mid_streams[0]["q_sp"]) >= 4096 + 37,
          "too few mid-stage hits for the kernel phase")
    soa = mid_streams[0]
    encs = [alphabet.encode_query(seqs[i], p.repeat_flag) for i in order]
    qp = pipeline.QueryPack(encs, [q_access[i][0] for i in order],
                            [q_access[i][1] for i in order],
                            [native.sa_build(e) for e in encs], devices=dev)
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
    # ---- 6. the ungapped kernel vs its plain version, on the card -------
    def hold_ungapped(label, a):
        """Kernel vs plain version on the same inputs: every column
        identical, integers and float32 energies; then both timed."""
        got = ukernel(*a)
        ref = uop.ungapped_extend_flat(*a)
        steps = ung.extend_steps(*a)
        torch.cuda.synchronize()
        check(got.keys() == ref.keys(), f"ungapped keys differ ({label})")
        for key in uop.INT_KEYS:
            check(torch.equal(got[key], ref[key]),
                  f"ungapped {key} differs ({label})")
        diff = max(float((got[key] - ref[key]).abs().max())
                   for key in uop.FLOAT_KEYS)
        check(diff == 0, f"ungapped floats differ by {diff} ({label})")
        ms = cuda_ms(lambda: ukernel(*a), 20)
        plain = cuda_ms(lambda: uop.ungapped_extend_flat(*a), 1)
        bound, bound_by = ungapped_bound_ms(a, steps)
        st = (steps[0] + steps[1]).float()
        print(f"[kernel] ungapped_extend {label} B={a[0].shape[0]}: "
              f"{ms:.4f} ms, plain {plain:.2f} ms, bound {bound:.6f} ms "
              f"({bound_by}), {ms / bound:.1f}x bound, steps per hit mean "
              f"{float(st.mean()):.2f} max {int(st.max())}, lane efficiency "
              f"{lanes_one_per_hit(st):.4f}, max "
              f"|floats diff| {diff:.3g} {tag}", flush=True)
        return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=bound_by,
                    err=diff, steps=st)

    check(len(first_ungapped) == 1, "no ungapped kernel inputs captured")
    ua = first_ungapped[0]
    urec = hold_ungapped("main-path batch", ua)
    check(ua[0].shape[0] >= 4096 + 37,
          "too few stage-1 hits for the ragged ungapped batch")

    def sub_batch(idx):
        return tuple(x[idx].contiguous() if torch.is_tensor(x) else x
                     for x in ua)

    # a batch smaller than a warp; a mixed one: the main path's 1,024 hits
    # with the most steps, each among three of those with the fewest, so
    # that long and short hits share every warp
    by_steps = torch.argsort(urec["steps"], descending=True, stable=True)
    mixed = torch.cat([by_steps[:1024, None],
                       by_steps.flip(0)[:3072].view(1024, 3)], 1).view(-1)
    uerr = max([urec["err"]] + [
        hold_ungapped(label, sub_batch(idx))["err"] for label, idx in (
            ("ragged", slice(0, 4096 + 37)), ("small", slice(0, 20)),
            ("mixed", mixed))])

    # ---- 7. the accessibility scan kernels vs their plain versions ------
    def max_rel(got, ref):
        """Largest |got - ref| / |ref| over the planes; values below
        float32's smallest normal compare absolutely, as in the tests
        (|got - ref| <= PLANE_RTOL |ref| + tiny)."""
        floor = torch.finfo(torch.float32).tiny / PLANE_RTOL
        return max(float(((a.double() - b.double()).abs()
                          / (b.double().abs() + floor)).max())
                   for a, b in zip(got, ref))

    def energies(t, g, s, lens, n_max, band, ins, outs):
        pw = batched.scan_probabilities(t, g, s, lens, p.min_accessible_length,
                                        n_max, band, torch.float32, ins, outs)
        return batched.accessibility_from_probabilities(
            *pw, lens, p.min_accessible_length, n_max,
            batched._linmodel(p.maximal_span).sp.kT)

    def energy_diff(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    def timed_once(fn):
        s0, s1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s0.record()
        out = fn()
        s1.record()
        torch.cuda.synchronize()
        return out, s0.elapsed_time(s1)

    EN_REPS = 50  # calls over which the sum launch alone is averaged
    EN_ROUNDS = 3  # rounds of those, in turns

    def hold_energies(label, pargs, kT, pw_k, ep_k, ep_p, e_p):
        """window_energies (the main path's call: the probability pass
        whose sum launch writes the window energies) on the inputs of
        window_probs (`pargs`, its p_w and p_w1 `pw_k`): bit for bit with
        the epilogue kernel's output (`ep_k`) and the plain epilogue's
        (`ep_p`) on pw_k, p_w and p_w1 when asked for bit for bit with
        pw_k, within ACCESS_TOL of the plain chain's energies (`e_p`);
        then timed: the call through its wrapper against window_probs +
        accessibility and window_probs alone (checked lengths, in turns),
        and the sum launch alone (torch.profiler, in turns) without the
        energies, with them and p_w, p_w1 (the energies' own work), and
        with them alone (the main path's form)."""
        lens, d, n_max, dt = pargs[3], pargs[4], pargs[5], pargs[7]
        en_k = ap.window_energies(*pargs, kT, checked=True)
        stream = torch.cuda.current_stream().cuda_stream
        fn = ap._fn(dt, "access_prob_energies")

        def held():
            return ap._energies_call(fn, *pargs[1:], kT, stream, probs=True)

        e_a, p_w, p_w1 = held()
        torch.cuda.synchronize()
        bits = (lambda x: x.view(torch.int32))
        check(torch.equal(bits(en_k), bits(ep_p))
              and torch.equal(bits(en_k), bits(ep_k)),
              f"window_energies differs from the epilogue on window_probs' "
              f"p_w and p_w1 by {float((en_k - ep_p).abs().max())} kcal/mol "
              f"({label})")
        check(torch.equal(bits(e_a), bits(en_k))
              and torch.equal(p_w, pw_k[0]) and torch.equal(p_w1, pw_k[1]),
              f"window_energies with p_w and p_w1 asked for differs "
              f"({label})")
        chain = energy_diff(en_k, e_p)
        check(chain <= ACCESS_TOL, f"window_energies differs from the plain "
              f"chain by {chain} kcal/mol ({label})")

        def fused():
            return ap.window_energies(*pargs, kT, checked=True)

        def probs():
            return ap.window_probs(*pargs, checked=True)

        def two():
            return ap.accessibility(*probs(), lens, d, n_max, kT,
                                    checked=True)

        order = (two, fused, probs, probs, fused, two)
        times = [cuda_ms(f, 10) for f in order]
        ms = {f.__name__: (times[i] + times[-1 - i]) / 2
              for i, f in enumerate(order[:3])}

        def sum_ms(f):
            by = device_ms_by_kernel(lambda: [f() for _ in range(EN_REPS)],
                                     ("sum_kernel", "window_kernel"))
            return by["sum_kernel"] / EN_REPS if "sum_kernel" in by else None

        # EN_ROUNDS rounds in turns, each without, with p_w, main, main,
        # with p_w, without: the increment is a few tenths of a
        # microsecond on a ~0.2 ms launch
        order = (probs, held, fused, fused, held, probs) * EN_ROUNDS
        got = {}
        for f in order:
            got.setdefault(f.__name__, []).append(sum_ms(f))
        sums = {k: (None if None in v else sum(v) / len(v))
                for k, v in got.items()}

        def less(k):
            return (None if None in (sums[k], sums["probs"])
                    else sums[k] - sums["probs"])

        return dict(
            fused=ms["fused"], two=ms["two"], probs=ms["probs"],
            ms=less("held"), inc=less("held"), net=less("fused"), sums=sums, chain=chain,
            err=float((en_k - ep_p).abs().max()))

    def hold_access(label, codes, lengths):
        """The accessibility kernels against their plain versions on one
        batch of the main path, float32 as it runs: the grid kernel's two
        launches bit for bit (the seed within SEED_ULPS ulps); each scan
        kernel's planes against its plain version's on the same inputs
        (max relative error), the window energies with the outside kernel
        alone and with the grid and scan kernels against the plain chain
        (kcal/mol); the
        probability kernel's p_w and p_w1 against scan_probabilities on the
        scan kernels' planes (max relative error) and its window energies
        (kcal/mol), alone and with the scan kernels against the plain
        chain; then all timed."""
        dt, w, d = torch.float32, p.maximal_span, p.min_accessible_length
        band, (B, n_max) = w + 2, codes.shape
        s_np = np.zeros((B, n_max + batched.ML + 4), np.int64)
        s_np[:, 1: n_max + 1] = codes
        s = torch.as_tensor(s_np, device=dev)
        lens = torch.as_tensor(lengths.astype(np.int64), device=dev)
        with torch.no_grad():
            t = batched.make_tables(w, dt, dev)
            # the two grid launches against their plain versions on the
            # same inputs: the codes, and for the outside grids the plain
            # inside chain's multi2, A, B and logZ
            gargs = (t, s, lens, n_max, band, dt)
            g = batched.make_grids(*gargs)
            g_k = ag.inside_grids(*gargs)
            args = (t, g, lens, n_max, band, dt)
            ins_p, plain_in = timed_once(lambda: acs.inside_plain(*args))
            oin = (g, ins_p[5], ins_p[6], ins_p[7],
                   ins_p[6].gather(0, lens[None, :])[0])
            og = batched.make_outside_grids(*gargs, *oin)
            og_k = ag.outside_grids(*gargs, *oin)
            torch.cuda.synchronize()
            diff_gi, _, err_gi = grids_diff(g_k, g)
            diff_go, seed_ulps, err_go = grids_diff(og_k, og)
            check(not diff_gi and not diff_go and seed_ulps <= SEED_ULPS,
                  f"grid kernels differ from their plain versions: inside "
                  f"{diff_gi}, outside {diff_go}, seed {seed_ulps} ulps "
                  f"({label})")
            # through the wrappers as the main path calls them (the
            # lengths checked on the host), and with their own range check
            ms_gi = cuda_ms(lambda: ag.inside_grids(*gargs, checked=True), 20)
            ms_go = cuda_ms(lambda: ag.outside_grids(*gargs, *oin,
                                                     checked=True), 20)
            ms_gi_rc = cuda_ms(lambda: ag.inside_grids(*gargs), 20)
            ms_go_rc = cuda_ms(lambda: ag.outside_grids(*gargs, *oin), 20)
            # the launches alone, without the wrapper's checks
            dev_g = {**device_ms_by_kernel(lambda: ag.inside_grids(*gargs),
                                           ("inside_kernel",)),
                     **device_ms_by_kernel(
                         lambda: ag.outside_grids(*gargs, *oin),
                         ("outside_kernel",))}
            # the wrappers' host time by part
            split_g = {"inside": grids_wrapper_split(ag, "inside", gargs),
                       "outside": grids_wrapper_split(ag, "outside", gargs,
                                                      oin)}
            plain_gi = cuda_ms(lambda: batched.make_grids(*gargs), 1)
            plain_go = cuda_ms(
                lambda: batched.make_outside_grids(*gargs, *oin), 1)
            # the scan kernels on the grid kernels' planes (the inside
            # grids' bits are the plain version's), the outside kernel on
            # the plain outside grids, as its plain version
            ins_k = acs.inside_scan(t, g_k, lens, n_max, band, dt)
            oargs = (t, og, ins_p[4], n_max, band, dt)
            outs_k = acs.outside_scan(*oargs)
            outs_p, plain_out = timed_once(lambda: acs.outside_plain(*oargs))
            # the kernel chain: grids and scans from the kernels
            og_c, m1_k = batched.outside_inputs(t, s, lens, n_max, band, dt,
                                                g_k, ins_k)
            chain = acs.outside_scan(t, og_c, m1_k, n_max, band, dt)
            torch.cuda.synchronize()
            for x in (*ins_k, *outs_k, *chain):
                check(bool(torch.isfinite(x).all()),
                      f"non-finite access kernel output ({label})")
            e_p = energies(t, g, s, lens, n_max, band, ins_p, outs_p)
            de_out = energy_diff(energies(t, g, s, lens, n_max, band, ins_p,
                                          outs_k), e_p)
            de_all = energy_diff(energies(t, g, s, lens, n_max, band, ins_k,
                                          chain), e_p)
            rel_in, rel_out = max_rel(ins_k, ins_p), max_rel(outs_k, outs_p)
            check(de_all <= ACCESS_TOL and de_out <= ACCESS_TOL,
                  f"access kernel energies differ by {de_all} / {de_out} "
                  f"kcal/mol ({label})")
            check(rel_in <= PLANE_RTOL and rel_out <= PLANE_RTOL,
                  f"access kernel planes differ by {rel_in} / {rel_out} "
                  f"relative ({label})")
            ms_in = cuda_ms(lambda: acs.inside_scan(*args), 5)
            ms_out = cuda_ms(lambda: acs.outside_scan(*oargs), 5)
            # the probability kernel on the kernel chain's planes, the
            # inputs the main path gives it, against scan_probabilities
            pargs = (t, g_k, s, lens, d, n_max, band, dt, ins_k, chain)
            pw_k = ap.window_probs(*pargs)
            kT = batched._linmodel(w).sp.kT

            def plain_pass():
                # window_energies' plain versions, as it runs on the CPU
                q = batched.scan_probabilities(*pargs)
                return q, torch.stack(batched.accessibility_from_probabilities(
                    *q, lens, d, n_max, kT))

            (pw_p, _), plain_prob = timed_once(plain_pass)
            rel_prob = max_rel(pw_k, pw_p)
            de_prob = energy_diff(
                batched.accessibility_from_probabilities(*pw_k, lens, d,
                                                         n_max, kT),
                batched.accessibility_from_probabilities(*pw_p, lens, d,
                                                         n_max, kT))
            de_three = energy_diff(
                batched.accessibility_from_probabilities(*pw_k, lens, d,
                                                         n_max, kT), e_p)
            check(all(bool(torch.isfinite(x).all()) for x in pw_k),
                  f"non-finite probability kernel output ({label})")
            # the epilogue kernel on the probability kernel's output, as
            # the main path calls it (lengths checked), against its plain
            # version: bit for bit
            ep_args = (*pw_k, lens, d, n_max, kT)
            ep_k = ap.accessibility(*ep_args, checked=True)
            ep_p = torch.stack(
                batched.accessibility_from_probabilities(*ep_args))
            torch.cuda.synchronize()
            check(torch.equal(ep_k.view(torch.int32), ep_p.view(torch.int32)),
                  f"the epilogue kernel differs from its plain version by "
                  f"{float((ep_k - ep_p).abs().max())} kcal/mol ({label})")
            ms_ep = cuda_ms(lambda: ap.accessibility(*ep_args, checked=True),
                            20)
            plain_ep = cuda_ms(
                lambda: batched.accessibility_from_probabilities(*ep_args),
                20)
            dev_ep = device_ms_by_kernel(
                lambda: ap.accessibility(*ep_args, checked=True),
                ("epilogue_kernel",))
            ep_alone = epilogue_alone(
                lambda: ap.accessibility(*ep_args, checked=True))
            # PyTorch's division of a tensor by a host scalar on the card,
            # which the kernel follows: a product with the scalar's float32
            # reciprocal, where an IEEE division would differ
            e_raw = -torch.log(pw_k[0].clamp(min=1.2e-38)) * float(
                np.float32(kT))
            by_scalar = e_raw / 1000
            recip_same = torch.equal(by_scalar, e_raw * torch.tensor(
                1.0 / 1000.0, dtype=torch.float32, device=dev))
            ieee_differ = int((by_scalar != e_raw / torch.full_like(
                e_raw, 1000.0)).sum())
            check(rel_prob <= PLANE_RTOL and de_prob <= ACCESS_TOL
                  and de_three <= ACCESS_TOL,
                  f"probability kernel differs by {rel_prob} relative, "
                  f"{de_prob} kcal/mol (three kernels against the plain "
                  f"chain: {de_three}) ({label})")
            # the pass as the main path calls it: window_energies, the
            # lengths checked on the host
            ms_prob = cuda_ms(
                lambda: ap.window_energies(*pargs, kT, checked=True), 5)
            # over 20 calls: the profiler has seen no device time in one
            by_kernel = {k: v / 20 for k, v in device_ms_by_kernel(
                lambda: [ap.window_energies(*pargs, kT, checked=True)
                         for _ in range(20)],
                ("window_kernel", "sum_kernel")).items()}
            # the window kernel's two instantiations, stem rows staged in
            # shared memory (the wrapper's) or read from device memory,
            # timed in turns: staged, unstaged, unstaged, staged
            stream = torch.cuda.current_stream().cuda_stream

            def window(staged):
                return lambda: ap._prob_call(ap._fn(dt), g_k, s, lens, d,
                                             n_max, band, dt, ins_k, chain,
                                             stream, staged=staged)

            check(all(torch.equal(a, b) for a, b in
                      zip(window(True)(), window(False)())),
                  f"the staged and unstaged window kernels differ ({label})")
            ms_st = [cuda_ms(window(x), 5) for x in (True, False, False,
                                                     True)]
            en = hold_energies(label, pargs, kT, pw_k, ep_k, ep_p, e_p)
        n1 = n_max + 1
        recs = {}
        bound, bound_by = prob_bound_ms(B, n1, band, d, 4)
        print(f"[kernel] access_prob {label} float32 B={B} columns={n1} "
              f"w={d}: window_energies (the main path's call) {ms_prob:.4f} "
              f"ms, plain (scan_probabilities, then "
              f"accessibility_from_probabilities) {plain_prob:.2f} ms, bound "
              f"{bound:.6f} ms ({bound_by}, "
              f"{prob_ops_per_row(n1, band, d, batched.ML) / n1:.0f} "
              f"operations per column), {ms_prob / bound:.1f}x bound, max "
              f"rel diff of p_w, p_w1 {rel_prob:.3g}, max |energy diff| "
              f"{de_prob:.3g} kcal/mol (all three kernels against the plain "
              f"chain: {de_three:.3g}) {tag}", flush=True)
        print(f"[kernel] access_prob {label}: device ms by kernel of one "
              "window_energies call (torch.profiler, mean of 20): " + (", ".join(
                  f"{k} {v:.4f}"
                  for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1]))
                  or "not measured (no device time seen)") + f" {tag}",
              flush=True)
        lanes = prob_lanes(band, d, batched.ML)
        print(f"[kernel] access_prob {label}: window kernel lane efficiency "
              f"{lanes['efficiency']:.4f} (multiply-adds of a column over 8 "
              f"lanes x the busiest lane's {lanes['slots']} slots; terms "
              f"per lane mean {lanes['mean_terms']:.1f}, max "
              f"{lanes['max_terms']}), one lane per loop size "
              f"{lanes['one_per_u']:.4f} {tag}", flush=True)
        print(f"[kernel] access_prob {label}: stem rows staged in shared "
              f"memory {ms_st[0]:.4f} / {ms_st[3]:.4f} ms, read from device "
              f"memory {ms_st[1]:.4f} / {ms_st[2]:.4f} ms (staged, unstaged, "
              f"unstaged, staged) {tag}", flush=True)
        recs["access_prob"] = dict(ms=ms_prob, plain_ms=plain_prob,
                                   bound_ms=bound, bound_by=bound_by,
                                   err=de_prob)
        bound, bound_by = epilogue_bound_ms(B, n_max, 4)
        print(f"[kernel] access_epilogue {label} float32 B={B} columns="
              f"{n_max} w={d}: {ms_ep:.4f} ms through the wrapper as the "
              f"main path calls it, the launch alone "
              + (f"{dev_ep['epilogue_kernel']:.4f} ms by torch.profiler"
                 if "epilogue_kernel" in dev_ep else
                 f"not measured (the profiler saw {json.dumps(dev_ep)})")
              + f"; the launch alone over {EP_REPS} launches: "
              + ", ".join(f"{k} {v}" for k, v in ep_alone.items())
              + f"; plain {plain_ep:.4f} ms, bound {bound:.6f} ms "
              f"({bound_by}), {ms_ep / bound:.1f}x bound; acc and cond bit "
              f"for bit; x / 1000 by PyTorch on the card equals x * "
              f"float32(1/1000) on all {by_scalar.numel()} values: "
              f"{recip_same}, an IEEE division differs on {ieee_differ}; "
              f"library none {tag}", flush=True)
        check(recip_same, "PyTorch's division by a host scalar is not the "
              "product with its float32 reciprocal on this card")
        # the energies' work inside the sum launch: its device increment
        # (the sum launch writing the energies and p_w, p_w1 less the one
        # writing p_w, p_w1 alone), bound by its writes alone
        bound, bound_by = energies_bound_ms(B, n_max)
        if en["ms"] is None:
            en["ms"], how = en["fused"] - en["probs"], (
                "window_energies less window_probs through their wrappers "
                "(the profiler saw no device time)")
        else:
            how = "the sum launch's device increment (torch.profiler)"
        recs["access_epilogue"] = dict(ms=en["ms"], plain_ms=plain_ep,
                                       bound_ms=bound, bound_by=bound_by,
                                       err=en["err"])

        def fmt(v):
            return "not measured" if v is None else f"{v:.5f} ms"

        print(f"[kernel] access_energies {label} float32 B={B} columns="
              f"{n_max} w={d}: window_energies (the pass writing the "
              f"energies) {en['fused']:.4f} ms through its wrapper as the "
              f"main path calls it, against window_probs + accessibility "
              f"through theirs {en['two']:.4f} ms "
              f"({en['two'] - en['fused']:+.4f} ms saved) and window_probs "
              f"alone {en['probs']:.4f} ms (in turns: two, fused, probs, "
              f"probs, fused, two); the sum launch alone (torch.profiler, "
              f"mean of {EN_REPS} calls, in turns: without, with p_w, "
              f"main, main, with p_w, without) without the energies "
              f"{fmt(en['sums']['probs'])}, with the energies and p_w, p_w1 "
              f"{fmt(en['sums']['held'])}, with the energies alone (the "
              f"main path's form) {fmt(en['sums']['fused'])} ({EN_ROUNDS} "
              f"rounds); the "
              f"energies' increment {fmt(en['inc'])} "
              f"with p_w, p_w1 kept, {fmt(en['net'])} net of the p_w, p_w1 "
              f"stores dropped; the record's ms {en['ms']:.5f} ({how}), "
              f"bound {bound:.6f} ms ({bound_by}: acc and cond written, "
              f"the lengths read), {en['ms'] / bound:.1f}x bound; acc and "
              f"cond bit for bit with accessibility_from_probabilities and "
              f"the epilogue kernel on window_probs' p_w and p_w1, and p_w, "
              f"p_w1 when asked; max |diff| against the whole plain chain "
              f"{en['chain']:.3g} kcal/mol {tag}", flush=True)
        for name, ms, ms_rc, plain, err, inside in (
                ("access_grids_inside", ms_gi, ms_gi_rc, plain_gi, err_gi,
                 True),
                ("access_grids_outside", ms_go, ms_go_rc, plain_go, err_go,
                 False)):
            bound, bound_by = grids_bound_ms(B, n1, band, s.shape[1], 4,
                                             inside)
            side = "inside" if inside else "outside"
            launch = dev_g.get(f"{side}_kernel")
            print(f"[kernel] {name} {label} float32 B={B} columns={n1}: "
                  f"{ms:.4f} ms through the wrapper as the main path calls "
                  f"it, {ms / bound:.2f}x bound ({ms_rc:.4f} ms with the "
                  f"wrapper's own range check); the launch alone "
                  + (f"{launch:.4f} ms by torch.profiler, "
                     f"{launch / bound:.2f}x bound" if launch
                     else "not measured") +
                  f"; plain {plain:.2f} ms, bound {bound:.6f} ms "
                  f"({bound_by}); every plane bit for bit"
                  + ("" if inside else
                     f" but the seed, {seed_ulps} ulps at most")
                  + f", max |diff| {err:.3g} {tag}", flush=True)
            print(f"[kernel] {name} {label}: the wrapper's host us per call "
                  "by part: " + ", ".join(
                      f"{k} {v:.1f}" for k, v in split_g[side].items())
                  + f" {tag}", flush=True)
            recs[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                              bound_by=bound_by, err=err)
        for name, ms, plain, rel, de, inside in (
                ("access_inside", ms_in, plain_in, rel_in, de_all, True),
                ("access_outside", ms_out, plain_out, rel_out, de_out,
                 False)):
            bound, bound_by = access_bound_ms(B, n1, band, 4, inside)
            print(f"[kernel] {name} {label} float32 B={B} columns={n1}: "
                  f"{ms:.4f} ms ({1e3 * ms / n1:.4f} us per column step), "
                  f"plain {plain:.2f} ms, bound {bound:.6f} ms ({bound_by}), "
                  f"{ms / bound:.1f}x bound, max rel plane diff {rel:.3g}, "
                  f"max |energy diff| {de:.3g} kcal/mol {tag}", flush=True)
            recs[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                              bound_by=bound_by, err=de)
        return recs

    db_rec = hold_access("main-path db batch", *access_batches[0])
    ris_rec = hold_access("main-path ris batch",
                          *access_batches[n_db_batches])

    # ---- 7b. no host sync in the accessibility wrappers ------------------
    def nosync(label, codes, lengths):
        """batch_energies (the main path's call) and window_probabilities
        with the epilogue kernel on one batch of the main path, called as
        BatchedRaccess calls them (the lengths checked on the host), with
        every synchronising call of PyTorch an error from after the codes'
        and lengths' H2D to before the D2H of the results: the six
        wrappers read nothing back from the card. Their bits against the
        calls that check the lengths themselves, and against each other;
        each accessibility kernel launched as planned. A failure here is
        never caught."""
        dt, w, d = torch.float32, p.maximal_span, p.min_accessible_length
        B, n_max = codes.shape
        s_np = np.zeros((B, n_max + batched.ML + 4), np.int64)
        s_np[:, 1: n_max + 1] = codes
        s = torch.as_tensor(s_np, device=dev)
        lens = torch.as_tensor(lengths.astype(np.int64), device=dev)
        t = batched.make_tables(w, dt, dev)
        kT = float(batched._linmodel(w).sp.kT)
        before = {**access_counts(), "epilogue_kernel": ap.epilogue_launches}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                got = batched.window_probabilities(w, d, n_max, dt, s, lens,
                                                   t, checked=True)
                got = (*got, ap.accessibility(*got, lens, d, n_max, kT,
                                              checked=True),
                       batched.batch_energies(w, d, n_max, dt, s, lens, kT,
                                              t, checked=True))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        after = {**access_counts(), "epilogue_kernel": ap.epilogue_launches}
        ran = {k: n - before[k] for k, n in after.items()}
        with torch.no_grad():
            ref = batched.window_probabilities(w, d, n_max, dt, s, lens, t)
            ref = (*ref, ap.accessibility(*ref, lens, d, n_max, kT),
                   batched.batch_energies(w, d, n_max, dt, s, lens, kT, t))
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        # grids, scans and the pass twice; the energies' sum launch and the
        # epilogue kernel once each
        want = {**dict.fromkeys(access_counters, 2), "access_epilogue": 1,
                "epilogue_kernel": 1}
        check(ran == want, f"[nosync] {label}: accessibility launches {ran}, "
              f"not {want}")
        check(same and torch.equal(got[2], got[3]),
              f"[nosync] {label}: p_w, p_w1 or the energies differ from the "
              "calls that check the lengths themselves, or the two forms' "
              "energies differ")
        print(f"[nosync] {label} B={B} columns={n_max + 1}: batch_energies, "
              "and window_probabilities with the epilogue kernel (checked "
              "lengths) under torch.cuda.set_sync_debug_mode('error'), no "
              f"synchronising call; launches {json.dumps(ran)}; p_w, p_w1 "
              f"and the energies bit for bit with the calls that check the "
              f"lengths themselves, and the two forms' energies bit for bit "
              f"{tag}", flush=True)

    nosync("main-path db batch", *access_batches[0])
    nosync("main-path ris batch", *access_batches[n_db_batches])
    access_batches.clear()

    kernels = [{
        "name": "gapped_extend", "route": "cuda",
        "source": "priblast_tpu_torch/csrc/gapped_extend.cu",
        "replaces": "priblast_tpu/search/gapped_pl.py:51",
        "launches": launches, "max_abs_err": err,
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": None, "form": main_rec["form"],
        "combos_per_hit": main_rec["combos_per_hit"],
        "lane_efficiency": main_rec["lane_efficiency"],
    }, {
        "name": "ungapped_extend", "route": "cuda",
        "source": "priblast_tpu_torch/csrc/ungapped_extend.cu",
        "replaces": "priblast_tpu/search/ungapped.py:94, "
                    "priblast_tpu/search/uwin.py:261",
        "launches": ulaunches, "max_abs_err": uerr,
        "ms": urec["ms"], "plain_ms": urec["plain_ms"],
        "bound_ms": urec["bound_ms"], "bound_by": urec["bound_by"],
        "library_ms": None,
    }]
    for name, source, replaces in (
            ("access_grids_inside", "access_grids",
             "priblast_tpu/accessibility/batched.py:372"),
            ("access_grids_outside", "access_grids",
             "priblast_tpu/accessibility/batched.py:741"),
            ("access_inside", "access_inside",
             "priblast_tpu/accessibility/batched.py:588,1067"),
            ("access_outside", "access_outside",
             "priblast_tpu/accessibility/batched.py:926"),
            ("access_prob", "access_prob",
             "priblast_tpu/accessibility/batched.py:1111,1175"),
            ("access_epilogue", "access_prob",
             "priblast_tpu/accessibility/batched.py:1370")):
        rec = db_rec[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"priblast_tpu_torch/csrc/{source}.cu",
            "replaces": replaces, "launches": alaunches[name],
            "max_abs_err": max(rec["err"], ris_rec[name]["err"]),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None,
        })
    for name, replaces in (
            ("fused_expand", "priblast_tpu/search/fused.py:102"),
            ("fused_threshold", "priblast_tpu/search/fused.py:245")):
        rec = fused_rec[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "priblast_tpu_torch/csrc/fused_expand.cu",
            "replaces": replaces, "launches": flaunches[name],
            "max_abs_err": rec["err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
