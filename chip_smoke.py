#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (priblast_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases (any failure ends the run with a non-zero exit code):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: the native host library (g++) and the four CUDA kernel
     sources (nvcc, sm_90a: the gapped extension, the ungapped extension,
     the accessibility inside scan and outside scan), all from this
     checkout, started together;
  3. main path at full size: a seeded workload the size of bench.py's
     (100 queries of ~1,000 nt against 20 db sequences of ~5,000 nt,
     first-order Markov sequences of transcript-like composition) through
     `db --engine gpu` and `ris --engine gpu` on cuda, whose search is the
     fused path (host seed DFS, device expansion, the ungapped kernel,
     threshold, host mid, the gapped kernel, host finish) and whose
     accessibility runs the two scan kernels; the four kernels'
     launch counts, the stage seconds (`ris.fused` split into its
     synchronised sub-stages), the peak device memory, and the mid stage's
     seconds and CPU seconds are read around that run;
  4. the device chain against the port's host chain (native search per
     query on the same device-computed accessibilities), and against
     `--engine exact` (the churn of the float32 device engine); the mid
     stage and the fused stage's candidate packing again on the main
     path's inputs, warm and after the C heap's free pages went back to
     the OS (malloc_trim), which splits their first runs' excess; one
     pair block of the main path's wave again, at its block size, with
     the device memory it takes per pair held to fused.PAIR_BYTES; then
     the staged oracle
     (seed_stage -> ungapped_stage -> threshold_stage) against the fused
     stage on the first 20 queries, same packs and accessibilities:
     identical post-threshold streams;
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
  7. the accessibility scan kernels (the inside pass with both exterior
     scans; the outside pass) against their plain versions on the main
     path's first db batch and its first ris batch (their own shapes):
     each kernel's planes against its plain version's on the same inputs,
     and the window energies of the kernel chain against the plain
     chain's (2e-3 kcal/mol); each with its time, the plain version's and
     the card's least time for the same work.
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
# integer and float operations of one unpaired step of the ungapped kernel
# (csrc/ungapped_extend.cu: position updates, 6 clamped loads with their
# address arithmetic, the break tests, 5 float adds, the pair type, the
# dropout test); a paired step adds its loop energy
UNGAPPED_OPS_PER_STEP = 40


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
    from priblast_tpu_torch.ops import access_scan as acs
    from priblast_tpu_torch.ops import gapped_sweep, native
    from priblast_tpu_torch.ops import ungapped_extend as uop
    from priblast_tpu_torch.search import fused, gapped, pipeline, seed
    from priblast_tpu_torch.search import ungapped as ung
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

    builds = {"native": native.build, "gapped_extend": gapped_sweep.build,
              "ungapped_extend": uop.build, "access_inside": acs.build_inside,
              "access_outside": acs.build_outside}
    with cf.ThreadPoolExecutor(len(builds)) as ex:
        futs = {k: ex.submit(timed, fn) for k, fn in builds.items()}
        built = {k: f.result() for k, f in futs.items()}
    print("[build] " + " | ".join(f"{k} {so.name} {t:.1f}s"
                                  for k, (so, t) in built.items()),
          flush=True)

    # ---- 3. main path at full size -----------------------------------------
    work = REPO / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    db_lens = DB_LEN + rng.integers(-DB_LEN // 25, DB_LEN // 25 + 1, N_DB)
    q_lens = Q_LEN + rng.integers(-Q_LEN // 25, Q_LEN // 25 + 1, N_Q)
    db_nt = write_fasta(work / "db.fa", "t", markov_batch(rng, db_lens))
    write_fasta(work / "q.fa", "q", markov_batch(rng, q_lens))

    # instrumentation: where accessibility ran, the query accessibilities
    # the device chain used, the mid stage's inputs and cost, the
    # mid-stage streams it extended, and the inputs of the first fused
    # stage and gapped and ungapped launches (the main path's own shapes)
    acc_devices, q_access, mid_streams, mid_runs = set(), {}, [], []
    access_batches = []     # (codes, lengths) of every accessibility batch
    first_sweep, first_ungapped, first_fused = [], [], []
    run0 = batched.BatchedRaccess.run
    access0 = ris_gpu._accessibility_batched
    gstage0 = pipeline.gapped_stage
    kernel = gapped_sweep.gapped_extend_dir
    ukernel = uop.ungapped_extend
    fstage0 = fused.fused_stage
    mid0 = pipeline.mid_stage

    def run_rec(self, codes, lengths):
        acc_devices.add(str(self.device))
        access_batches.append((codes.copy(), np.asarray(lengths).copy()))
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

    db_gpu, out_gpu = work / "db_gpu", work / "ris_gpu.txt"
    prof.reset()
    torch.cuda.reset_peak_memory_stats()
    gapped_sweep.launches = uop.launches = 0
    acs.inside_launches = acs.outside_launches = 0
    t0 = time.perf_counter()
    cli.main(["db", "-i", str(work / "db.fa"), "-o", str(db_gpu)])
    t_db = time.perf_counter() - t0
    n_db_batches = len(access_batches)
    t0 = time.perf_counter()
    cli.main(["ris", "-i", str(work / "q.fa"), "-o", str(out_gpu), "-d",
              str(db_gpu)])
    t_ris = time.perf_counter() - t0
    launches, ulaunches = gapped_sweep.launches, uop.launches
    alaunches = {"access_inside": acs.inside_launches,
                 "access_outside": acs.outside_launches}
    stages = prof.snapshot()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batched.BatchedRaccess.run = run0
    ris_gpu._accessibility_batched = access0
    pipeline.gapped_stage = gstage0
    gapped_sweep.gapped_extend_dir = kernel
    uop.ungapped_extend = ukernel
    fused.fused_stage = fstage0
    pipeline.mid_stage = mid0

    check(acc_devices == {"cuda"}, f"accessibility ran on {acc_devices}")
    check("ris.fused.ungapped" in stages,
          f"the main path did not run the fused stage: {sorted(stages)}")
    check(launches > 0, "the gapped kernel was never launched")
    check(ulaunches > 0, "the ungapped kernel was never launched")
    for name, n in alaunches.items():
        check(n == len(access_batches),
              f"{name} launched {n} times for {len(access_batches)} "
              "accessibility batches")
    check(0 < n_db_batches < len(access_batches),
          "db or ris ran no accessibility batch")
    gpu_lines = body(out_gpu)
    check(len(gpu_lines) > 100, f"only {len(gpu_lines)} hits")
    for line in gpu_lines:
        e = [float(x) for x in line.split(",")[5:8]]
        check(all(np.isfinite(e)), f"non-finite energy in {line}")
    tag = f"({card})"
    print(f"[main] db {db_nt} nt in {t_db:.3f}s = {db_nt / t_db:.1f} nt/s; "
          f"ris {N_Q} queries in {t_ris:.3f}s = {N_Q / t_ris:.4f} q/s; "
          f"{len(gpu_lines)} hits; kernel launches: ungapped {ulaunches}, "
          f"gapped {launches}, access_inside "
          f"{alaunches['access_inside']}, access_outside "
          f"{alaunches['access_outside']} ({n_db_batches} db + "
          f"{len(access_batches) - n_db_batches} ris batches); peak device "
          f"memory {peak_gb:.2f} GB {tag}",
          flush=True)
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

    # ---- 4d. one pair block of the main path's wave again, at the main
    # path's block size: its device memory per pair and its sub-stages
    block = min(fused.block_cap(dev), wb.tot)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    prof.reset()
    kept = len(fused.run_block(f_p, 0, block, wb, f_qp, f_dp, dev)["pid"])
    per_pair = (torch.cuda.max_memory_allocated() - base) / block
    print(f"[fused] one pair block of the main path's wave again: {block} of "
          f"its {wb.tot} pairs, {kept} hits kept; peak device memory "
          f"{per_pair:.1f} B per pair (PAIR_BYTES {fused.PAIR_BYTES}); "
          "seconds " + json.dumps({k: round(v, 4) for k, v in
                                   sorted(prof.snapshot().items())})
          + f" {tag}", flush=True)
    check(per_pair <= fused.PAIR_BYTES,
          f"a pair block takes {per_pair:.1f} B per pair, more than "
          f"fused.PAIR_BYTES = {fused.PAIR_BYTES}")
    del wb
    first_fused.clear()

    # ---- 4e. the staged oracle against the fused stage, first queries ---
    queries = []
    for idx in order[:N_STAGED]:
        q_enc = alphabet.encode_query(seqs[idx], p.repeat_flag)
        queries.append((q_enc, native.sa_build(q_enc), *q_access[idx]))
    dp = pipeline.DbPack(chunks, device=dev)
    qp = pipeline.QueryPack(*([q[k] for q in queries] for k in (0, 2, 3, 1)),
                            device=dev)
    threads = os.cpu_count() or 1
    t0 = time.perf_counter()
    s_st = pipeline.seed_stage(p, chunks, queries, threads)
    pipeline._hit_bases(s_st, qp, dp)
    pipeline.ungapped_stage(s_st, qp, dp, p, device=dev)
    s_st = pipeline.threshold_stage(s_st, p)
    t_st = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_fu = fused.fused_stage(p, seed.seed_candidates(p, chunks, queries,
                                                     threads),
                             qp, dp, device=dev)
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
    encs = [alphabet.encode_query(seqs[i], p.repeat_flag) for i in order]
    qp = pipeline.QueryPack(encs, [q_access[i][0] for i in order],
                            [q_access[i][1] for i in order],
                            [native.sa_build(e) for e in encs], device=dev)
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

    def hold_access(label, codes, lengths):
        """Both scan kernels against their plain versions on one batch of
        the main path, float32 as it runs: each kernel's planes against its
        plain version's on the same inputs (max relative error), the window
        energies with the outside kernel alone and with the whole kernel
        chain against the plain chain (kcal/mol); then both timed."""
        dt, w = torch.float32, p.maximal_span
        band, (B, n_max) = w + 2, codes.shape
        s_np = np.zeros((B, n_max + batched.ML + 4), np.int64)
        s_np[:, 1: n_max + 1] = codes
        s = torch.as_tensor(s_np, device=dev)
        lens = torch.as_tensor(lengths.astype(np.int64), device=dev)
        with torch.no_grad():
            t = batched.make_tables(w, dt, dev)
            g = batched.make_grids(t, s, lens, n_max, band, dt)
            args = (t, g, lens, n_max, band, dt)
            ins_k = acs.inside_scan(*args)
            ins_p, plain_in = timed_once(lambda: acs.inside_plain(*args))
            og, m1 = batched.outside_inputs(t, s, lens, n_max, band, dt, g,
                                            ins_p)
            oargs = (t, og, m1, n_max, band, dt)
            outs_k = acs.outside_scan(*oargs)
            outs_p, plain_out = timed_once(lambda: acs.outside_plain(*oargs))
            og_k, m1_k = batched.outside_inputs(t, s, lens, n_max, band, dt,
                                                g, ins_k)
            chain = acs.outside_scan(t, og_k, m1_k, n_max, band, dt)
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
        n1 = n_max + 1
        recs = {}
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
    access_batches.clear()

    kernels = [{
        "name": "gapped_extend", "route": "cuda",
        "source": "priblast_tpu_torch/csrc/gapped_extend.cu",
        "replaces": "priblast_tpu/search/gapped_pl.py:51",
        "launches": launches, "max_abs_err": err,
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": None,
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
    for name, replaces in (
            ("access_inside", "priblast_tpu/accessibility/batched.py:588,1067"),
            ("access_outside", "priblast_tpu/accessibility/batched.py:926")):
        rec = db_rec[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"priblast_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": alaunches[name],
            "max_abs_err": max(rec["err"], ris_rec[name]["err"]),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
