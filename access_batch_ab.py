#!/usr/bin/env python3
"""Does a sequence's accessibility on the card depend on its batch?

    python3 access_batch_ab.py [--seed 0] [--device cuda] [--n-db N --db-len L]

Builds chip_smoke.py's db workload (the same seed, so the same sequences),
computes the db accessibilities in the batches one process plans
(`db_gpu.plan_batches` over every sequence) and in the batches each of two
processes plans (`-a block` shards, as `db` in two processes runs them),
and prints, for each sequence whose acc or cond differ, its batch shape
(batch size, padded length) in each plan and the count and size of the
differences. For the first such sequence it then computes both batches
stage by stage (the weight grids, the inside kernel's eight outputs, the
outside grids and the outside kernel's five planes, the eight terms of
`probability_pass`, p_w and p_w1, acc and cond) and prints, per stage,
how many of the sequence's own values differ between its two batches
(its columns 0..length, every band cell; `--seq` names another
sequence). Ends with one JSON line.

    python3 access_batch_ab.py --dryrun K [--device cuda]

instead takes the random batch of parallel/dist.py:dryrun_multichip at K
shards (2 K rows of 96 nt, window 48, d 5, seed 1), computes it whole and
in its K shards of 2 rows, lists each row whose acc or cond differ, and
splits the first such row stage by stage in the same way; then it holds
each torch reduction and product that probability_pass runs over the band
(a sum over the band axis, a band x band product) on the whole batch's
inputs against the same op on one shard's rows.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--n-db", type=int, default=None)
    ap.add_argument("--db-len", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None,
                    help="the sequence to split by stage (default: the "
                         "first that differs)")
    ap.add_argument("--dryrun", type=int, default=0, metavar="K",
                    help="split dryrun_multichip's batch at K shards "
                         "instead")
    args = ap.parse_args()

    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from priblast_tpu_torch.accessibility import batched as ab
    from priblast_tpu_torch.models import db_gpu
    from priblast_tpu_torch.ops import access_scan as acs
    from priblast_tpu_torch.parallel import multihost
    from priblast_tpu_torch.utils import alphabet

    if args.device == "cuda":
        if not torch.cuda.is_available():
            cs.fail("no CUDA device")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    else:
        card = "cpu"
    dev = torch.device(args.device)
    if args.dryrun:
        return dryrun_split(args.dryrun, dev, card)
    n_db = args.n_db or cs.N_DB
    db_len = args.db_len or cs.DB_LEN
    # chip_smoke.py's generator, in its order of draws: the db sequences
    # come first from the seeded stream
    rng = np.random.default_rng(args.seed)
    db_lens = db_len + rng.integers(-db_len // 25, db_len // 25 + 1, n_db)
    rng.integers(-cs.Q_LEN // 25, cs.Q_LEN // 25 + 1, cs.N_Q)
    seqs = cs.markov_batch(rng, db_lens)
    w, d = 70, 5
    lengths = [len(s) for s in seqs]

    def batches_of(idxs):
        """{global index: (codes, lens, row)} of the batches one process
        plans over sequences `idxs` (in its own order)."""
        out = {}
        for group, bsz, padded in db_gpu.plan_batches(
                [lengths[i] for i in idxs],
                db_gpu.batch_limits([dev], w + 2, torch.float32)):
            codes = np.zeros((bsz, padded), np.uint8)
            lens = np.zeros(bsz, np.int32)
            for bi, k in enumerate(group):
                codes[bi, : lengths[idxs[k]]] = alphabet.access_codes(
                    seqs[idxs[k]])
                lens[bi] = lengths[idxs[k]]
            for bi, k in enumerate(group):
                out[idxs[k]] = (codes, lens, bi)
        return out

    plans = {"one": batches_of(list(range(n_db)))}
    plans["two"] = {}
    for shard in multihost.partition_for("block", lengths, 2):
        plans["two"].update(batches_of(shard))

    engine = ab.BatchedRaccess(w, d, devices=dev)
    results = {}
    for name, plan in plans.items():
        done = {}
        for idx, (codes, lens, bi) in plan.items():
            key = id(codes)
            if key not in done:
                done[key] = engine.run(codes, lens)
            acc, cond = done[key]
            results[(name, idx)] = (acc[bi, : lengths[idx] - d + 1],
                                    cond[bi, : lengths[idx]])

    differ = []
    for idx in range(n_db):
        (a1, c1), (a2, c2) = results[("one", idx)], results[("two", idx)]
        n = int((a1 != a2).sum() + (c1 != c2).sum())
        shapes = [plans[p][idx][0].shape for p in ("one", "two")]
        line = (f"[seq] {idx} length {lengths[idx]}: batch (B, n_max) one "
                f"process {shapes[0]}, two processes {shapes[1]}; "
                f"{n} of {a1.size + c1.size} values differ")
        if n:
            de = max(float(np.abs(a1 - a2).max()), float(np.abs(c1 - c2)
                                                         .max()))
            line += f", max |diff| {de:.3g} kcal/mol"
            differ.append(idx)
        print(line + f" ({card})", flush=True)

    stages = {}
    idx = args.seq if args.seq is not None else (differ or [None])[0]
    if idx is not None:
        band, dt = w + 2, torch.float32
        L = lengths[idx]
        got = {name: stage_values(*plans[name][idx], L, w, d, dev)
               for name in ("one", "two")}
        stages = compare_stages(got["one"], got["two"], f"seq {idx}", card)
    print(json.dumps({"card": card, "differ": differ, "stages": stages}))
    return 0


def stage_values(codes, lens, bi: int, L: int, w: int, d: int, dev) -> dict:
    """Row bi (of length L) of every stage of the float32 accessibility
    of the batch (codes, lens) on `dev`, as float64 CPU tensors."""
    import numpy as np
    import torch

    from priblast_tpu_torch.accessibility import batched as ab
    from priblast_tpu_torch.ops import access_scan as acs

    band, dt = w + 2, torch.float32
    B, n_max = codes.shape
    s_np = np.zeros((B, n_max + ab.ML + 4), np.int64)
    s_np[:, 1: n_max + 1] = codes
    s = torch.as_tensor(s_np, device=dev)
    ln = torch.as_tensor(lens.astype(np.int64), device=dev)
    out = {}
    with torch.no_grad():
        t = ab.make_tables(w, dt, dev)
        g = ab.make_grids(t, s, ln, n_max, band, dt)
        ins = acs.inside_scan(t, g, ln, n_max, band, dt)
        og, m1 = ab.outside_inputs(t, s, ln, n_max, band, dt, g, ins)
        outs = acs.outside_scan(t, og, m1, n_max, band, dt)
        logZ = ins[6].gather(0, ln[None, :])[0]
        pg = ab.make_prob_grids(t, s, n_max, band, dt)
        terms = ab.probability_pass(t, g, pg, ins[:7], outs, ins[6],
                                    ins[7], logZ, d, n_max, band, dt)
        p_w, p_w1 = ab.scan_probabilities(t, g, s, ln, d, n_max,
                                          band, dt, ins, outs)
        acc, cond = ab.accessibility_from_probabilities(
            p_w, p_w1, ln, d, n_max, float(ab._linmodel(w).sp.kT))
    for k, x in g._asdict().items():
        out[f"grid.{k}"] = x[: L + 1, bi]
    for k, x in zip(("stem", "stem_m", "stem_a", "multi", "multi1",
                     "multi2", "A", "B"), ins):
        out[f"inside.{k}"] = x[: L + 1, bi]
    for k, x in og._asdict().items():
        out[f"ogrid.{k}"] = x[: L + 1, bi]
    for k, x in zip(("bse", "bse_m", "bse_a", "b_multi", "b_multi2"),
                    outs):
        out[f"outside.{k}"] = x[: L + 1, bi]
    for k, x in pg._asdict().items():
        out[f"pgrid.{k}"] = x[: L + 1, bi]
    for k, x in zip(("ext_w", "ext_w1", "hp_b", "hp_c", "bi_b",
                     "bi_c", "mp_w", "mp_w1"), terms):
        out[f"prob.{k}"] = x[: L + 2, bi]
    out["p_w"], out["p_w1"] = p_w[: L + 2, bi], p_w1[: L + 2, bi]
    out["acc"] = acc[bi, : L - d + 1]
    out["cond"] = cond[bi, :L]
    return {k: v.double().cpu() for k, v in out.items()}


def compare_stages(one: dict, two: dict, label: str, card: str) -> dict:
    """Print and return, per stage, how many values differ."""
    stages = {}
    for k in one:
        a, b = one[k], two[k]
        n = int((a != b).sum())
        de = float((a - b).abs().max()) if n else 0.0
        rel = float(((a - b).abs() / (a.abs() + 1e-300)).max()) if n \
            else 0.0
        stages[k] = dict(differ=n, of=a.numel(), max_abs=de, max_rel=rel)
        print(f"[stage] {label}: {k} {n} of {a.numel()} differ, max "
              f"|diff| {de:.3g}, max rel {rel:.3g} ({card})", flush=True)
    return stages


def dryrun_split(k: int, dev, card: str) -> int:
    """dryrun_multichip's batch at k shards: whole against its shards."""
    import numpy as np
    import torch

    from priblast_tpu_torch.accessibility import batched as ab
    from priblast_tpu_torch.parallel import dist

    w, d, n_max, B = 48, 5, 96, 2 * k
    rng = np.random.default_rng(1)
    codes = rng.integers(1, 5, (B, n_max)).astype(np.uint8)
    lens = np.full(B, n_max, dtype=np.int32)
    whole = ab.BatchedRaccess(w, d, devices=dev).run(codes, lens)
    rows = dist.split_rows(B, k)
    differ = []
    for lo, hi in rows:
        part = ab.BatchedRaccess(w, d, devices=dev).run(codes[lo:hi],
                                                        lens[lo:hi])
        for r in range(lo, hi):
            n = sum(int((x[r] != y[r - lo]).sum())
                    for x, y in zip(whole, part))
            print(f"[row] {r} (shard rows {lo}..{hi - 1}): {n} of "
                  f"{2 * n_max} values differ ({card})", flush=True)
            if n:
                differ.append((r, lo, hi))
    stages = {}
    if differ:
        r, lo, hi = differ[0]
        stages = compare_stages(
            stage_values(codes, lens, r, n_max, w, d, dev),
            stage_values(codes[lo:hi], lens[lo:hi], r - lo, n_max, w, d,
                         dev), f"row {r}", card)
    # the band reductions and products of probability_pass, alone
    band = w + 2
    g = torch.Generator(device="cpu").manual_seed(2)
    x = torch.rand((n_max + 2, B, band), generator=g).to(dev)
    mat = torch.rand((band, band), generator=g).to(dev)
    ops = {}
    for name, fn in (("sum over the band", lambda v: v.sum(2)),
                     ("band x band product", lambda v: v @ mat),
                     ("sum over the columns", lambda v: v.sum(0))):
        full = fn(x)
        sub = fn(x[:, :2].contiguous())
        # the batch axis is 1, or 0 once the columns are summed away
        first = full[:2] if name == "sum over the columns" else full[:, :2]
        n = int((first != sub).sum())
        ops[name] = n
        print(f"[op] {name}: {n} values of the first 2 rows differ between "
              f"{B} rows and 2 ({card})", flush=True)
    print(json.dumps({"card": card, "dryrun": k, "differ": differ,
                      "stages": stages, "ops": ops}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
