"""Fused seed expansion + ungapped extension + threshold, on the device.

The staged path (pipeline.seed_stage -> ungapped_stage -> threshold_stage)
expands every seed candidate into hits on the host and ships the whole
hit stream to the device and back. This path keeps that stretch on the
device, one pass per block of candidate pairs:

  host   : seed DFS candidates (search/seed.py; reference
           src/seed_search.cpp:153-230), per CANDIDATE (an SA interval
           pair), shipped once per wave (_WaveBuffers)
  device : the expansion (ops/fused_expand.py:expand_start; its plain
           version _expand_core): pair generation (a search over the
           candidate pair-count prefix), suffix-array and position-map
           reads, window accessibility and the interaction filter
           (reference CalcInteractionEnergy, src/seed_search.cpp:47-151),
           compaction, one launch; the ungapped extension kernel
           (ops/ungapped_extend.py) on the survivors; the threshold
           (ops/fused_expand.py:threshold_start; its plain version
           _thresh_core): the interaction-energy threshold (reference:
           src/rna_interaction_search.cpp:389-391) and compaction into
           records, one launch
  host   : reads back only the surviving hits, streamed through a small
           pinned ring into the stream's arrays while the next block's
           expansion runs

Pairs are numbered candidate-major, db position outer, query position
inner (reference: src/seed_search.cpp:274-301); every compaction keeps
that order, so the stream is the staged path's, hit for hit. The window
accessibility is summed in float64 in the native engine's order and the
filter compares in float64 (ops/native/search.cc:174-179, 288), so the
expanded hits equal native stage 1 bit for bit; the survivors enter the
extension as float32 acc_e/hyb_e, as the staged path feeds them.

Pair ids are int64: no wave needs splitting to keep them from wrapping.
The block size only bounds device memory; results do not depend on it.
With several devices each block is cut into contiguous sub-blocks, one
per device (parallel/dist.py), each run on its device's copies of the
packs and candidates; joined in device order, pair ids stay ascending.

Each part is timed as a sub-stage of `ris.fused`: ris.fused.pack,
.expand (the launch, then the wait and the read), .ungapped, .threshold
(the launch and the kept count's read), synchronised on the card's
compute stream, and .records (the records' copies to the host, which
wait on their own events).
"""

from __future__ import annotations

import numpy as np
import torch

from priblast_tpu_torch.ops import fused_expand as fexp
from priblast_tpu_torch.ops import ungapped_extend as uop
from priblast_tpu_torch.parallel import dist
from priblast_tpu_torch.search import pipeline as pl
from priblast_tpu_torch.utils import profiling as prof

# candidate rows (one [_ROWS, NC] int64 device tensor per wave)
_R_QSA = 0    # query SA interval start, based into the packed query SA
_R_DSA = 1    # db SA interval start, based into the packed db SA
_R_LEN = 2    # seed length
_R_QB = 3     # query encoded-buffer base
_R_QAB = 4    # query accessibility base
_R_DBB = 5    # chunk sequence base
_R_NQ = 6     # query-interval width (the inner pair dimension)
_ROWS = 7

# device bytes per pair of a block at its peak, with the previous block's
# records in flight: the expansion's 13 int64 / float64 columns, sized for
# every pair of the block (104 B); while it runs, the previous block's
# records (44 B per survivor of that block) until they are drained to the
# host; then per survivor the float32 acc_e / hyb_e (8 B) and the ungapped
# kernel's output (44 B), and, those two freed, the threshold's records
# (44 B): 104 + 44 + 44 = 192 B if every pair passes (the scratch, 8 B a
# tile, and the allocator's rounding take the rest). chip_smoke.py reads it
# on the main path's wave, two blocks in flight, and fails above this.
PAIR_BYTES = 200


class _WaveBuffers(pl.OnDevices):
    """The candidates of a wave on each distinct device of `devices` (one
    device or a list): rows `cand` [_ROWS, NC] int64, hybrid energies
    `energy` [NC] float64 and the pair-count prefix `cum` [NC + 1] int64;
    `gbounds` holds each (query, chunk) group's pair id range (qid, cid,
    lo, hi) and `tot` the wave's pair count."""

    def __init__(self, cands, qpack, dbpack, devices):
        rows, energy, counts = [], [], []
        self.gbounds = []
        tot = 0
        for (qid, cid), c in cands:
            # stage=4 packing: q interval = (q_sp, db_sp); db interval =
            # (q_len, db_len); seed length = dbseq_id; energy = hyb_e
            q_lo = c["q_sp"].astype(np.int64)
            d_lo = c["q_len"].astype(np.int64)
            nq = c["db_sp"] - q_lo + 1
            ndb = c["db_len"] - d_lo + 1
            n = len(q_lo)
            rows.append(np.stack([
                qpack.sa_base[qid] + q_lo, dbpack.sa_base[cid] + d_lo,
                c["dbseq_id"].astype(np.int64),
                np.full(n, qpack.enc_base[qid]),
                np.full(n, qpack.acc_base[qid]),
                np.full(n, dbpack.seq_base[cid]), nq]))
            energy.append(c["hyb_e"])
            counts.append(nq * ndb)
            npairs = int(counts[-1].sum())
            self.gbounds.append((qid, cid, tot, tot + npairs))
            tot += npairs
        self.tot = tot
        cand = (np.concatenate(rows, axis=1) if rows
                else np.zeros((_ROWS, 0), np.int64))
        cum = np.zeros(cand.shape[1] + 1, np.int64)
        if counts:
            np.cumsum(np.concatenate(counts), out=cum[1:])
        energy = (np.concatenate(energy).astype(np.float64) if energy
                  else np.zeros(0))
        self._place({"cand": cand, "energy": energy, "cum": cum}, devices)


def _at(buf, pos):
    return buf[pos.clamp(0, buf.shape[0] - 1)]


def _window(acc, cond, abase, cbase, length, d: int, max_len: int):
    """acc[abase] + sum of cond[cbase + t] for d <= t < length, in float64,
    one add at a time in the order of the native engine
    (ops/native/search.cc:174-179); seed lengths are at most max_len."""
    w = _at(acc, abase).double()
    for t in range(d, max_len):
        w = torch.where(t < length, w + _at(cond, cbase + t).double(), w)
    return w


def _expand_core(d: int, max_len: int, o: int, B: int, wb: _WaveBuffers,
                 qpack, dbpack) -> dict:
    """Pairs o .. o + B - 1 of the wave -> the hits that pass the
    interaction filter (acc_e + hyb_e < 0), in pair order: per-hit int64
    columns (q_sp, db_sp, length, dbseq_id, dbseq_start and the flat-buffer
    bases qb, qab, dbb, aoff, coff), acc_e and hyb_e in float64, and the
    pair id `pid`."""
    pid = torch.arange(o, o + B, device=wb.cum.device)
    ci = torch.searchsorted(wb.cum, pid, right=True) - 1
    row = wb.cand[:, ci]
    off = pid - wb.cum[ci]
    nq = row[_R_NQ]
    ki = torch.div(off, nq, rounding_mode="floor")
    qi = off - ki * nq
    q_sp = qpack.sa[row[_R_QSA] + qi]
    db_sp = dbpack.sa[row[_R_DSA] + ki]
    length, qab, dbb = row[_R_LEN], row[_R_QAB], row[_R_DBB]
    pos = dbb + db_sp
    local_start = dbpack.pos_ls[pos] - db_sp - length
    aoff, coff = dbpack.pos_aoff[pos], dbpack.pos_coff[pos]
    _q_enc, q_acc, q_cond = qpack.bufs
    _db_seq, db_acc, db_cond = dbpack.bufs
    acc_e = (_window(q_acc, q_cond, qab + q_sp, qab + q_sp, length, d,
                     max_len)
             + _window(db_acc, db_cond, aoff + local_start,
                       coff + local_start, length, d, max_len))
    hyb_e = wb.energy[ci]
    keep = torch.nonzero(acc_e + hyb_e < 0).squeeze(1)
    cols = dict(pid=pid, q_sp=q_sp, db_sp=db_sp, length=length,
                dbseq_id=dbpack.pos_sid[pos], dbseq_start=local_start,
                qb=row[_R_QB], qab=qab, dbb=dbb, aoff=aoff, coff=coff,
                acc_e=acc_e, hyb_e=hyb_e)
    return {k: v[keep] for k, v in cols.items()}


def _thresh_core(p, res: dict, hits: dict) -> dict:
    """The extended hits at or below the interaction-energy threshold
    (float32 energies compared in float64), in pair order, on the host:
    stream dtypes (int32 fields, float32 energies) plus the pair id."""
    keep = torch.nonzero(res["energy"].double()
                         <= p.interaction_energy_threshold).squeeze(1)
    out = {k: res[k][keep].cpu().numpy().astype(np.int32)
           for k in uop.INT_KEYS}
    out.update({k: res[k][keep].cpu().numpy() for k in uop.FLOAT_KEYS})
    out["dbseq_id"] = hits["dbseq_id"][keep].cpu().numpy().astype(np.int32)
    out["pid"] = hits["pid"][keep].cpu().numpy()
    return out


def block_cap(device) -> int:
    """Pairs per block: the largest power of two whose working set
    (PAIR_BYTES each) stays within 2% of the card's memory, 2^21..2^23;
    2^21 on the CPU."""
    return pl._batch_cap(device, PAIR_BYTES, 0.02, 1 << 21, 1 << 23)


def launch_block(p, o: int, B: int, wb: _WaveBuffers, qpack, dbpack,
                 device) -> fexp.PendingHits:
    """The launch half of a block: pairs o .. o + B - 1 of the wave into
    the expansion kernel on `device` (its plain version on the CPU), from
    its copies of the packs and candidates; nothing is read back."""
    with prof.stage("ris.fused.expand"):
        return fexp.expand_start(p.min_accessible_length, p.max_seed_length,
                                 o, B, wb.at(device), qpack.at(device),
                                 dbpack.at(device))


def finish_block(p, launched: fexp.PendingHits, qpack, dbpack,
                 device) -> fexp.PendingRecords:
    """The finish half of a block: the expansion's survivors (one read),
    the ungapped kernel and the threshold on `device`; the kept records
    stay on the card until drained."""
    d = p.min_accessible_length
    qpack, dbpack = qpack.at(device), dbpack.at(device)
    with prof.stage("ris.fused.expand", device):
        hits = launched.result()
    with prof.stage("ris.fused.ungapped", device):
        res = uop.ungapped_extend(
            hits["q_sp"], hits["db_sp"], hits["length"], hits["dbseq_start"],
            hits["acc_e"].float(), hits["hyb_e"].float(), hits["qb"],
            hits["qab"], hits["dbb"], hits["aoff"], hits["coff"],
            qpack.bufs, dbpack.bufs, d, p.drop_out_length_wo_gap)
    with prof.stage("ris.fused.threshold", device):
        return fexp.threshold_start(p, res, hits)


def _drain(parts, sink: fexp.HostRecords, at: int) -> int:
    """A block's records, (device, PendingRecords) in shard order, into the
    sink from row `at`, each shard on its own thread; the next row."""
    rows = np.cumsum([at] + [part.n2 for _dev, part in parts])
    with prof.stage("ris.fused.records"):
        dist.run_sharded(lambda _dev, part, lo: part.drain(sink, lo),
                         [(dev, part, int(lo))
                          for (dev, part), lo in zip(parts, rows)])
    return int(rows[-1])


def fused_stage(p, cands, qpack, dbpack, *, devices,
                block: int | None = None) -> pl.HitStream:
    """Post-threshold HitStream of a wave's seed candidates (`cands` from
    search/seed.py:seed_candidates): the stream pipeline.seed_stage ->
    ungapped_stage -> threshold_stage gives, one device pass per block of
    `block` pairs (default: the least block_cap of `devices`); see
    run_blocks."""
    devices = dist.device_list(devices)
    with prof.stage("ris.fused.pack", devices):
        wb = _WaveBuffers(cands, qpack, dbpack, devices)
    return run_blocks(p, wb, qpack, dbpack, devices, block)


def run_blocks(p, wb: _WaveBuffers, qpack, dbpack, devices,
               block: int | None = None) -> pl.HitStream:
    """The packed wave's blocks of `block` pairs through the kernels, into
    one host stream. Each block is split over `devices` (one device or a
    list; dist.split_rows) into contiguous sub-blocks, each run on its
    device and thread; the parts join in block and shard order, so pair ids
    stay ascending. A block's expansion is launched before the previous
    block's records are drained to the host (their copies then overlap the
    expansion), and that block's records stay on its card until the next
    block's expansion has been launched."""
    devices = dist.device_list(devices)
    if block is None:
        block = min(block_cap(dev) for dev in dist.distinct(devices))
    sink = fexp.HostRecords(wb.tot)  # pages taken only where records land
    n, parts = 0, []
    for o in range(0, wb.tot, block):
        rows = dist.split_rows(min(block, wb.tot - o), len(devices))
        shards = [(dev, o + lo, hi - lo)
                  for dev, (lo, hi) in zip(devices, rows) if hi > lo]
        launched = dist.run_sharded(
            lambda dev, lo, m: launch_block(p, lo, m, wb, qpack, dbpack,
                                            dev), shards)
        n = _drain(parts, sink, n)
        parts = list(zip([dev for dev, _lo, _m in shards], dist.run_sharded(
            lambda dev, pending: finish_block(p, pending, qpack, dbpack, dev),
            [(dev, pending) for (dev, _lo, _m), pending in zip(shards,
                                                               launched)])))
    n = _drain(parts, sink, n)
    flat = sink.columns(n)
    pids = flat.pop("pid")
    groups = [(qid, cid, int(np.searchsorted(pids, lo)),
               int(np.searchsorted(pids, hi)))
              for qid, cid, lo, hi in wb.gbounds]
    return pl.HitStream({k: flat[k] for k in pl.STREAM_KEYS}, groups)
