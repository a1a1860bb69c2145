"""The check catches a broken timed path: a whole tiny run on the CPU
(the look for a card skipped) with one fault planted in the program,
and `correct` comes out false. Faults: a step that returns its state
unchanged, half of a batch left out, an answer altered where it is
produced. (One chip: no exchange between chips to leave out.)"""

import numpy as np
import pytest

import tiny


@pytest.fixture(autouse=True)
def _device_chain(monkeypatch):
    monkeypatch.setenv("PRIBLAST_DEVICE_EXTEND", "1")


def _gapped_unchanged(mp):
    from priblast_tpu_torch.search import gapped

    orig = gapped.gapped_extend_flat_batch

    def fault(hits, *a, **k):
        out, bps, ovf = orig(hits, *a, **k)
        z = np.zeros(len(hits["q_sp"]), np.int64)
        e = np.zeros(0, np.int32)
        return dict(hits), dict(n0=z, q0=e, db0=e, n1=z, q1=e, db1=e), \
            np.zeros_like(ovf)

    mp.setattr(gapped, "gapped_extend_flat_batch", fault)


def _half_the_queries(mp):
    from priblast_tpu_torch.models import ris_gpu

    orig = ris_gpu.run_queries

    def fault(p, chunks, names, seqs, order, results, **k):
        return orig(p, chunks, names, seqs, order[: len(order) // 2],
                    results, **k)

    mp.setattr(ris_gpu, "run_queries", fault)


def _energies_altered(mp):
    from priblast_tpu_torch.models import ris

    orig = ris.format_hits

    def fault(p, res, *a):
        res = dict(res)
        res["hyb_e"] = np.asarray(res["hyb_e"]) - 0.25
        res["energy"] = np.asarray(res["energy"]) - 0.25
        return orig(p, res, *a)

    mp.setattr(ris, "format_hits", fault)


def _access_unchanged(mp):
    from priblast_tpu_torch.models import db_gpu

    def fault(seqs, w, d, *, devices):
        return ([np.zeros(max(len(s) - d + 1, 0), np.float32) for s in seqs],
                [np.zeros(len(s), np.float32) for s in seqs])

    mp.setattr(db_gpu, "compute_accessibilities", fault)


def _half_the_rows(mp):
    from priblast_tpu_torch.accessibility.batched import BatchedRaccess

    orig = BatchedRaccess.run

    def fault(self, codes, lengths):
        acc, cond = orig(self, codes, lengths)
        half = (len(acc) + 1) // 2
        acc[half:] = 0.0
        cond[half:] = 0.0
        return acc, cond

    mp.setattr(BatchedRaccess, "run", fault)


def _suffix_array_altered(mp):
    from priblast_tpu_torch.utils import store

    orig = store.append_ind_chunk

    def fault(db_name, sa, hs, he, first):
        sa = np.array(sa)
        sa[[1, 2]] = sa[[2, 1]]
        return orig(db_name, sa, hs, he, first)

    mp.setattr(store, "append_ind_chunk", fault)


@pytest.mark.parametrize("cell,fault", [
    ("ris.tiny", _gapped_unchanged),
    ("ris.tiny", _half_the_queries),
    ("ris.tiny", _energies_altered),
    ("db.tiny", _access_unchanged),
    ("db.tiny", _half_the_rows),
    ("db.tiny", _suffix_array_altered),
], ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_caught(cell, fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    out = tiny.run(cell, tmp=str(tmp_path))
    assert out["correct"] is False, out["compared"]
