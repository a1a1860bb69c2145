"""The port on a database of several pages, on the CPU: the tiny goldens'
targets built in pages of 3 sequences (3 pages) by the port's exact
engine, then `ris` through the device chain (PRIBLAST_DEVICE_EXTEND=1)
against them. Paging changes no hit (tests/test_exact_parity.py holds
that for the reference), so the output holds the golden hits; a wave
budget that splits every wave into groups of pages changes no byte; and
the load, the pack and their counters are recorded. The JAX package's
device engine on the same pages gives the same hits."""

import numpy as np
import pytest
import torch

# the port runs many small tensor ops here: one intra-op thread per test
# worker avoids oversubscribing the host under pytest-xdist
torch.set_num_threads(1)

from priblast_tpu_torch import cli
from priblast_tpu_torch.models import db as tdb
from priblast_tpu_torch.models import ris_gpu
from priblast_tpu_torch.utils import fasta, store
from priblast_tpu_torch.utils import profiling as prof
from priblast_tpu_torch.utils.params import DbParams, RisParams
from test_torch_e2e import _same_hits

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def paged_db(tmp_path_factory, data_dir):
    db_name = str(tmp_path_factory.mktemp("torch_paged") / "paged")
    tdb.run(DbParams(input=str(data_dir / "tiny_db.fa"), db_name=db_name,
                     engine="exact", chunk_size=3))
    return db_name


@pytest.fixture(scope="module")
def paged_ris(paged_db, data_dir, tmp_path_factory):
    """`ris --device cpu` on the device chain against the 3-page db: its
    output lines, and the spans and counters of the run."""
    out = tmp_path_factory.mktemp("torch_paged_ris") / "gpu.txt"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRIBLAST_DEVICE_EXTEND", "1")
        prof.reset()
        cli.main(["ris", "-i", str(data_dir / "tiny_q.fa"), "-o", str(out),
                  "-d", paged_db, "--device", "cpu"])
    return out.read_text().splitlines(), prof.snapshot(), prof.counters()


def test_ris_on_paged_db_gives_the_golden_hits(paged_ris, paged_db,
                                               data_dir, golden_dir,
                                               tmp_path, monkeypatch):
    from priblast_tpu.models import ris as jris
    from priblast_tpu.utils.params import RisParams as JRisParams

    got, _spans, _counters = paged_ris
    gold = (golden_dir / "tiny" / "predictions.txt").read_text().splitlines()
    _same_hits(gold, got)
    # the JAX package's device engine on the same 3-page database, on its
    # device chain too
    monkeypatch.setenv("PRIBLAST_DEVICE_EXTEND", "1")
    out_jax = tmp_path / "tpu.txt"
    jris.run(JRisParams(input=str(data_dir / "tiny_q.fa"),
                        output=str(out_jax), db_name=paged_db,
                        algorithm="block", engine="tpu"))
    _same_hits(out_jax.read_text().splitlines(), got)


def test_load_and_pack_spans_and_counters(paged_ris, paged_db):
    _got, spans, counters = paged_ris
    chunks = store.load_chunks(paged_db, 8)
    db_nt = sum(int(c.seq_sizes.sum()) for c in chunks)
    assert {"ris.load", "ris.dbpack", "ris.fused"} <= set(spans)
    assert counters["ris.db_pages"] == 3
    assert counters["ris.db_nt"] == db_nt
    assert counters["ris.waves"] == 1
    assert counters["ris.fused.pairs"] > 0
    # int64 sequence, suffix array and four position maps, float32 acc
    # and cond: 56 B a position, and the pads and sentinels
    assert 56 * db_nt < counters["ris.dbpack.bytes"] < 57.5 * db_nt


def test_wave_plan_bounds_query_nt_by_database_nt():
    lengths = [300, 200, 100, 100]
    assert list(ris_gpu._wave_plan(range(4), lengths)) == [[0, 1, 2, 3]]
    # 700 query nt x 10 db nt fits 7,000; 500 per wave at 5,000
    assert list(ris_gpu._wave_plan(range(4), lengths, 10, 7000)) == \
        [[0, 1, 2, 3]]
    assert list(ris_gpu._wave_plan(range(4), lengths, 10, 5000)) == \
        [[0, 1], [2, 3]]
    # a query alone over the budget is a wave of its own
    assert list(ris_gpu._wave_plan(range(4), lengths, 10, 1000)) == \
        [[0], [1], [2], [3]]


def test_page_groups_bound_query_nt_by_group_nt():
    assert ris_gpu._page_groups([5, 5, 5], 10, 150) == [[0, 1, 2]]
    assert ris_gpu._page_groups([5, 5, 5], 10, 100) == [[0, 1], [2]]
    assert ris_gpu._page_groups([5, 5, 5], 10, 10) == [[0], [1], [2]]
    # a page alone over the budget is a group of its own
    assert ris_gpu._page_groups([50, 5, 5], 10, 100) == [[0], [1, 2]]


def test_budget_split_gives_the_unsplit_bytes(paged_db, data_dir,
                                              monkeypatch):
    """A budget under every query x the database: each wave is one query,
    and each wave searches the pages in groups, in turn; the lines are
    the unsplit run's, byte for byte and in order."""
    monkeypatch.setenv("PRIBLAST_DEVICE_EXTEND", "1")
    p = RisParams(input=str(data_dir / "tiny_q.fa"), output="x",
                  db_name=paged_db, device="cpu")
    p.load_db_params()
    names, seqs = fasta.read_fasta(p.input)
    chunks = store.load_chunks(paged_db, p.hash_size)
    order = [int(i) for i in np.argsort([-len(s) for s in seqs],
                                        kind="stable")]
    page_nt = [len(c.seqs) for c in chunks]
    budget = min(len(s) for s in seqs) * sum(page_nt) - 1
    groups = [ris_gpu._page_groups(page_nt, len(seqs[i]), budget)
              for i in order]
    assert all(len(g) > 1 for g in groups)
    out = {}
    for b in (ris_gpu.WAVE_NT2, budget):
        prof.reset()
        results = [None] * len(seqs)
        ris_gpu.run_queries(p, chunks, names, seqs, order, results,
                            devices=CPU, threads=2, budget=b)
        out[b] = results
        waves = prof.counters()["ris.waves"]
    assert waves == sum(len(g) for g in groups)
    assert out[budget] == out[ris_gpu.WAVE_NT2]
    assert sum(map(len, out[budget])) > 0
