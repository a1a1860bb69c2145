"""The port's device ungapped stage on the native stage-1 hits of the tiny
goldens (the `staged` set-up of tests/test_search_kernels.py:19-51, rebuilt
with the port's own native copy), on the CPU.

Against native stage=2: integer fields exact; energies to the float32
step noise the JAX kernel is held to (atol 2e-4, rtol 1e-5). Against the
JAX stage on the same stream: integer fields exact, energies to 1e-6
absolute plus 1e-6 relative, a few float32 ulps (both follow the
reference's float32 step arithmetic, but XLA's CPU backend turns each
x / 100 into x * 0.01 and fuses it with the following add; the port
divides, as the reference does).
"""

import numpy as np
import pytest
import torch

# the port runs many small tensor ops here: one intra-op thread per test
# worker avoids oversubscribing the host under pytest-xdist
torch.set_num_threads(1)

from priblast_tpu.search import pipeline as jpl
from priblast_tpu_torch.models import db as tdb
from priblast_tpu_torch.ops import native
from priblast_tpu_torch.search import pipeline as tpl
from priblast_tpu_torch.utils import alphabet, fasta, store
from priblast_tpu_torch.utils.params import DbParams, RisParams

CPU = torch.device("cpu")
INT_KEYS = ("q_sp", "db_sp", "q_len", "db_len", "dbseq_start", "dbseq_id")


def build_staged(tmp, data_dir):
    """Tiny db built by the port's exact engine; per query its native
    stage-1 (post seed expansion) and stage-2 (post ungapped) hits."""
    db_name = str(tmp / "tiny_db")
    tdb.run(DbParams(input=str(data_dir / "tiny_db.fa"), db_name=db_name,
                     algorithm="block", engine="exact"))
    chunks = store.load_chunks(db_name, 8)
    p = RisParams(input="x", output="y", db_name=db_name, algorithm="block",
                  engine="exact")
    p.load_db_params()
    _names, seqs = fasta.read_fasta(data_dir / "tiny_q.fa")
    queries, pres, posts = [], [], []
    for seq in seqs:
        q_acc, q_cond = native.raccess(alphabet.access_codes(seq),
                                       p.maximal_span,
                                       p.min_accessible_length)
        q_enc = alphabet.encode_query(seq, p.repeat_flag)
        q_sa = native.sa_build(q_enc)
        queries.append((q_enc, q_sa, q_acc, q_cond))
        pres.append(native.search_chunk(q_enc, q_sa, q_acc, q_cond,
                                        chunks[0], p, stage=1))
        posts.append(native.search_chunk(q_enc, q_sa, q_acc, q_cond,
                                         chunks[0], p, stage=2))
    qpack = tpl.QueryPack([q[0] for q in queries], [q[2] for q in queries],
                          [q[3] for q in queries], [q[1] for q in queries],
                          device=CPU)
    dbpack = tpl.DbPack(chunks, device=CPU)
    return chunks, p, queries, qpack, dbpack, pres, posts


def stream_of(parts, qpack, dbpack):
    stream = tpl._concat_groups(parts, [(qid, 0) for qid in range(len(parts))])
    tpl._hit_bases(stream, qpack, dbpack)
    return stream


@pytest.fixture(scope="module")
def staged(tmp_path_factory, data_dir):
    return build_staged(tmp_path_factory.mktemp("torch_ungapped"), data_dir)


def test_ungapped_matches_native_stage2(staged):
    chunks, p, queries, qpack, dbpack, pres, posts = staged
    stream = stream_of(pres, qpack, dbpack)
    assert len(stream) > 0
    tpl.ungapped_stage(stream, qpack, dbpack, p, device=CPU)
    for (_qid, _cid, lo, hi), post in zip(stream.groups, posts):
        for k in INT_KEYS[:5]:
            assert np.array_equal(stream.soa[k][lo:hi], post[k]), k
        for k in ("acc_e", "hyb_e", "energy"):
            np.testing.assert_allclose(stream.soa[k][lo:hi], post[k],
                                       atol=2e-4, rtol=1e-5)


def test_ungapped_matches_jax_stage(staged):
    chunks, p, queries, qpack, dbpack, pres, _posts = staged
    stream = stream_of(pres, qpack, dbpack)
    jq = jpl.QueryPack([q[0].astype(np.int32) for q in queries],
                       [q[2] for q in queries], [q[3] for q in queries])
    jd = jpl.DbPack(chunks)
    jstream = jpl._concat_groups(pres, [(q, 0) for q in range(len(pres))])
    jpl._hit_bases(jstream, jq, jd, chunks)
    for k in ("qb", "qab", "dbb", "aoff", "coff"):
        assert np.array_equal(jstream.soa[k], stream.soa[k]), k
    tpl.ungapped_stage(stream, qpack, dbpack, p, device=CPU)
    jpl.ungapped_stage(jstream, jq, jd, p)
    for k in INT_KEYS[:5]:
        assert np.array_equal(stream.soa[k], jstream.soa[k]), k
    for k in ("acc_e", "hyb_e", "energy"):
        np.testing.assert_allclose(stream.soa[k], jstream.soa[k],
                                   atol=1e-6, rtol=1e-6, err_msg=k)
