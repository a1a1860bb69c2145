"""The port's staged search_all (native stage-1 hits -> device ungapped ->
threshold -> native mid -> device gapped -> native finish) against the
full native chain on the tiny goldens, on the CPU, float64 device math:
hit ids, extents and base pairs exact, energies to 3e-4 (the ungapped
stage keeps the reference's float32 steps), as
tests/test_search_kernels.py:133-221 holds the JAX pipeline."""

import numpy as np
import pytest
import torch

# the port runs many small tensor ops here: one intra-op thread per test
# worker avoids oversubscribing the host under pytest-xdist
torch.set_num_threads(1)

from priblast_tpu_torch.ops import native
from priblast_tpu_torch.search import pipeline as tpl
from test_torch_ungapped import build_staged

CPU = torch.device("cpu")
EXACT_KEYS = ("q_sp", "db_sp", "q_len", "db_len", "dbseq_start", "dbseq_id",
              "bp_q", "bp_db", "bp_off")


@pytest.fixture(scope="module")
def staged(tmp_path_factory, data_dir):
    return build_staged(tmp_path_factory.mktemp("torch_pipeline"), data_dir)


@pytest.mark.parametrize("max_ext", [32, 8])
def test_search_all_matches_native_chain(staged, max_ext):
    """max_ext=8 sends many hits through the exact-host overflow fallback;
    the results must still equal the native chain."""
    chunks, p, queries, qpack, dbpack, _pres, _posts = staged
    stream, finished = tpl.search_all(p, chunks, queries, qpack, dbpack,
                                      device=CPU, dtype="float64",
                                      max_ext=max_ext)
    assert len(finished) == len(stream.groups) == len(queries)
    checked = 0
    for (qid, cid, _lo, _hi), out in zip(stream.groups, finished):
        q_enc, q_sa, q_acc, q_cond = queries[qid]
        full = native.search_chunk(q_enc, q_sa, q_acc, q_cond, chunks[cid],
                                   p)
        for k in EXACT_KEYS:
            assert np.array_equal(out[k], full[k]), k
        np.testing.assert_allclose(out["energy"], full["energy"], atol=3e-4)
        checked += len(full["q_sp"])
    assert checked > 0
    if max_ext == 8:
        assert (stream.soa["q_len"] != stream.soa["pre_q_len"]).any()
