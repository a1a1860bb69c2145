"""The port's unbatched float64 oracle
(priblast_tpu_torch/accessibility/linear_ref.py:LinearRaccess) against the
JAX package's (priblast_tpu/accessibility/linear_ref.py), bit for bit, and
against the port's native exact engine within 1e-4 kcal/mol, as
tests/test_tpu_engine.py::test_linear_ref_matches_exact holds the JAX
package's; on the first three tiny_db.fa sequences."""

import numpy as np
import pytest

from priblast_tpu.accessibility.linear_ref import LinearRaccess as JLinear
from priblast_tpu_torch.accessibility.linear_ref import LinearRaccess
from priblast_tpu_torch.ops import native
from priblast_tpu_torch.utils import alphabet, fasta


@pytest.fixture(scope="module")
def seqs(data_dir):
    return fasta.read_fasta(data_dir / "tiny_db.fa")[1][:3]


@pytest.mark.parametrize("i", [0, 1, 2])
def test_linear_raccess_matches_jax_and_exact(seqs, i):
    codes = alphabet.access_codes(seqs[i])
    a, c = LinearRaccess(70, 5).run(codes)
    ja, jc = JLinear(70, 5).run(codes)
    assert a.dtype == np.float32 and a.shape == ja.shape
    assert np.array_equal(a.view(np.uint32), ja.view(np.uint32))
    assert np.array_equal(c.view(np.uint32), jc.view(np.uint32))
    ra, rc = native.raccess(codes, 70, 5)
    assert np.abs(a - ra).max() < 1e-4
    assert np.abs(c - rc).max() < 1e-4
