"""The tables carried across: the port's accessibility Tables and gapped
plane tables, built from the JAX package's own arrays with
tables_from_numpy, equal the port's own constructions array by array."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the port runs many small tensor ops here: one intra-op thread per test
# worker avoids oversubscribing the host under pytest-xdist
torch.set_num_threads(1)

from priblast_tpu.accessibility import batched as jb
from priblast_tpu.search import gapped as jg
from priblast_tpu_torch.accessibility import batched as tb
from priblast_tpu_torch.search import gapped as tg


def test_accessibility_tables_from_jax_arrays():
    jt = jb.make_tables(70, dtype=jnp.float64)
    fields = {k: np.asarray(v) if not isinstance(v, float) else v
              for k, v in jt._asdict().items()}
    carried = tb.tables_from_numpy(fields, dtype=torch.float64)
    own = tb.make_tables(70, dtype=torch.float64)
    assert carried._fields == own._fields
    for name in own._fields:
        a, b = getattr(carried, name), getattr(own, name)
        if isinstance(b, float):
            assert a == b, name
        else:
            assert a.dtype == b.dtype, name
            assert torch.equal(a, b), name


@pytest.mark.parametrize("flag", [0, 1])
def test_gapped_plane_tables_from_jax_arrays(flag):
    jt = jg._plane_tables(flag)
    own_np = tg._plane_tables(flag)
    assert sorted(jt) == sorted(own_np)
    carried = tg.tables_from_numpy({k: np.asarray(v) for k, v in jt.items()},
                                   dtype=torch.float64)
    own = tg.tables_from_numpy(own_np, dtype=torch.float64)
    for name in own:
        assert torch.equal(carried[name], own[name]), name
