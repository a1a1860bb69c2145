"""The port's fastmath replicas (priblast_tpu_torch/ops/fastmath.py: numpy
and PyTorch) against the JAX package's numpy replicas
(priblast_tpu/ops/fastmath.py), bit for bit, on seeded inputs and on the
edges of tests/test_fastmath.py: expd below and above its range (0 and
inf), the log of a denormal, the -INF sentinel of the log-add. The port
reads its own copy of the tables."""

import numpy as np
import pytest
import torch

from priblast_tpu.ops import fastmath as jfm
from priblast_tpu_torch.ops import fastmath as tfm


def _inputs():
    rng = np.random.default_rng(1)
    xs = np.concatenate([
        rng.uniform(-750, 750, 20000),
        rng.uniform(-2, 2, 20000),
        np.array([0.0, -0.0, 1.0, -800.0, 800.0, -708.39641853226408,
                  709.78271289338397, -700.0, 700.0]),
    ])
    pos = np.concatenate([
        np.abs(xs).astype(np.float32) + np.float32(1e-30),
        np.array([1e-45, 1e-40, 1.17549435e-38, 1.0, 2.0, 0.5, 1e10],
                 np.float32),    # denormals, the smallest normal, ...
    ])
    ys = rng.uniform(-50, 50, xs.size)
    ys[:3] = -1000000.0          # the reference's -INF sentinel
    return xs, pos, ys


def test_tables_are_the_port_s_own_copy():
    assert "priblast_tpu_torch" in str(tfm._DATA)
    for a, b in zip(tfm._tables(), jfm._tables()):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("impl", ["numpy", "torch"])
def test_expd_bit_for_bit(impl):
    xs, _pos, _ys = _inputs()
    want = jfm.expd(xs)
    got = (tfm.expd(xs) if impl == "numpy"
           else tfm.expd_torch(torch.as_tensor(xs)).numpy())
    assert got.dtype == np.float64
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))
    assert got[xs == -800.0] == 0.0 and np.isinf(got[xs == 800.0])


@pytest.mark.parametrize("impl", ["numpy", "torch"])
def test_logf_bit_for_bit(impl):
    _xs, pos, _ys = _inputs()
    want = jfm.logf(pos)
    got = (tfm.logf(pos) if impl == "numpy"
           else tfm.logf_torch(torch.as_tensor(pos)).numpy())
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("impl", ["numpy", "torch"])
def test_logsumexp2_bit_for_bit(impl):
    xs, _pos, ys = _inputs()
    want = jfm.logsumexp2(xs, ys)
    got = (tfm.logsumexp2(xs, ys) if impl == "numpy"
           else tfm.logsumexp2_torch(torch.as_tensor(xs),
                                     torch.as_tensor(ys)).numpy())
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))
    assert tfm.logsumexp2(np.array([-1000000.0]), np.array([2.0]))[0] == 2.0
