"""The accessibility batch's lengths check, on the CPU: BatchedRaccess
checks the lengths' range on the host, once per batch, and
batch_energies (as window_probabilities) tells the four device wrappers
(inside_grids, inside_scan, outside_grids, and window_energies or
window_probs) with `checked=True`, so that on a card none of them reads
a value back from the device. Called without it, batch_energies,
window_probabilities and each wrapper still check the range
themselves and raise ValueError before any grid is built or any kernel
launched.

This file imports neither jax nor priblast_tpu."""

import numpy as np
import pytest
import torch

from priblast_tpu_torch.accessibility import batched as ab
from priblast_tpu_torch.ops import access_grids as ag
from priblast_tpu_torch.ops import access_prob as ap
from priblast_tpu_torch.ops import access_scan as acs

W_SPAN, D = 40, 5
BAND = W_SPAN + 2
LENS = (61, 48, 23)


def _batch(lens=LENS, seed=7):
    """Random codes of rows of `lens` nt, padded as BatchedRaccess pads
    them: (codes [B, n_max] uint8, padded s [B, S] int64, n_max)."""
    rng = np.random.default_rng(seed)
    n_max = max(lens)
    codes = np.zeros((len(lens), n_max), np.uint8)
    for i, n in enumerate(lens):
        codes[i, :n] = rng.integers(1, 5, n)
    s = np.zeros((len(lens), n_max + ab.ML + 4), np.int64)
    s[:, 1: n_max + 1] = codes
    return codes, torch.as_tensor(s), n_max


@pytest.fixture(scope="module")
def chain():
    """A batch's inputs of every wrapper, from the plain chain: (t, s,
    lens, n_max, g, ins, og, m1, outs)."""
    dt = torch.float64
    _codes, s, n_max = _batch()
    lens = torch.tensor(LENS, dtype=torch.int64)
    t = ab.make_tables(W_SPAN, dt)
    g = ab.make_grids(t, s, lens, n_max, BAND, dt)
    ins = acs.inside_scan(t, g, lens, n_max, BAND, dt)
    og, m1 = ab.outside_inputs(t, s, lens, n_max, BAND, dt, g, ins)
    outs = acs.outside_scan(t, og, m1, n_max, BAND, dt)
    return t, s, lens, n_max, g, ins, og, m1, outs


def _no_grids(monkeypatch):
    """Make building a grid fail the test."""
    def boom(*a, **k):
        raise AssertionError("a grid was built")

    for mod, name in ((ag, "inside_grids"), (ag, "outside_grids"),
                      (ab, "make_grids"), (ab, "make_outside_grids")):
        monkeypatch.setattr(mod, name, boom)


@pytest.mark.parametrize("rows,bad", [(3, -1), (3, 1), (1, 5)])
def test_window_probabilities_rejects_a_bad_length_before_any_grid(
        monkeypatch, rows, bad):
    """A length below 0 or past n_max (by `bad`), in a batch of three
    rows or of one (which runs as two copies of its row): ValueError, and
    no grid built."""
    _codes, s, n_max = _batch()
    s = s[:rows].contiguous()
    lens = torch.tensor(LENS[:rows], dtype=torch.int64)
    lens[-1] = -1 if bad < 0 else n_max + bad
    _no_grids(monkeypatch)
    with pytest.raises(ValueError, match="lengths"):
        ab.window_probabilities(W_SPAN, D, n_max, torch.float64, s, lens)


def test_window_probabilities_checked_matches_unchecked(chain):
    """Told that the lengths are checked, window_probabilities gives the
    same bits: the check moved, not the result."""
    t, s, lens, n_max = chain[:4]
    ref = ab.window_probabilities(W_SPAN, D, n_max, torch.float64, s, lens,
                                  t)
    got = ab.window_probabilities(W_SPAN, D, n_max, torch.float64, s, lens,
                                  t, checked=True)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("bad", ["negative", "past n_max"])
@pytest.mark.parametrize("wrapper", ["inside_grids", "inside_scan",
                                     "outside_grids", "window_probs"])
def test_wrappers_without_checked_reject_a_bad_length(chain, wrapper, bad):
    """Each of the four wrappers called without `checked` still checks the
    lengths' range: ValueError for a length below 0 or past n_max."""
    t, s, lens, n_max, g, ins, og, m1, outs = chain
    dt = torch.float64
    lens = lens.clone()
    lens[0] = -3 if bad == "negative" else n_max + 1
    logZ = ins[6].gather(0, lens.clamp(0, n_max)[None, :])[0]
    calls = {
        "inside_grids": lambda: ag.inside_grids(t, s, lens, n_max, BAND, dt),
        "inside_scan": lambda: acs.inside_scan(t, g, lens, n_max, BAND, dt),
        "outside_grids": lambda: ag.outside_grids(
            t, s, lens, n_max, BAND, dt, g, ins[5], ins[6], ins[7], logZ),
        "window_probs": lambda: ap.window_probs(
            t, g, s, lens, D, n_max, BAND, dt, ins, outs)}
    with pytest.raises(ValueError, match="lengths"):
        calls[wrapper]()


def test_checked_lengths_read_no_value():
    """With `checked`, the lengths' check reads no value: it passes on a
    meta tensor, which holds none, and checks only its shape, dtype and
    device; without it, the read of a meta tensor fails."""
    lens = torch.empty(4, dtype=torch.int64, device="meta")
    meta = torch.device("meta")
    acs._check_lengths(lens, 10, 4, meta, checked=True)
    with pytest.raises(ValueError):
        acs._check_lengths(lens, 10, 5, meta, checked=True)
    with pytest.raises(ValueError):
        acs._check_lengths(lens.int(), 10, 4, meta, checked=True)
    with pytest.raises(Exception):
        acs._check_lengths(lens, 10, 4, meta)


@pytest.mark.parametrize("lengths", [(61, -1, 23), (61, 62, 23), (61, 48)])
def test_batched_raccess_rejects_a_bad_length(monkeypatch, lengths):
    """BatchedRaccess checks its numpy lengths on the host: a length below
    0 or past the batch's n_max, or a count other than the rows', raises
    ValueError before any accessibility is computed."""
    codes, _s, _n_max = _batch()

    def boom(*a, **k):
        raise AssertionError("the accessibility ran")

    monkeypatch.setattr(ab, "window_probabilities", boom)
    monkeypatch.setattr(ab, "batch_energies", boom)
    engine = ab.BatchedRaccess(W_SPAN, D, devices=[torch.device("cpu")])
    with pytest.raises(ValueError, match="lengths"):
        engine.run(codes, np.asarray(lengths))
