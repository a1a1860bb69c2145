"""The tables carried across: the port's accessibility Tables and gapped
plane tables, built from the JAX package's own arrays with
tables_from_numpy, equal the port's own constructions array by array; and
the packed table buffer of the gapped kernel reproduces the plane tables
through the kernel's own index formulas."""

import re

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
from priblast_tpu_torch.ops import gapped_sweep as sop
from priblast_tpu_torch.search import gapped as tg
from priblast_tpu_torch.utils import thermo


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


def _kernel_formulas(flag):
    """The kernel's lookups (csrc/gapped_extend.cu header), in numpy, from
    the packed buffer alone, over every combination of characters in the
    axis conventions of `_plane_tables`."""
    buf = sop.pack_tables()
    tab16 = {name: buf[off:].astype(np.int64) for name, off, _ in sop.TABLES16}
    i22, i21, i11 = tab16["i22"], tab16["i21"], tab16["i11"]
    small = buf[sop.SMALL_BASE: sop.SMALL_BASE + 2 * sop.N_SMALL].view(
        np.int32).astype(np.int64)
    tab32 = {name: small[off:] for name, off, _ in sop.TABLES32}
    stack, mism, bp, rt = (tab32[k] for k in ("stack", "mism", "bp",
                                               "rtype"))
    b1 = small[sop.B1_AT]

    def t0(a, b):
        t = bp[a * 5 + b]
        return rt[t] if flag else t

    def st(a, b):
        return rt[t0(a, b)]

    def wob(t):
        return (t == 3) | (t == 4)

    def stk(T, pt):
        return stack[pt * 7 + T] if flag else stack[T * 7 + pt]

    c = np.arange(5)
    out = {}
    # [q0, q_aux, d0, d_aux] -> [25, 25]
    q0, qa, d0, da = np.ix_(c, c, c, c)
    T = t0(q0, d0)
    out["MS"] = (mism[(T * 5 + da) * 5 + qa] if flag
                 else mism[(T * 5 + qa) * 5 + da])
    S = st(q0, d0)
    out["VM"] = (mism[(S * 5 + qa) * 5 + da] if flag
                 else mism[(S * 5 + da) * 5 + qa])
    t1 = t0(qa, da)
    out["BAD1"] = (t1 == 0) | (wob(T) & wob(t1))
    out["STK00"] = stk(T, st(qa, da))
    out["STK10"] = b1 + stk(T, st(qa, da))
    out["STK01"] = b1 + stk(T, st(qa, da))
    for k in ("MS", "VM", "BAD1", "STK00", "STK10", "STK01"):
        out[k] = out[k].reshape(25, 25)
    # [q0, q-1, q-2, d0, d-1, d-2] -> [125, 125]
    q0, q1, q2, d0, d1, d2 = np.ix_(c, c, c, c, c, c)
    T, tb = t0(q0, d0), st(q2, d2)
    out["V11"] = (i11[((tb * 8 + T) * 5 + q1) * 5 + d1] if flag
                  else i11[((T * 8 + tb) * 5 + q1) * 5 + d1]).reshape(125, 125)
    tb = np.arange(7).reshape(7, 1, 1, 1, 1, 1, 1)
    q0, q1, q2, d0, d1, d2 = (x[None] for x in (q0, q1, q2, d0, d1, d2))
    T = t0(q0, d0)
    out["V22"] = (i22[((((tb * 8 + T) * 5 + q2) * 5 + q1) * 5 + d1) * 5 + d2]
                  if flag else
                  i22[((((T * 8 + tb) * 5 + q1) * 5 + q2) * 5 + d2) * 5 + d1]
                  ).reshape(7, 125, 125)
    tb = tb[..., 0]
    q0, q1, d0, d1, d2 = np.ix_(c, c, c, c, c)
    q0, q1, d0, d1, d2 = (x[None] for x in (q0, q1, d0, d1, d2))
    T = t0(q0, d0)
    out["V12"] = (i21[(((tb * 8 + T) * 5 + q1) * 5 + d1) * 5 + d2] if flag
                  else i21[(((T * 8 + tb) * 5 + q1) * 5 + d2) * 5 + d1]
                  ).reshape(7, 25, 125)
    q0, q1, q2, d0, d1 = np.ix_(c, c, c, c, c)
    q0, q1, q2, d0, d1 = (x[None] for x in (q0, q1, q2, d0, d1))
    T = t0(q0, d0)
    out["V21"] = (i21[(((T * 8 + tb) * 5 + d1) * 5 + q2) * 5 + q1] if flag
                  else i21[(((tb * 8 + T) * 5 + d1) * 5 + q1) * 5 + q2]
                  ).reshape(7, 125, 25)
    a, b = np.ix_(c, c)
    out["BADX"] = t0(a, b) == 0
    out["NZ0"] = t0(a, b) != 0
    out["W0"] = wob(t0(a, b))
    out["AU0"] = t0(a, b) > 2
    out["STT"] = st(a, b)
    return out


@pytest.mark.parametrize("flag", [0, 1])
def test_packed_tables_reproduce_plane_tables(flag):
    """The kernel reads only the packed buffer: its index formulas, applied
    to that buffer, give every entry of every plane table of the plain
    version; the int16 loop tables hold the raw values exactly; the
    layout constants of the .cu source are the Python ones."""
    planes = tg._plane_tables(flag)
    mine = _kernel_formulas(flag)
    assert sorted(mine) == sorted(planes)
    for name, v in planes.items():
        got = np.asarray(mine[name], np.float64)
        assert got.shape == v.shape, name
        assert np.array_equal(got, v), name

    buf = sop.pack_tables()
    assert buf.dtype == np.int16 and buf.size == sop.N_WORDS
    for _name, off, key in sop.TABLES16:
        raw = getattr(thermo.RAW, key).reshape(-1)
        assert np.array_equal(buf[off: off + raw.size].astype(np.int64), raw)
    small = buf[sop.SMALL_BASE: sop.SMALL_BASE + 2 * sop.N_SMALL].view(
        np.int32)
    for _name, off, key in sop.TABLES32:
        raw = getattr(thermo.RAW, key).reshape(-1)
        assert np.array_equal(small[off: off + raw.size], raw)
    assert small[sop.TAU_AT] == thermo.RAW.TerminalAU

    src = sop._SRC.read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"\b(k[A-Z]\w*) = (\d+)",
                         "\n".join(line for line in src.splitlines()
                                   if line.lstrip().startswith(
                                       ("constexpr int", "kTau"))))}
    py = {"kI22": sop.TABLES16[0][1], "kI21": sop.TABLES16[1][1],
          "kI11": sop.TABLES16[2][1], "kSmall": sop.SMALL_BASE,
          "kStack": sop.TABLES32[0][1], "kMism": sop.TABLES32[1][1],
          "kBp": sop.TABLES32[2][1], "kRtype": sop.TABLES32[3][1],
          "kB1": sop.B1_AT, "kTau": sop.TAU_AT, "kNSmall": sop.N_SMALL,
          "kWords": sop.N_WORDS}
    assert {k: consts.get(k) for k in py} == py
