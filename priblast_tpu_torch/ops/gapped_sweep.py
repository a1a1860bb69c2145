"""One direction of the gapped extension: a hand-written CUDA kernel for
Hopper (csrc/gapped_extend.cu) and its plain PyTorch version.

Replaces the TPU Pallas kernel ``_sweep_kernel``
(priblast_tpu/search/gapped_pl.py:51, launched by ``pallas_sweep`` at
gapped_pl.py:337) together with the XLA code around it in
priblast_tpu/search/gapped.py:_extend_dir. Per hit it computes the
character windows, the boundary offsets and the prefix accessibility
chains; then the banded anti-diagonal gapped-extension DP of the
reference (src/gapped_extension.cpp:213-319): every cell (i, L-i) takes
the minimum over the (dropout+1)(dropout+2)/2 predecessor offsets (u1, u2)
in the reference's stems-list order (first occurrence wins on ties) of
predecessor hyb + loop energy, then helix/wobble admission, the running
minimum of extq + extdb + hyb with its argmin, dropout/boundary stop and
the overflow flag at max_ext; and last the traceback walk
(gapped_extension.cpp:409-424).

`gapped_extend_dir` takes the flat sequence and accessibility buffers and
the per-hit columns, and returns
  ints [B, 5] int32: min_i, min_j, min_len, overflow, diagonals swept;
  floats [B, 2]: min_e, min_a (the working dtype);
  tb [B, 2, max_ext // 2 + 1] int32: tb_i, tb_j in reference push order,
     0-terminated.
On CUDA tensors it launches the kernel, which looks every energy up from
the characters in the Turner tables held in shared memory: no energy
plane, predecessor row or traceback state reaches device memory. On CPU
tensors it runs the plain version, `extend_dir_plain`: the energy planes
[B, 9, max_ext+1, max_ext] built by gathers, the sweep (`sweep_plain`, a
Python loop over the diagonals) and the traceback as a loop of gathers,
in the operation order of the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path

import numpy as np
import torch

from priblast_tpu_torch.ops import nvcc
from priblast_tpu_torch.utils import thermo

BIG = 10_000_000  # "unbounded" boundary sentinel (reference MAX_EXTENSION,
#                   gapped_extension.cpp:30)

# float plane layout of the plain version: MS, the loop energy of each
# special (u1, u2) offset, VM; bits of the bit plane
N_FPLANES = 9
MS, VM = 0, 8
SPECIAL = {(0, 0): 1, (1, 0): 2, (0, 1): 3, (1, 1): 4, (1, 2): 5,
           (2, 1): 6, (2, 2): 7}
NZ0, W0, AU0, BAD = 1, 2, 4, 8

# the packed table buffer the kernel reads (csrc/gapped_extend.cu header):
# int16 words of the loop tables, then int32 words of the small tables
TABLES16 = (("i22", 0, "int22_37"), ("i21", 40000, "int21_37"),
            ("i11", 48000, "int11_37"))
SMALL_BASE = 49600      # int16 offset of the int32 region
TABLES32 = (("stack", 0, "stack37"), ("mism", 49, "mismatchI37"),
            ("bp", 224, "BP_pair"), ("rtype", 249, "rtype"))
B1_AT, TAU_AT, N_SMALL = 256, 257, 258   # int32 offsets
N_WORDS = 50120         # int16 words, padded to a multiple of 8

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
_SRC = Path(__file__).resolve().parents[1] / "csrc" / "gapped_extend.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-maxrregcount=64", "-shared",
              "-Xcompiler", "-fPIC"]

launches = 0  # kernel launches by gapped_extend_dir(); plain calls not counted
# the same launches by the kernel's form (`kernel_form`)
form_launches = {"worklist": 0, "lanes": 0}
WORKLIST_MAX_EXT = 32   # csrc/gapped_extend.cu kWorkMax


def combos(dropout: int):
    """(s, u1) predecessor offsets in the reference's stems-list order."""
    return [(s, u1) for s in range(dropout, -1, -1)
            for u1 in range(s, -1, -1)]


def kernel_form(max_ext: int, device) -> str | None:
    """The form of the sweep that gapped_extend_dir runs on `device`: the
    kernel's work list for max_ext <= 32 (a diagonal's cells fit a warp's
    lanes and a ring row's finite cells one mask word), its lanes form for
    wider ones, and None on the CPU (the plain version)."""
    if torch.device(device).type != "cuda":
        return None
    return "worklist" if max_ext <= WORKLIST_MAX_EXT else "lanes"


def build() -> Path:
    """Compile csrc/gapped_extend.cu into build/kernels/ with nvcc (once
    per source version)."""
    return nvcc.build(_SRC, NVCC_FLAGS)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name in ("gapped_extend_f32", "gapped_extend_f64"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4
    return lib


# ---- Turner tables ----------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _tables_np():
    r = thermo.RAW
    f = lambda x: np.asarray(x, np.float64).reshape(-1)  # noqa: E731
    return dict(
        bp=r.BP_pair.reshape(-1).astype(np.int64),
        rtype=r.rtype.astype(np.int64),
        stack=f(r.stack37),
        bulge=f(r.bulge37),
        i11=f(r.int11_37),
        i21=f(r.int21_37),
        i22=f(r.int22_37),
        mismI=f(r.mismatchI37),
        intloop=f(r.internal_loop37),
        lxc=np.float64(thermo.RAW.lxc37),
        term_au=np.float64(thermo.RAW.TerminalAU),
    )


def _np_wob(t):
    # wobble pair types (reference: gapped_extension.cpp:340)
    return (t == 3) | (t == 4)


def _bulge_const(s: int) -> float:
    r = _tables_np()
    return float(r["bulge"][s] if s <= 30 else
                 r["bulge"][30] + r["lxc"] * np.log(s / 30.0))


@functools.lru_cache(maxsize=8)
def _plane_tables(flag: int):
    """Composite numpy lookup tables over combined-character indices for
    the per-cell energy planes of the plain version. Conventions: q-side
    combined index is (qm[x]*5 + aux1)(*5 + aux2); d-side likewise with
    dm[y] leading. Value tables are raw Turner units; the single /100
    happens at the working dtype. Compositions mirror ops/native/search.cc
    loop37_gapped and gapped_extension.cpp:426-473; the kernel computes
    the same entries from the packed tables (csrc/gapped_extend.cu)."""
    r = _tables_np()
    bp = r["bp"].reshape(5, 5)
    rt = r["rtype"]
    t0 = rt[bp] if flag == 1 else bp      # flag-adjusted cell pair type
    st = rt[t0]                           # stored cell type (= rt[type1])
    mism = r["mismI"]
    stack = r["stack"]
    i11, i21, i22 = r["i11"], r["i21"], r["i22"]
    b1 = float(r["bulge"][1])

    # axis order: C1=qm[x], QA=q-aux1, QE=q-aux2, C2=dm[y], DA=d-aux1,
    # DG=d-aux2 (np.ix_ broadcasting)
    A5 = list(range(5))
    C1, QA, C2, DA = np.ix_(A5, A5, A5, A5)
    T = t0[C1, C2]
    S_ = st[QA, DA]

    def q2d2(arr):
        return arr.reshape(25, 25)

    out = {}
    # mism_shared: aux = (qm[x-1], dm[y-1])
    out["MS"] = q2d2(mism[(T * 5 + QA) * 5 + DA] if flag == 0 else
                     mism[(T * 5 + DA) * 5 + QA])
    # vm (predecessor-cell mismatch, stored per cell): aux = (qm[x+1],
    # dm[y+1]); reference mism_row with st_row = rt[type1]
    ST = st[C1, C2]
    out["VM"] = q2d2(mism[(ST * 5 + DA) * 5 + QA] if flag == 0 else
                     mism[(ST * 5 + QA) * 5 + DA])
    # helix x'=1 badness: aux = (qm[x+1], dm[y-1]); includes the wobble
    # cross-term with t0 (reference: gapped_extension.cpp:342-364)
    T1 = t0[QA, DA]
    out["BAD1"] = q2d2(((T1 == 0) |
                        (_np_wob(T) & _np_wob(T1))).astype(np.float64))
    # helix x'>=2 badness: single chars (qm[x+x'], dm[y-x'])
    out["BADX"] = (t0 == 0).astype(np.float64)

    # stack-class values (aux q = qm[x-u1-1+...], aux d = ...):
    #   STK00: pred (x-1, y-1);  STK10: pred (x-2, y-1);  STK01: (x-1, y-2)
    def stk(pt):
        return stack[T * 7 + pt] if flag == 0 else stack[pt * 7 + T]

    out["STK00"] = q2d2(stk(S_))
    out["STK10"] = q2d2(b1 + stk(S_))   # aux: (qm[x-2], dm[y-1])
    out["STK01"] = q2d2(b1 + stk(S_))   # aux: (qm[x-1], dm[y-2])
    # small-internal specials. V11 carries tb in its char axes;
    # V12/V21/V22 are per-tb slates (tb = predecessor stored type 0..6).
    C1, QA, QE, C2, DA, DG = np.ix_(A5, A5, A5, A5, A5, A5)
    T = t0[C1, C2]
    TB = st[QE, DG]

    def q3d3(arr):
        return arr.reshape(125, 125)

    if flag == 0:
        v11 = i11[((T * 8 + TB) * 5 + QA) * 5 + DA]
    else:
        v11 = i11[((TB * 8 + T) * 5 + QA) * 5 + DA]
    out["V11"] = q3d3(v11)

    C1, QA, C2, DA, DG = np.ix_(A5, A5, A5, A5, A5)
    T = t0[C1, C2]
    v12, v21, v22 = [], [], []
    for tb in range(7):
        if flag == 0:
            v12.append(i21[(((T * 8 + tb) * 5 + QA) * 5 + DG) * 5 + DA])
        else:
            v12.append(i21[(((tb * 8 + T) * 5 + QA) * 5 + DA) * 5 + DG])
        v12[-1] = v12[-1].reshape(25, 125)        # q=(c1,qa) d=(c2,da,dg)
    C1, QA, QE, C2, DA = np.ix_(A5, A5, A5, A5, A5)
    T = t0[C1, C2]
    for tb in range(7):
        if flag == 0:
            z = i21[(((tb * 8 + T) * 5 + DA) * 5 + QA) * 5 + QE]
        else:
            z = i21[(((T * 8 + tb) * 5 + DA) * 5 + QE) * 5 + QA]
        v21.append(z.reshape(125, 25))            # q=(c1,qa,qe) d=(c2,da)
    C1, QA, QE, C2, DA, DG = np.ix_(A5, A5, A5, A5, A5, A5)
    T = t0[C1, C2]
    for tb in range(7):
        if flag == 0:
            z = i22[((((T * 8 + tb) * 5 + QA) * 5 + QE) * 5 + DG) * 5 + DA]
        else:
            z = i22[((((tb * 8 + T) * 5 + QE) * 5 + QA) * 5 + DA) * 5 + DG]
        v22.append(z.reshape(125, 125))
    out["V12"] = np.stack(v12)                    # [7, 25, 125]
    out["V21"] = np.stack(v21)                    # [7, 125, 25]
    out["V22"] = np.stack(v22)                    # [7, 125, 125]
    # bit/bool tables of the flag-adjusted type
    out["NZ0"] = (t0 != 0).astype(np.float64)
    out["W0"] = _np_wob(t0).astype(np.float64)
    out["AU0"] = (t0 > 2).astype(np.float64)
    out["STT"] = st.astype(np.float64)            # stored type (0..6)
    return out


def tables_from_numpy(fields: dict, dtype=torch.float32, device="cpu"):
    """The plane tables as tensors, built from numpy arrays (one entry per
    name of `_plane_tables`): value tables in `dtype`, the bit and
    stored-type tables as int64 lookups."""
    out = {}
    for k, v in fields.items():
        v = np.asarray(v)
        if k in ("BAD1", "BADX", "NZ0", "W0", "AU0", "STT"):
            out[k] = torch.tensor(v.astype(np.int64), device=device)
        else:
            out[k] = torch.tensor(v, dtype=dtype, device=device)
    return out


@functools.lru_cache(maxsize=1)
def pack_tables() -> np.ndarray:
    """The raw Turner tables the kernel reads, as one int16 buffer of
    N_WORDS words: int22/int21/int11 as int16 (their values lie in
    [-161, 368]), then an int32 region for stack, mismatchI, BP_pair,
    rtype, bulge37[1] and TerminalAU (stack holds 1,000,000)."""
    r = thermo.RAW
    buf = np.zeros(N_WORDS, np.int16)
    for _name, off, key in TABLES16:
        v = getattr(r, key).reshape(-1)
        buf[off: off + v.size] = v.astype(np.int16)
    small = np.zeros(N_SMALL, np.int32)
    for _name, off, key in TABLES32:
        v = getattr(r, key).reshape(-1)
        small[off: off + v.size] = v
    small[B1_AT] = r.bulge37[1]
    small[TAU_AT] = r.TerminalAU
    buf[SMALL_BASE: SMALL_BASE + 2 * N_SMALL] = small.view(np.int16)
    return buf


# device tensors by (what, ..., device); a lock guards it, as the shards
# of a split stage fill it from several threads at once
_device_cache: dict = {}
_cache_lock = threading.RLock()


def _device_tables(device):
    key = ("tables", str(device))
    with _cache_lock:
        if key not in _device_cache:
            _device_cache[key] = torch.as_tensor(pack_tables(),
                                                 device=device)
        return _device_cache[key]


def _loop_consts(dropout: int, dt, device):
    """[2, dropout+1]: interior-loop and bulge constants per loop size s
    (bulge 0 for s < 2), in the working dtype."""
    key = ("consts", dropout, dt, str(device))
    with _cache_lock:
        if key not in _device_cache:
            r = _tables_np()
            _device_cache[key] = torch.tensor(
                [[float(r["intloop"][min(s, 30)])
                  for s in range(dropout + 1)],
                 [_bulge_const(s) if s >= 2 else 0.0
                  for s in range(dropout + 1)]], dtype=dt, device=device)
        return _device_cache[key]


def _kernel_consts(dropout: int, dt, device):
    """The kernel's constants: the loop constants of `_loop_consts`, then
    the quotients r / 100 in dt of every integer r from rlo to rhi, the
    range of the integer energies the kernel divides by 100 (the specials'
    table values; MS + interior-loop constant + VM; terminal-AU terms +
    bulge constant; sizes s <= 30, where every constant is an integer).
    Returns (tensor, rlo, nspan)."""
    key = ("kconsts", dropout, dt, str(device))
    with _cache_lock:
        if key not in _device_cache:
            _device_cache[key] = _make_kernel_consts(dropout, dt, device)
        return _device_cache[key]


def _make_kernel_consts(dropout: int, dt, device):
    r = thermo.RAW
    inf = 100_000           # the tables' 1,000,000 entries fall back
    small = lambda a: a[np.abs(a) < inf]  # noqa: E731
    b1 = int(r.bulge37[1])
    sizes = range(2, min(dropout, 30) + 1)
    mism = r.mismatchI37
    tau = int(r.TerminalAU)
    cand = [small(r.stack37), b1 + small(r.stack37), r.int11_37,
            r.int21_37, r.int22_37]
    cand += [2 * np.array([mism.min(), mism.max()]) + v
             for v in small(r.internal_loop37[list(sizes)])]
    cand += [np.array([0, 2 * tau]) + v
             for v in small(r.bulge37[list(sizes)])]
    flat = np.concatenate([np.ravel(c) for c in cand])
    rlo, rhi = int(flat.min()), int(flat.max())
    div = (torch.arange(rlo, rhi + 1, dtype=torch.float64).to(dt)
           / torch.tensor(100.0, dtype=dt))
    buf = torch.cat([_loop_consts(dropout, dt, "cpu").reshape(-1), div])
    return buf.to(device), rlo, rhi - rlo + 1


# ---- the wrapper ---------------------------------------------------------------

_HIT_COLS = ("q_start", "db_start", "id_anchor", "qb", "qab", "dbb", "aoff",
             "coff")
_BUFS = (("q_enc", torch.int64), ("db_seq", torch.int64),
         ("q_acc", torch.float32), ("q_cond", torch.float32),
         ("db_acc", torch.float32), ("db_cond", torch.float32))


def gapped_extend_dir(q_start, db_start, id_anchor, energy0, acc0, valid,
                      qb, qab, dbb, aoff, coff, q_enc, db_seq, q_acc, q_cond,
                      db_acc, db_cond, *, flag: int, d: int, dropout: int,
                      min_helix: int, max_ext: int, dtype: str = "float32"):
    """One direction (flag 0 = left, 1 = right) of the gapped extension for
    a batch of hits over flat buffers: the CUDA kernel for CUDA tensors,
    `extend_dir_plain` for CPU tensors. Arguments as
    search/gapped.py:_extend_dir. Returns (ints, floats, tb); see the module
    doc."""
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype}")
    if not 1 <= max_ext <= 120:
        raise ValueError(
            f"max_ext={max_ext} outside 1..120: packed predecessor coords "
            f"need 14 bits (ZW payload bits 16384/32768 would be corrupted)")
    if flag not in (0, 1) or dropout < 0 or min_helix < 0:
        raise ValueError(f"bad flag={flag} dropout={dropout} "
                         f"min_helix={min_helix}")
    dt = _DTYPES[dtype]
    dev = q_start.device
    B = q_start.shape[0]
    cols = dict(zip(_HIT_COLS, (q_start, db_start, id_anchor, qb, qab, dbb,
                                aoff, coff)))
    for name, t in cols.items():
        nvcc.check_tensor(t, name, (B,), torch.int64, dev)
    for name, t in (("energy0", energy0), ("acc0", acc0)):
        nvcc.check_tensor(t, name, (B,), None, dev, contiguous=False)
        if not t.is_floating_point():
            raise ValueError(f"{name} must be floating point")
    nvcc.check_tensor(valid, "valid", (B,), torch.bool, dev)
    bufs = (q_enc, db_seq, q_acc, q_cond, db_acc, db_cond)
    for (name, bdt), t in zip(_BUFS, bufs):
        nvcc.check_tensor(t, name, None, bdt, dev)
        if t.shape[0] == 0:
            raise ValueError(f"{name} is empty")
    args = (q_start, db_start, id_anchor, energy0, acc0, valid, qb, qab, dbb,
            aoff, coff, *bufs)
    kw = dict(flag=flag, d=d, dropout=dropout, min_helix=min_helix,
              max_ext=max_ext, dtype=dtype)
    if dev.type == "cpu":
        return extend_dir_plain(*args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"gapped_extend_dir runs on cuda or cpu, not {dev}")

    fn = (_lib().gapped_extend_f32 if dt == torch.float32
          else _lib().gapped_extend_f64)
    with torch.cuda.device(dev):
        out = _call(fn, args, torch.cuda.current_stream(dev).cuda_stream,
                    **kw)
    # an empty batch launches nothing
    nvcc.add_launches(globals(), "launches", int(B > 0))
    nvcc.add_launches(form_launches, kernel_form(max_ext, dev), int(B > 0))
    return out


def _call(fn, args, stream, *, flag, d, dropout, min_helix, max_ext, dtype):
    """Allocate the outputs and call a C entry point of
    csrc/gapped_extend.cu on `args` (the checked arguments of
    gapped_extend_dir) on `stream`."""
    (q_start, db_start, id_anchor, energy0, acc0, valid, qb, qab, dbb, aoff,
     coff, *bufs) = args
    dt = _DTYPES[dtype]
    dev = q_start.device
    B = q_start.shape[0]
    steps = max_ext // 2 + 1
    XW = max_ext + max(min_helix, 2)
    ints = torch.empty((B, 5), dtype=torch.int32, device=dev)
    floats = torch.empty((B, 2), dtype=dt, device=dev)
    tb = torch.empty((B, 2, steps), dtype=torch.int32, device=dev)
    if B == 0:
        return ints, floats, tb
    e0 = energy0.to(dt).contiguous()
    a0 = acc0.to(dt).contiguous()
    consts, rlo, nspan = _kernel_consts(dropout, dt, dev)
    ptrs = (*(t.data_ptr() for t in bufs),
            *(t.data_ptr() for t in (q_start, db_start, id_anchor, qb, qab,
                                     dbb, aoff, coff, e0, a0, valid)),
            _device_tables(dev).data_ptr(), consts.data_ptr(),
            ints.data_ptr(), floats.data_ptr(), tb.data_ptr())
    sizes = (*(t.shape[0] for t in bufs), B)
    iparams = (flag, d, dropout, min_helix, max_ext, XW, steps, rlo, nspan)
    err = fn((ctypes.c_void_p * len(ptrs))(*ptrs),
             (ctypes.c_longlong * len(sizes))(*sizes),
             (ctypes.c_int * len(iparams))(*iparams), stream)
    if err != 0:
        raise RuntimeError(f"gapped_extend kernel launch failed: CUDA error "
                           f"{err}")
    return ints, floats, tb


# ---- the plain version ----------------------------------------------------------

def _gather_chars(seq, start, sign: int, xw: int):
    """raw[b, x] = seq[start_b + sign*x], 0 outside bounds; and the GetChar
    mapping (reference: gapped_extension.cpp:401-407)."""
    n = seq.shape[0]
    x = torch.arange(xw, device=seq.device)
    pos = start[:, None] + sign * x[None, :]
    oob = (pos < 0) | (pos >= n)
    raw = torch.where(oob, 0, seq[pos.clamp(0, n - 1)])
    mapped = torch.where(raw < 2, 0, torch.where(raw <= 5, raw - 1, raw - 5))
    return raw, mapped


def max_ext_of(raw):
    """Boundary offset: the last offset before the first blocked character
    at x >= 1, or BIG (reference: gapped_extension.cpp:111-134)."""
    blocked = raw[:, 1:] < 2
    x = torch.arange(1, raw.shape[1], device=raw.device)
    first = torch.where(blocked, x, BIG).min(1).values
    return torch.where(blocked.any(1), first - 1, BIG)


def _seq_prefix(inc):
    """Sequential prefix chain: out[:, 0] = 0, out[:, x] = out[:, x-1] +
    inc[:, x] (reference gapped_extension.cpp:156-212 adds one entry at a
    time)."""
    out = torch.zeros_like(inc)
    c = out[:, 0]
    for x in range(1, inc.shape[1]):
        c = c + inc[:, x]
        out[:, x] = c
    return out


def extend_dir_plain(q_start, db_start, id_anchor, energy0, acc0, valid,
                     qb, qab, dbb, aoff, coff, q_enc, db_seq, q_acc, q_cond,
                     db_acc, db_cond, *, flag: int, d: int, dropout: int,
                     min_helix: int, max_ext: int, dtype: str = "float32",
                     counts: dict | None = None):
    """Plain PyTorch version of `gapped_extend_dir`, on any device: the
    character windows and prefix chains, the energy "planes" (every table
    term of the DP is a function of a few characters around a cell, looked
    up once per call as ``M[q-side index, d-side index]`` into hit-major
    diagonal rows [B, max_ext+1, W], row D, lane i = cell (i, D - i)), the
    sweep (`sweep_plain`) and the traceback, a fixed-length walk over the
    predecessor rows. `counts`, if given, gets the sweep's work added
    (`count_work`)."""
    dt = _DTYPES[dtype]
    dev = q_start.device
    r_np = _tables_np()
    tab = tables_from_numpy(_plane_tables(flag), dt, dev)
    B = q_start.shape[0]
    W = max_ext               # lane i of a diagonal
    ME1 = max_ext + 1
    XW = max_ext + max(min_helix, 2)  # char arrays cover offsets 0..XW-1
    Y = W + 1                 # db-offset range of reachable cells
    sign = -1 if flag == 0 else 1

    # --- per-hit character windows ([B, X])
    q_raw, qm = _gather_chars(q_enc, qb + q_start, sign, XW)
    db_raw, dm = _gather_chars(db_seq, dbb + db_start, sign, XW)
    maxq = max_ext_of(q_raw)
    maxd = max_ext_of(db_raw)

    # prefix accessibility arrays, extq[x] / extdb[x] = energy of extending
    # x positions (reference: gapped_extension.cpp:156-212). The length-1
    # entry is computed in float32 and widened, as in the reference.
    x1 = torch.arange(XW, device=dev)

    def g1(arr, idx):
        return arr[idx.clamp(0, arr.shape[0] - 1)]

    def inc3(a_, b_, c_):
        full = a_.to(dt) - b_.to(dt) + c_.to(dt)
        full[:, 1] = (a_[:, 1] - b_[:, 1] + c_[:, 1]).to(dt)
        return full

    if flag == 0:
        posq = (qab + q_start)[:, None] - x1[None, :]
        incq = inc3(g1(q_acc, posq), g1(q_acc, posq + 1),
                    g1(q_cond, posq + d))
        incdb = g1(db_cond, (coff + id_anchor)[:, None] + x1[None, :]).to(dt)
    else:
        incq = g1(q_cond, (qab + q_start)[:, None] + x1[None, :]).to(dt)
        posd = (aoff + id_anchor)[:, None] - x1[None, :]
        posc = (coff + id_anchor)[:, None] - x1[None, :]
        incdb = inc3(g1(db_acc, posd), g1(db_acc, posd + 1),
                     g1(db_cond, posc + d))
    extq = _seq_prefix(incq)
    extdb = _seq_prefix(incdb)

    # --- planes: diagonal row D, lane i = cell (x, y) = (i, D - i); lanes
    # with i > D hold the y = 0 value and are never read by the sweep
    ydiag = (torch.arange(ME1, device=dev)[:, None]
             - torch.arange(W, device=dev)[None, :]).clamp(0, Y - 1)

    def qs(k):
        # qm[x + k] over x in [0, W) (0 where x + k < 0)
        if k >= 0:
            return qm[:, k: k + W]
        return torch.nn.functional.pad(qm[:, : W + k], (-k, 0))

    def ds(k):
        # dm[y + k] over y in [0, Y) (0 where y + k < 0)
        if k >= 0:
            return dm[:, k: k + Y]
        return torch.nn.functional.pad(dm[:, : Y + k], (-k, 0))

    def plane(M, qidx, didx, tb=None):
        """P[b, D, i] = M[(tb,) qidx[b, i], didx[b, D - i]]."""
        dd = didx[:, ydiag]
        if tb is None:
            return M[qidx[:, None, :], dd]
        return M[tb, qidx[:, None, :], dd]

    def pairq(k):
        return qs(0) * 5 + qs(k)

    def paird(k):
        return ds(0) * 5 + ds(k)

    q3 = pairq(-1) * 5 + qs(-2)
    d3 = paird(-1) * 5 + ds(-2)

    def tbp(qo, do):
        # stored type at (x - qo, y - do)
        return plane(tab["STT"], qs(-qo), ds(-do))

    # a device-tensor divisor keeps true division on CUDA (a Python-scalar
    # divisor is turned into a multiply by its reciprocal there)
    hundred = torch.tensor(100.0, dtype=dt, device=dev)
    F = torch.empty((B, N_FPLANES, ME1, W), dtype=dt, device=dev)
    sp = SPECIAL
    F[:, MS] = plane(tab["MS"], pairq(-1), paird(-1))
    F[:, sp[0, 0]] = plane(tab["STK00"], pairq(-1), paird(-1)) / hundred
    F[:, sp[1, 0]] = plane(tab["STK10"], pairq(-2), paird(-1)) / hundred
    F[:, sp[0, 1]] = plane(tab["STK01"], pairq(-1), paird(-2)) / hundred
    F[:, sp[1, 1]] = plane(tab["V11"], q3, d3) / hundred
    F[:, sp[1, 2]] = plane(tab["V12"], pairq(-1), d3, tbp(2, 3)) / hundred
    F[:, sp[2, 1]] = plane(tab["V21"], q3, paird(-1), tbp(3, 2)) / hundred
    F[:, sp[2, 2]] = plane(tab["V22"], q3, d3, tbp(3, 3)) / hundred
    F[:, VM] = plane(tab["VM"], pairq(1), paird(1))

    # bit planes of the flag-adjusted cell type; helix lookahead pairs
    # (qm[x+x'], dm[y+x']): both strands advance in the extension direction
    if min_helix >= 2:
        bad = plane(tab["BAD1"], pairq(1), paird(1))
    else:
        bad = torch.zeros((B, ME1, W), dtype=torch.int64, device=dev)
    for x2 in range(2, min_helix):
        bad = torch.maximum(bad, plane(tab["BADX"], qs(x2), ds(x2)))
    bits = (plane(tab["NZ0"], qs(0), ds(0)) * NZ0
            + plane(tab["W0"], qs(0), ds(0)) * W0
            + plane(tab["AU0"], qs(0), ds(0)) * AU0
            + bad * BAD).to(torch.int32)

    # --- origin cell (reference: gapped_extension.cpp:116-127)
    bp_t = torch.as_tensor(r_np["bp"], device=dev)
    rt_t = torch.as_tensor(r_np["rtype"], device=dev)
    otype = bp_t[qm[:, 0] * 5 + dm[:, 0]]
    if flag == 0:
        otype = rt_t[otype]
    obits = (otype == 0).long() + ((otype == 3) | (otype == 4)).long() * 2
    hit_i = torch.stack([maxq.clamp(max=BIG), maxd.clamp(max=BIG),
                         valid.long(), obits], 1).to(torch.int32)
    hit_f = torch.stack([energy0.to(dt), acc0.to(dt)], 1)

    pred, ints, floats = sweep_plain(
        F, bits, extq.contiguous(), extdb.contiguous(), hit_i, hit_f,
        _loop_consts(dropout, dt, dev), float(r_np["term_au"]),
        dropout=dropout, max_ext=max_ext, counts=counts)
    min_i, min_j = ints[:, 0].long(), ints[:, 1].long()

    # --- traceback (reference: gapped_extension.cpp:409-424): walk the
    # predecessor links from (min_i, min_j); every step decreases the
    # diagonal by >= 2, so max_ext // 2 + 1 steps always reach the origin.
    pred_flat = pred.reshape(B, ME1 * W)
    steps = max_ext // 2 + 1
    tb = torch.zeros((B, 2, steps), dtype=torch.int32, device=dev)
    ti, tj = min_i, min_j
    for k in range(steps):
        live = (ti != 0) & (tj != 0)
        idx = ((ti + tj) * W + ti).clamp(0, ME1 * W - 1)
        packed = pred_flat.gather(1, idx[:, None])[:, 0].long().clamp(min=0)
        tb[:, 0, k] = torch.where(live, ti, 0)
        tb[:, 1, k] = torch.where(live, tj, 0)
        ti = torch.where(live, packed // ME1, 0)
        tj = torch.where(live, packed % ME1, 0)
    return ints, floats, tb


# ---- the sweep's plain version --------------------------------------------------

def _shift_lanes(x, sh: int, fill):
    """Lane i reads the value lane i - sh held; `fill` for i < sh."""
    if sh == 0:
        return x
    W = x.shape[-1]
    out = torch.full_like(x, fill)
    if sh < W:
        out[..., sh:] = x[..., : W - sh]
    return out


WORK_KEYS = ("diagonals", "band", "admitted", "combos", "rounds", "steps",
             "empty", "busiest", "nopred")


def count_work(counts: dict, L: int, active, band, adm, win_h,
               dropout: int) -> None:
    """Adds diagonal L's work to `counts` (keys WORK_KEYS, sums over the
    hits), from the sweep's state before the diagonal's row is added
    (`win_h` row dropout - s holds the predecessors' diagonal L - s - 2):
    diagonals swept, band cells, admitted cells, combos (an admitted cell's
    (s, u1) whose predecessor holds a finite hyb), the work list's rounds
    of 32 combos (per hit and diagonal), (admitted cell, s) steps whose
    predecessor diagonal is >= 0, those of them without a combo (`empty`),
    over s the most combos of one admitted cell (`busiest`: the lane of a
    one-lane-per-cell sweep that walks every s), and the admitted cells
    without a combo (`nopred`: the stems[0] fallback). The kernel's
    -DGAPPED_STAMPS build counts the same."""
    B, _, W = win_h.shape
    smax = min(dropout, L - 2)
    cnt = torch.zeros((B, max(smax + 1, 1), W), dtype=torch.long,
                      device=win_h.device)
    for s in range(smax + 1):
        fin = torch.isfinite(win_h[:, dropout - s])
        for u1 in range(s + 1):
            cnt[:, s] += _shift_lanes(fin, u1 + 1, False).long()
    cnt *= adm[:, None, :]
    n = cnt.sum((1, 2))
    steps = int(adm.sum()) * (smax + 1) if smax >= 0 else 0
    empty = int(((cnt == 0) & adm[:, None, :]).sum()) if smax >= 0 else 0
    add = dict(diagonals=int(active.sum()), band=int(band.sum()),
               admitted=int(adm.sum()), combos=int(n.sum()),
               rounds=int(((n + 31) // 32).sum()), steps=steps, empty=empty,
               busiest=int(cnt.max(2).values.sum()),
               nopred=int((adm & (cnt.sum(1) == 0)).sum()))
    for k, v in add.items():
        counts[k] = counts.get(k, 0) + v


def sweep_plain(fplanes, iplanes, extq, extdb, hit_i, hit_f, consts,
                tau: float, *, dropout: int, max_ext: int,
                counts: dict | None = None):
    """Plain PyTorch version of the sweep: the XLA while-loop body of
    priblast_tpu/search/gapped.py:553-692 in the same operation order, as
    a Python loop over the diagonals for the whole batch. The combo
    minimum is a sequential strict-< scan in stems-list order, which keeps
    the first minimum exactly as the reference's stems scan (and the
    left-priority tournament of the TPU kernel) does. `counts`: see
    `count_work`."""
    B, _, ME1, W = fplanes.shape
    dt = fplanes.dtype
    dev = fplanes.device
    RH = dropout + 2
    INF = torch.tensor(float("inf"), dtype=dt, device=dev)
    TAU = torch.tensor(tau, dtype=dt, device=dev)
    # a device-tensor divisor keeps true division on CUDA (a Python-scalar
    # divisor is turned into a multiply by its reciprocal there)
    hundred = torch.tensor(100.0, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    lane = torch.arange(W, device=dev)[None, :]
    maxq, maxd = hit_i[:, 0:1].long(), hit_i[:, 1:2].long()
    valid = hit_i[:, 2] != 0
    obits = hit_i[:, 3]
    energy0, acc0 = hit_f[:, 0], hit_f[:, 1]
    intloop_c = [float(v) for v in consts[0].tolist()]
    bulge_c = [float(v) for v in consts[1].tolist()]
    lane0 = lane == 0

    pred = torch.full((B, ME1, W), -1, dtype=torch.int32, device=dev)
    # windows of the last RH diagonals: row r holds diagonal L - RH + r
    win_h = INF.expand(B, RH, W).clone()
    win_h[:, RH - 1, 0] = torch.where(valid, energy0, INF)
    win_a = torch.zeros((B, RH, W), dtype=torch.bool, device=dev)
    win_a[:, RH - 1, 0] = valid
    mtz_m1 = torch.ones((B, W), dtype=torch.bool, device=dev)
    mtw_m1 = torch.zeros((B, W), dtype=torch.bool, device=dev)
    mtz_0 = torch.where(lane0, (obits[:, None] & 1) != 0, True)
    mtw_0 = torch.where(lane0, (obits[:, None] & 2) != 0, False)

    active = valid.clone()
    ovf = torch.zeros(B, dtype=torch.bool, device=dev)
    min_e, min_a = energy0.clone(), acc0.clone()
    min_i = torch.zeros(B, dtype=torch.int64, device=dev)
    min_j = torch.zeros_like(min_i)
    min_len = torch.zeros_like(min_i)
    n_diag = torch.zeros_like(min_i)
    extq_i = extq[:, :W]
    XW = extq.shape[1]
    ME1v = max_ext + 1
    BIG = RH * W

    def plane_rows(L):
        # VM / bit rows of diagonals L - RH .. L - 1 (zero below 0)
        lo = L - RH
        vm = torch.zeros((B, RH, W), dtype=dt, device=dev)
        bits = torch.zeros((B, RH, W), dtype=torch.int32, device=dev)
        r0 = max(0, -lo)
        vm[:, r0:] = fplanes[:, VM, lo + r0: L]
        bits[:, r0:] = iplanes[:, lo + r0: L]
        return vm, bits

    for L in range(1, max_ext + 1):
        if not bool(active.any()):
            break
        n_diag = torch.where(active, L, n_diag)
        bits_c = iplanes[:, L]
        nz0 = (bits_c & NZ0) != 0
        w0 = (bits_c & W0) != 0
        au0 = (bits_c & AU0) != 0
        badr = (bits_c & BAD) != 0
        ms = fplanes[:, MS, L]
        li = L - lane
        extdb_j = torch.where(li >= 0, extdb.gather(1, li.clamp(0, XW - 1)
                                                    .expand(B, W)), INF)
        vm_w, bits_w = plane_rows(L)
        zw_w = (((bits_w & NZ0) == 0).int() * 16384
                + ((bits_w & W0) != 0).int() * 32768)
        au_w = (bits_w & AU0) != 0

        # stems[0] fallback bits: first admitted cell in (diag, k) order
        # over the window (reference gapped_extension.cpp:230-258)
        code = torch.where(win_a.reshape(B, -1),
                           torch.arange(RH * W, device=dev), BIG)
        first = code.min(1).values
        any_adm = first < BIG
        s0 = bits_w.reshape(B, -1).gather(
            1, first.clamp(max=BIG - 1)[:, None])[:, 0]
        stem0_z = torch.where(any_adm, (s0 & NZ0) == 0, True)
        stem0_w = torch.where(any_adm, (s0 & W0) != 0, False)

        # helix/wobble admission (reference: gapped_extension.cpp:342-364)
        prev_z = _shift_lanes(mtz_m1, 1, True)
        prev_w = _shift_lanes(mtw_m1, 1, False)
        gate = prev_z | (w0 & prev_w)
        cellmask = (active[:, None] & (lane >= 1) & (lane <= L - 1)
                    & (lane <= maxq) & (li <= maxd))
        adm_new = cellmask & nz0 & ~(gate & badr)
        if counts is not None:
            count_work(counts, L, active, cellmask, adm_new, win_h, dropout)

        # combo minimum in stems-list order (strict <: first one wins).
        # Non-admitted predecessor cells hold INF in the hyb window.
        au_f = torch.where(au0, TAU, zero)
        base_pk = lane * max_ext + L
        run_min = INF.expand(B, W).clone()
        run_pay = torch.zeros((B, W), dtype=torch.int64, device=dev)
        for s, u1 in combos(dropout):
            u2 = s - u1
            r = dropout - s
            sh = u1 + 1
            ph_sh = _shift_lanes(win_h[:, r], sh, float("inf"))
            if s >= 2 and u1 >= 1 and u2 >= 1 and (u1, u2) not in SPECIAL:
                raw = (ms + intloop_c[s]) + _shift_lanes(vm_w[:, r], sh, 0.0)
                Et = raw / hundred + ph_sh
            elif s >= 2 and (u1 == 0 or u2 == 0):
                au_p = torch.where(_shift_lanes(au_w[:, r], sh, False),
                                   TAU, zero)
                Et = (au_f + bulge_c[s] + au_p) / hundred + ph_sh
            else:
                Et = fplanes[:, SPECIAL[(u1, u2)], L] + ph_sh
            pay = (_shift_lanes(zw_w[:, r], sh, 0)
                   + (base_pk - ((u1 + 1) * ME1v + u2 + 1)))
            better = Et < run_min
            run_min = torch.where(better, Et, run_min)
            run_pay = torch.where(better, pay, run_pay)

        hyb = run_min
        nopred = torch.isinf(hyb)
        pay = run_pay.clamp(min=0)
        mtz_c = torch.where(nopred, stem0_z[:, None], (pay & 16384) != 0)
        mtw_c = torch.where(nopred, stem0_w[:, None], (pay & 32768) != 0)
        packed = torch.where(nopred, 0, pay & 16383)

        hyb_row = torch.where(adm_new, hyb, INF)
        pred[:, L] = torch.where(adm_new, packed, -1).int()
        mtz_row = torch.where(adm_new, mtz_c, True)
        mtw_row = torch.where(adm_new, mtw_c, False)

        # running minimum (reference: gapped_extension.cpp:259-276)
        inter = torch.where(adm_new, extq_i + extdb_j + hyb, INF)
        dmin = inter.min(1).values
        darg = torch.where(inter == dmin[:, None], lane, W).min(1).values
        improve = active & (dmin < min_e)
        min_e = torch.where(improve, dmin, min_e)
        min_i = torch.where(improve, darg, min_i)
        min_j = torch.where(improve, L - darg, min_j)
        min_len = torch.where(improve, L, min_len)
        acc_new = (acc0 + extq.gather(1, darg[:, None])[:, 0]
                   + extdb.gather(1, (L - darg).clamp(0, XW - 1)[:, None])
                   [:, 0])
        min_a = torch.where(improve, acc_new, min_a)

        # termination (reference: gapped_extension.cpp:292-297)
        stop = (L - min_len >= dropout) | ((L > maxq[:, 0]) & (L > maxd[:, 0]))
        ovf = ovf | (active & ~stop & (L >= max_ext))
        active = active & ~stop & (L < max_ext)

        win_h = torch.cat([win_h[:, 1:], hyb_row[:, None]], 1)
        win_a = torch.cat([win_a[:, 1:], adm_new[:, None]], 1)
        mtz_m1, mtw_m1 = mtz_0, mtw_0
        mtz_0, mtw_0 = mtz_row, mtw_row

    ints = torch.stack([min_i, min_j, min_len, ovf.long(), n_diag],
                       1).int()
    floats = torch.stack([min_e, min_a], 1)
    return pred, ints, floats

