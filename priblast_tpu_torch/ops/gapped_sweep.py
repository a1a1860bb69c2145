"""The gapped-extension diagonal sweep: a hand-written CUDA kernel for
Hopper (csrc/gapped_sweep.cu) and its plain PyTorch version.

Replaces the TPU Pallas kernel ``_sweep_kernel``
(priblast_tpu/search/gapped_pl.py:51, launched by ``pallas_sweep`` at
gapped_pl.py:337). It computes, per hit and for L = 1..max_ext, the banded
anti-diagonal gapped-extension DP of the reference
(src/gapped_extension.cpp:213-319): every cell (i, L-i) takes the minimum
over the (dropout+1)(dropout+2)/2 predecessor offsets (u1, u2) in the
reference's stems-list order (first occurrence wins on ties) of
predecessor hyb + loop energy, then helix/wobble admission, the running
minimum of extq + extdb + hyb with its argmin, dropout/boundary stop and
the overflow flag at max_ext. It emits the packed predecessor rows that
the traceback walks.

Inputs (hit-major; W = max_ext lanes, one per cell i of a diagonal; the
plane row of diagonal D holds cell (i, D - i) at lane i):
  fplanes [B, 9, max_ext+1, W] float: MS, STK00, STK10, STK01, V11, V12,
          V21, V22 (the specials already /100) and VM, per diagonal row;
  iplanes [B, max_ext+1, W] int32 bits: 1 cell pair type != 0, 2 wobble,
          4 terminal-AU, 8 helix badness;
  extq, extdb [B, XW] float prefix accessibility chains;
  hit_i [B, 4] int32: maxq, maxd, valid, origin bits (1 type 0, 2 wobble);
  hit_f [B, 2] float: energy0, acc0;
  consts [2, dropout+1] float: interior-loop and bulge constants per size.
Outputs: pred [B, max_ext+1, W] int32 (-1 where no cell), ints [B, 5]
int32 (min_i, min_j, min_len, overflow, diagonals swept), floats [B, 2]
(min_e, min_a).

On this card the kernel is bound by memory: per hit and diagonal it
streams 9 float plane rows and one bit row in and one predecessor row out,
against ~5 operations per (cell, combo) on values in shared memory. One
thread block per hit, one thread per cell; the rings of the last dropout+2
diagonals (hyb, admission, VM, ZW, AU) and the predecessor-type bits live
in shared memory, so a diagonal reads no device memory besides its own
plane rows. The diagonal loop runs inside the block (blocks run in no
order, so nothing carries across them).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

# float plane layout (search/gapped.py fills it, the kernel reads it with
# the same numbers in csrc/gapped_sweep.cu): MS, the loop energy of each
# special (u1, u2) offset, VM
N_FPLANES = 9
MS, VM = 0, 8
SPECIAL = {(0, 0): 1, (1, 0): 2, (0, 1): 3, (1, 1): 4, (1, 2): 5,
           (2, 1): 6, (2, 2): 7}
NZ0, W0, AU0, BAD = 1, 2, 4, 8

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "gapped_sweep.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

launches = 0  # kernel launches by gapped_sweep(); plain calls not counted


def combos(dropout: int):
    """(s, u1) predecessor offsets in the reference's stems-list order."""
    return [(s, u1) for s in range(dropout, -1, -1)
            for u1 in range(s, -1, -1)]


def build() -> Path:
    """Compile csrc/gapped_sweep.cu into build/kernels/ with nvcc (once per
    source version)."""
    tag = hashlib.sha256(_SRC.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libgapped_sweep_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        tmp = Path(td) / out.name
        r = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_SRC}:\n{r.stderr}")
        tmp.replace(out)
    return out


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("gapped_sweep_f32", "gapped_sweep_f64"):
        fn = getattr(lib, name)
        fn.restype = i32
        fn.argtypes = [vp] * 10 + [i32] * 4 + [ctypes.c_double, vp]
    return lib


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def gapped_sweep(fplanes, iplanes, extq, extdb, hit_i, hit_f, consts,
                 tau: float, *, dropout: int, max_ext: int):
    """Run the sweep: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. Returns (pred, ints, floats); see the module doc."""
    B, _, ME1, W = fplanes.shape
    dt = fplanes.dtype
    dev = fplanes.device
    XW = extq.shape[1]
    if W != max_ext or ME1 != max_ext + 1 or not 1 <= max_ext <= 120:
        raise ValueError(f"bad sweep shape W={W} max_ext={max_ext}")
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dt}")
    for t, name, shape, tdt in (
            (fplanes, "fplanes", (B, N_FPLANES, ME1, W), dt),
            (iplanes, "iplanes", (B, ME1, W), torch.int32),
            (extq, "extq", (B, XW), dt), (extdb, "extdb", (B, XW), dt),
            (hit_i, "hit_i", (B, 4), torch.int32),
            (hit_f, "hit_f", (B, 2), dt),
            (consts, "consts", (2, dropout + 1), dt)):
        _check(t, name, shape, tdt, dev)
    if XW <= max_ext:
        raise ValueError("extq/extdb must cover max_ext + 1 offsets")
    if dev.type == "cpu":
        return sweep_plain(fplanes, iplanes, extq, extdb, hit_i, hit_f,
                           consts, tau, dropout=dropout, max_ext=max_ext)
    if dev.type != "cuda":
        raise ValueError(f"gapped_sweep runs on cuda or cpu, not {dev}")

    global launches
    pred = torch.full((B, ME1, W), -1, dtype=torch.int32, device=dev)
    ints = torch.empty((B, 5), dtype=torch.int32, device=dev)
    floats = torch.empty((B, 2), dtype=dt, device=dev)
    if B == 0:
        return pred, ints, floats
    fn = (_lib().gapped_sweep_f32 if dt == torch.float32
          else _lib().gapped_sweep_f64)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in (
            fplanes, iplanes, extq, extdb, hit_i, hit_f, consts, pred, ints,
            floats)), B, dropout, max_ext, XW, float(tau), stream)
    if err != 0:
        raise RuntimeError(f"gapped_sweep kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return pred, ints, floats


def _shift_lanes(x, sh: int, fill):
    """Lane i reads the value lane i - sh held; `fill` for i < sh."""
    if sh == 0:
        return x
    W = x.shape[-1]
    out = torch.full_like(x, fill)
    if sh < W:
        out[..., sh:] = x[..., : W - sh]
    return out


def sweep_plain(fplanes, iplanes, extq, extdb, hit_i, hit_f, consts,
                tau: float, *, dropout: int, max_ext: int):
    """Plain PyTorch version of the sweep: the XLA while-loop body of
    priblast_tpu/search/gapped.py:553-692 in the same operation order, as
    a Python loop over the diagonals for the whole batch. The combo
    minimum is a sequential strict-< scan in stems-list order, which keeps
    the first minimum exactly as the reference's stems scan (and the
    left-priority tournament of the TPU kernel) does."""
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

