"""The accessibility DP's weight grids: a hand-written CUDA source for Hopper
(csrc/access_grids.cu, two launches) and its wrapper.

- `inside_grids` computes accessibility/batched.py:make_grids, the 17
  planes of `Grids`; it replaces the JAX package's XLA program
  priblast_tpu/accessibility/batched.py:make_grids (:372).
- `outside_grids` computes accessibility/batched.py:make_outside_grids,
  the planes of `OutsideGrids` (dangle_pq is the inside grids'
  dangle_ij, not written twice); it replaces
  priblast_tpu/accessibility/batched.py:make_outside_grids (:741).

On CUDA tensors each launches its kernel (a failed build or launch
raises); on CPU tensors each calls its plain version, which the kernels
match bit for bit, but for the seed plane's exp.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import numpy as np
import torch

from priblast_tpu_torch.accessibility import batched as ab
from priblast_tpu_torch.ops import access_scan, nvcc

SRC = Path(__file__).resolve().parents[1] / "csrc" / "access_grids.cu"
THREADS = 256  # threads per CTA of both launches
TILE = 16      # the outside launch's columns per CTA (a CTA per row and
               # tile); the inside launch runs a thread per cell

inside_grids_launches = 0   # kernel launches by inside_grids(); plain calls
outside_grids_launches = 0  # and empty batches not counted

# the float planes each launch writes, in the kernels' order (the fields'
# own, less the bool planes and, outside, dangle_pq)
_INSIDE_F = tuple(f for f in ab.Grids._fields if f not in ("t1_nz",
                                                           "validC"))
_OUTSIDE_F = tuple(f for f in ab.OutsideGrids._fields
                   if f not in ("t2_nz", "dangle_pq", "valid_int"))


def build() -> Path:
    """Compile csrc/access_grids.cu into build/kernels/ with nvcc, with the
    scan kernels' flags (-fmad=false among them)."""
    return nvcc.build(SRC, access_scan.NVCC_FLAGS)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for side in ("inside", "outside"):
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"access_grids_{side}_{dt}")
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 4
    return lib


def _fn(side: str, dtype):
    dt = "f64" if dtype == torch.float64 else "f32"
    return getattr(_lib(), f"access_grids_{side}_{dt}")


@functools.lru_cache(maxsize=16)
def _tables(w_span: int, device):
    """The kernels' tables on `device`, the same for both dtypes: bp and
    rtype[bp] (int32); the float32 stack, mismatch, int11, int21, int22,
    dangle (first 7 pair types) and AU tables of batched._F32Tables; the
    hairpin grid's float32 length weight times sigma^-d and the float32
    sigma^d of ext_dot, per span of the band."""
    lm = ab._linmodel(w_span)
    band = w_span + 2
    bp = np.asarray(lm.bp, np.int32)
    hp_len = np.asarray(lm.W_hairpin_len)[
        np.clip(np.arange(band), 0, len(lm.W_hairpin_len) - 1)]
    inv_sig = np.asarray(lm.inv_sig_pow)[:band]

    def f(x, dt=np.float32):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(x, dt)
                                                    .reshape(-1)),
                               device=device)

    return (f(bp, np.int32), f(np.asarray(lm.rtype)[bp], np.int32),
            f(lm.W_stack), f(lm.W_mism_i), f(lm.W_mism_h), f(lm.W_int11),
            f(lm.W_int21), f(lm.W_int22), f(np.asarray(lm.W_dangle5)[:7]),
            f(np.asarray(lm.W_dangle3)[:7]), f(lm.W_au),
            f((hp_len * inv_sig).astype(np.float32)),
            f(np.asarray(lm.sig_pow)[:band]))


@functools.lru_cache(maxsize=16)
def _scalars(w_span: int, dtype):
    """sigma^-1 .. sigma^-4, each rounded to the dtype as the plain
    versions round it; the float32 bulge weight of one unpaired base,
    W_mlc W_mli and log sigma."""
    lm = ab._linmodel(w_span)
    npdt = ab._npdt(dtype)
    return (*(float(npdt(np.exp(-k * lm.lsig))) for k in (1, 2, 3, 4)),
            float(np.float32(lm.W_bulge_len[1])),
            float(np.float32(lm.W_mlc * lm.W_mli)),
            float(np.float32(lm.lsig)))


def _check(s_padded, lengths, n_max: int, band: int, checked: bool):
    if not isinstance(s_padded, torch.Tensor) or s_padded.dim() != 2:
        raise ValueError("s_padded must be a [B, S] tensor")
    dev = s_padded.device
    B = s_padded.shape[0]
    if band < 3:
        raise ValueError(f"the band must span at least 3, not {band}")
    nvcc.check_tensor(s_padded, "s_padded", (B, s_padded.shape[1]),
                      torch.int64, dev)
    access_scan._check_lengths(lengths, n_max, B, dev, checked)
    return dev, B


def inside_grids(t: ab.Tables, s_padded, lengths, n_max: int, band: int,
                 dtype, *, checked: bool = False) -> ab.Grids:
    """The inside weight grids of a batch, as make_grids: s_padded [B, S]
    int64 codes (1-based, zero padded), lengths [B] int64 in [0, n_max];
    `checked`: the caller has checked their range on the host, so none is
    read from the device."""
    dev, B = _check(s_padded, lengths, n_max, band, checked)
    if dev.type == "cpu":
        return ab.make_grids(t, s_padded, lengths, n_max, band, dtype)
    if dev.type != "cuda":
        raise ValueError(f"inside_grids runs on cuda or cpu, not {dev}")
    with torch.cuda.device(dev):
        out = _grids_call(_fn("inside", dtype), s_padded, lengths, n_max,
                          band, dtype,
                          torch.cuda.current_stream(dev).cuda_stream)
    # an empty batch launches nothing
    nvcc.add_launches(globals(), "inside_grids_launches", int(B > 0))
    return out


def outside_grids(t: ab.Tables, s_padded, lengths, n_max: int, band: int,
                  dtype, g: ab.Grids, multi2_full, A_full, B_full, logZ, *,
                  checked: bool = False) -> ab.OutsideGrids:
    """The outside weight grids of a batch, as make_outside_grids, from the
    inside grids `g` (their dangle_ij becomes dangle_pq) and the inside
    scan's multi2 [N+1, B, band], A and B [N+1, B] and logZ [B], all
    contiguous in `dtype`; `checked` as for inside_grids."""
    dev, B = _check(s_padded, lengths, n_max, band, checked)
    n1 = n_max + 1
    nvcc.check_tensor(g.dangle_ij, "dangle_ij", (n1, B, band), dtype, dev)
    nvcc.check_tensor(multi2_full, "multi2", (n1, B, band), dtype, dev)
    for name, x in (("A_full", A_full), ("B_full", B_full)):
        nvcc.check_tensor(x, name, (n1, B), dtype, dev)
    nvcc.check_tensor(logZ, "logZ", (B,), dtype, dev)
    if dev.type == "cpu":
        return ab.make_outside_grids(t, s_padded, lengths, n_max, band,
                                     dtype, g, multi2_full, A_full, B_full,
                                     logZ)
    if dev.type != "cuda":
        raise ValueError(f"outside_grids runs on cuda or cpu, not {dev}")
    with torch.cuda.device(dev):
        out = _grids_call(_fn("outside", dtype), s_padded, lengths, n_max,
                          band, dtype,
                          torch.cuda.current_stream(dev).cuda_stream,
                          outside=(g, A_full, B_full, logZ, multi2_full))
    nvcc.add_launches(globals(), "outside_grids_launches", int(B > 0))
    return out


def _grids_call(fn, s_padded, lengths, n_max: int, band: int, dtype, stream,
                outside=None, threads: int = THREADS, blocks: int = 0,
                tile: int = TILE):
    """Allocate the planes and call a C entry point of csrc/access_grids.cu
    (`fn`) on checked arguments on `stream`: the inside launch (`blocks`
    CTAs of `threads`; 0 gives a thread per cell, fewer stride over the
    cells), or, with `outside` = (g, A, B, logZ, multi2), the outside one
    (a CTA of `threads` per row and `tile` columns)."""
    dev = s_padded.device
    B = s_padded.shape[0]
    shape = (n_max + 1, B, band)
    names = _INSIDE_F if outside is None else _OUTSIDE_F
    planes = torch.empty((len(names), *shape), dtype=dtype, device=dev)
    flags = torch.empty((2, *shape), dtype=torch.bool, device=dev)
    extra = () if outside is None else tuple(x.data_ptr()
                                             for x in outside[1:])
    # each plane's address from its buffer's: a view per plane costs
    # microseconds of host time, as many as the launch
    cells = math.prod(shape)
    p0, f0, item = planes.data_ptr(), flags.data_ptr(), planes.element_size()
    ptrs = (s_padded.data_ptr(), lengths.data_ptr(),
            *(x.data_ptr() for x in _tables(band - 2, dev)), *extra,
            *(p0 + k * cells * item for k in range(len(names))),
            f0, f0 + cells)
    sizes = (n_max + 1, B, band, s_padded.shape[1], threads, blocks, tile)
    scalars = _scalars(band - 2, dtype)
    err = fn((ctypes.c_void_p * len(ptrs))(*ptrs),
             (ctypes.c_longlong * len(sizes))(*sizes),
             (ctypes.c_double * len(scalars))(*scalars), stream)
    if err != 0:
        raise RuntimeError(f"access_grids kernel launch failed: CUDA error "
                           f"{err}")
    out = dict(zip(names, planes.unbind(0)))
    m0, m1 = flags.unbind(0)
    if outside is None:
        return ab.Grids(t1_nz=m0, validC=m1, **out)
    return ab.OutsideGrids(t2_nz=m0, dangle_pq=outside[0].dangle_ij,
                           valid_int=m1, **out)
