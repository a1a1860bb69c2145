"""The accessibility DP's column scans: two hand-written CUDA kernels for
Hopper, one CTA per sequence with the carry in shared memory, and their
wrappers.

- `inside_scan` (csrc/access_inside.cu) computes
  accessibility/batched.py:inside_pass and then b_outer_scan; it replaces
  the JAX package's XLA programs priblast_tpu/accessibility/batched.py:
  inside_pass (:588) and b_outer_scan (:1067).
- `outside_scan` (csrc/access_outside.cu) computes
  accessibility/batched.py:outside_pass; it replaces
  priblast_tpu/accessibility/batched.py:outside_pass (:926).

On CUDA tensors each launches its kernel (a failed build or launch
raises); on CPU tensors each calls its plain version, `inside_plain` or
`outside_plain` (the loops of accessibility/batched.py, which run on any
device), which the kernels match up to the order of their sums.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from priblast_tpu_torch.accessibility import batched as ab
from priblast_tpu_torch.ops import nvcc

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
SRC_INSIDE = _CSRC / "access_inside.cu"
SRC_OUTSIDE = _CSRC / "access_outside.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
# threads per CTA (one CTA per sequence) of the inside kernel, the fastest
# of 256, 512, 768 and 1024 on the H100, and of the outside kernel, the
# fastest of 512, 768 and 1024 (access_ab.py; PERF.md)
THREADS = 768
OUTSIDE_THREADS = 768

inside_launches = 0   # kernel launches by inside_scan(); plain calls not counted
outside_launches = 0  # kernel launches by outside_scan()

_BOOL_GRIDS = ("t1_nz", "validC", "t2_nz", "valid_int")


def build_inside() -> Path:
    """Compile csrc/access_inside.cu into build/kernels/ with nvcc (once per
    source version)."""
    return nvcc.build(SRC_INSIDE, NVCC_FLAGS)


def build_outside() -> Path:
    """Compile csrc/access_outside.cu into build/kernels/ with nvcc."""
    return nvcc.build(SRC_OUTSIDE, NVCC_FLAGS)


@functools.lru_cache(maxsize=2)
def _lib(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str({"inside": build_inside,
                           "outside": build_outside}[name]()))
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"access_{name}_{dt}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4
        fn = getattr(lib, f"access_{name}_slots_{dt}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
    return lib


def _fn(name: str, dtype):
    dt = "f64" if dtype == torch.float64 else "f32"
    return getattr(_lib(name), f"access_{name}_{dt}")


@functools.lru_cache(maxsize=None)
def slots(device, dtype, band: int) -> int:
    """The CTAs of both scan kernels that the card `device` holds at once
    at their threads per CTA and the shared memory of `band` in `dtype`:
    the lesser of the two kernels' counts (SMs x CTAs per SM). Read once
    per card, dtype and band."""
    dt = "f64" if dtype == torch.float64 else "f32"
    counts = []
    with torch.cuda.device(device):
        for name, threads in (("inside", THREADS),
                              ("outside", OUTSIDE_THREADS)):
            sizes = (ctypes.c_longlong * 3)(band, ab.ML, threads)
            n = getattr(_lib(name), f"access_{name}_slots_{dt}")(sizes)
            if n <= 0:
                raise RuntimeError(
                    f"access_{name} on {device}: "
                    + (f"CUDA error {-n}" if n else "no CTA fits an SM"))
            counts.append(n)
    return min(counts)


def _check_grids(grids, shape, dtype, device) -> None:
    for name, x in grids._asdict().items():
        nvcc.check_tensor(x, name, shape,
                          torch.bool if name in _BOOL_GRIDS else dtype,
                          device)


def _check_tables(t: ab.Tables, band: int, dtype, device) -> None:
    R = ab.ML + 1
    nvcc.check_tensor(t.K2, "K2", (R, R), dtype, device)
    nvcc.check_tensor(t.Kb, "Kb", (R,), dtype, device)
    nvcc.check_tensor(t.Lmat, "Lmat", (band, band), dtype, device)


def _check_lengths(lengths, n_max: int, B: int, device,
                   checked: bool = False) -> None:
    """Raise ValueError unless `lengths` is a [B] int64 tensor on `device`
    whose values lie in [0, n_max]. The values are read from the device
    (one read, which on a card waits for its queue to drain) unless the
    caller has `checked` them on the host."""
    nvcc.check_tensor(lengths, "lengths", (B,), torch.int64, device)
    if B and not checked:
        lo, hi = torch.stack(torch.aminmax(lengths)).tolist()
        if lo < 0 or hi > n_max:
            raise ValueError(f"lengths must lie in [0, {n_max}]")


def _scalars(t: ab.Tables, dtype):
    """sigma^-2, W_mlb sigma^-1 and W_mli in the working dtype, as the
    plain versions form them."""
    npdt = ab._npdt(dtype)
    sig1 = npdt(np.exp(-t.lsig))
    return (float(npdt(np.exp(-2 * t.lsig))), float(npdt(t.W_mlb) * sig1),
            float(npdt(t.W_mli)))


def _launch(fn, ptrs, n1: int, B: int, band: int, threads: int, scalars,
            stream, name: str) -> None:
    sizes = (n1, B, band, ab.ML, threads)
    err = fn((ctypes.c_void_p * len(ptrs))(*ptrs),
             (ctypes.c_longlong * len(sizes))(*sizes),
             (ctypes.c_double * len(scalars))(*scalars), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def inside_plain(t: ab.Tables, g: ab.Grids, lengths: torch.Tensor,
                 n_max: int, band: int, dtype):
    """The plain version of `inside_scan`: inside_pass, then
    b_outer_scan."""
    B = g.stackW.shape[1]
    ins = ab.inside_pass(t, g, n_max, band, B, dtype)
    return (*ins, ab.b_outer_scan(ins[0], g.ext_dot, n_max, band, B, dtype,
                                  lengths))


def outside_plain(t: ab.Tables, og: ab.OutsideGrids, multi1_full,
                  n_max: int, band: int, dtype):
    """The plain version of `outside_scan`: outside_pass."""
    return ab.outside_pass(t, og, multi1_full, n_max, band, og.seed.shape[1],
                           dtype)


def inside_scan(t: ab.Tables, g: ab.Grids, lengths: torch.Tensor,
                n_max: int, band: int, dtype, *, checked: bool = False):
    """The inside pass and both exterior scans of a batch: (stem, stem_m,
    stem_a, multi, multi1, multi2, A_full, B_full), as `inside_plain`.
    Grids [N+1, B, band] contiguous (t1_nz and validC bool), lengths [B]
    int64 in [0, n_max]; `checked`: the caller has checked their range on
    the host, so none is read from the device."""
    dev = g.stackW.device
    B = g.stackW.shape[1] if g.stackW.dim() == 3 else 0
    _check_grids(g, (n_max + 1, B, band), dtype, dev)
    _check_tables(t, band, dtype, dev)
    _check_lengths(lengths, n_max, B, dev, checked)
    if dev.type == "cpu":
        return inside_plain(t, g, lengths, n_max, band, dtype)
    if dev.type != "cuda":
        raise ValueError(f"inside_scan runs on cuda or cpu, not {dev}")
    with torch.cuda.device(dev):
        out = _inside_call(_fn("inside", dtype), t, g, lengths, n_max, band,
                           dtype, torch.cuda.current_stream(dev).cuda_stream)
    # an empty batch launches nothing
    nvcc.add_launches(globals(), "inside_launches", int(B > 0))
    return out


def _inside_call(fn, t, g, lengths, n_max: int, band: int, dtype, stream,
                 threads: int = THREADS):
    """Allocate the outputs and call the C entry point of
    csrc/access_inside.cu (`fn`) on checked arguments on `stream`."""
    dev = g.stackW.device
    B = g.stackW.shape[1]
    planes = torch.empty((6, n_max + 1, B, band), dtype=dtype, device=dev)
    ab_out = torch.empty((2, n_max + 1, B), dtype=dtype, device=dev)
    lrow = t.Lmat[0].contiguous()
    ptrs = (*(x.data_ptr() for x in g), t.K2.data_ptr(), t.Kb.data_ptr(),
            lrow.data_ptr(), lengths.data_ptr(),
            *(x.data_ptr() for x in planes), *(x.data_ptr() for x in ab_out))
    _launch(fn, ptrs, n_max + 1, B, band, threads, _scalars(t, dtype),
            stream, "access_inside")
    return (*planes, *ab_out)


def outside_scan(t: ab.Tables, og: ab.OutsideGrids, multi1_full,
                 n_max: int, band: int, dtype):
    """The outside pass of a batch: (bse, bse_m, bse_a, b_multi, b_multi2),
    as `outside_pass`. Grids and multi1_full [N+1, B, band] contiguous
    (t2_nz and valid_int bool)."""
    dev = og.seed.device
    B = og.seed.shape[1] if og.seed.dim() == 3 else 0
    shape = (n_max + 1, B, band)
    _check_grids(og, shape, dtype, dev)
    nvcc.check_tensor(multi1_full, "multi1", shape, dtype, dev)
    _check_tables(t, band, dtype, dev)
    if dev.type == "cpu":
        return outside_plain(t, og, multi1_full, n_max, band, dtype)
    if dev.type != "cuda":
        raise ValueError(f"outside_scan runs on cuda or cpu, not {dev}")
    with torch.cuda.device(dev):
        out = _outside_call(_fn("outside", dtype), t, og, multi1_full, n_max,
                            band, dtype,
                            torch.cuda.current_stream(dev).cuda_stream)
    nvcc.add_launches(globals(), "outside_launches", int(B > 0))
    return out


def _outside_call(fn, t, og, multi1_full, n_max: int, band: int, dtype,
                  stream, threads: int = OUTSIDE_THREADS):
    """Allocate the outputs and call the C entry point of
    csrc/access_outside.cu (`fn`) on checked arguments on `stream`."""
    dev = og.seed.device
    B = og.seed.shape[1]
    planes = torch.empty((5, n_max + 1, B, band), dtype=dtype, device=dev)
    lrow = t.Lmat[0].contiguous()  # (W_mlb sigma^-1)^k, as LmatU[k, 0]
    sig2, mlb_sig1, w_mli = _scalars(t, dtype)
    ptrs = (*(x.data_ptr() for x in og), multi1_full.data_ptr(),
            t.K2.data_ptr(), t.Kb.data_ptr(), lrow.data_ptr(),
            *(x.data_ptr() for x in planes))
    _launch(fn, ptrs, n_max + 1, B, band, threads, (sig2, mlb_sig1, w_mli),
            stream, "access_outside")
    return tuple(planes)
