"""The fused stage's expansion and threshold: a hand-written CUDA source for
Hopper (csrc/fused_expand.cu: a thread per candidate pair, an
order-preserving compaction without atomics, the threshold packed into one
buffer) and its wrappers.

Replaces the JAX package's XLA programs priblast_tpu/search/fused.py:
_expand_core (:102) and _thresh_core (:245).

`expand` takes the arguments of search/fused.py:_expand_core and returns
the same dict (the survivors' int64 columns, acc_e and hyb_e in float64,
the pair id), reading back one number, the survivors' count. `threshold`
takes those of _thresh_core and returns the same host dict, from one
packed device buffer copied to the host in one copy; it reads back the
kept hits' count before the copy. On CUDA tensors they launch the
kernels; on CPU tensors they call _expand_core and _thresh_core, the
plain versions, which the kernels match bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from priblast_tpu_torch.ops import nvcc
from priblast_tpu_torch.ops import ungapped_extend as uop

SRC = Path(__file__).resolve().parents[1] / "csrc" / "fused_expand.cu"
NVCC_FLAGS = uop.NVCC_FLAGS
THREADS = 256  # threads per CTA: a tile of pairs (or hits)
MAX_BLOCK = 1 << 23  # pairs of a block: the kernels' 32-bit indices

expand_launches = 0  # expansions launched by expand(); plain calls not counted
threshold_launches = 0  # the same for threshold()

# the survivors' int64 columns, in the kernel's row order, then its float64
# ones: _expand_core's keys in its order
COLS = ("pid", "q_sp", "db_sp", "length", "dbseq_id", "dbseq_start", "qb",
        "qab", "dbb", "aoff", "coff")
FLOATS = ("acc_e", "hyb_e")
# a packed record: pid (int64), then these as int32, then FLOAT_KEYS as
# float32
PACKED_INTS = (*uop.INT_KEYS, "dbseq_id")
RECORD_BYTES = 8 + 4 * len(PACKED_INTS) + 4 * len(uop.FLOAT_KEYS)


def build() -> Path:
    """Compile csrc/fused_expand.cu into build/kernels/ with nvcc, with the
    ungapped kernel's flags (-fmad=false among them)."""
    return nvcc.build(SRC, NVCC_FLAGS)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entry points' types on a library built from the source."""
    for name in ("fused_expand", "fused_threshold"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4
    return lib


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    return bind(ctypes.CDLL(str(build())))


def _plain():
    # imported here: search/fused.py imports this module
    from priblast_tpu_torch.search import fused

    return fused


def _check_expand(d: int, max_len: int, o: int, B: int, wb, qpack, dbpack):
    """Raise ValueError unless the block and the buffers are what the
    kernels take; returns the device."""
    dev = wb.cum.device
    if not 0 <= B <= MAX_BLOCK:
        raise ValueError(f"a block holds 0 to {MAX_BLOCK} pairs, not {B}")
    if o < 0 or o + B > wb.tot:
        raise ValueError(f"pairs {o} .. {o + B} lie outside the wave's "
                         f"{wb.tot}")
    if d < 0 or max_len < 0:
        raise ValueError("d and max_len must not be negative")
    nc = wb.cand.shape[1] if wb.cand.dim() == 2 else -1
    nvcc.check_tensor(wb.cand, "cand", (_plain()._ROWS, nc), torch.int64,
                      dev)
    nvcc.check_tensor(wb.cum, "cum", (nc + 1,), torch.int64, dev)
    nvcc.check_tensor(wb.energy, "energy", (nc,), torch.float64, dev)
    bufs = {"q_sa": (qpack.sa, torch.int64), "db_sa": (dbpack.sa, torch.int64),
            "q_acc": (qpack.bufs[1], torch.float32),
            "q_cond": (qpack.bufs[2], torch.float32),
            "db_acc": (dbpack.bufs[1], torch.float32),
            "db_cond": (dbpack.bufs[2], torch.float32)}
    for name in ("sid", "ls", "aoff", "coff"):
        bufs[f"pos_{name}"] = (getattr(dbpack, f"pos_{name}"), torch.int64)
    for name, (t, dtype) in bufs.items():
        nvcc.check_tensor(t, name, None, dtype, dev)
        if B and t.shape[0] == 0:
            raise ValueError(f"{name} is empty")
    if len({dbpack.pos_ls.shape[0], dbpack.pos_sid.shape[0],
            dbpack.pos_aoff.shape[0], dbpack.pos_coff.shape[0]}) != 1:
        raise ValueError("the position maps differ in length")
    return dev


def expand(d: int, max_len: int, o: int, B: int, wb, qpack, dbpack) -> dict:
    """Pairs o .. o + B - 1 of the wave `wb` -> the hits that pass the
    interaction filter, in pair order, as search/fused.py:_expand_core:
    the kernels for CUDA tensors, _expand_core for CPU tensors."""
    dev = _check_expand(d, max_len, o, B, wb, qpack, dbpack)
    if dev.type == "cpu":
        return _plain()._expand_core(d, max_len, o, B, wb, qpack, dbpack)
    if dev.type != "cuda":
        raise ValueError(f"expand runs on cuda or cpu, not {dev}")
    with torch.cuda.device(dev):
        out = expand_call(_lib(), d, max_len, o, B, wb, qpack, dbpack,
                          torch.cuda.current_stream(dev).cuda_stream)
    # an empty block launches nothing
    nvcc.add_launches(globals(), "expand_launches", int(B > 0))
    return out


def expand_call(lib, d: int, max_len: int, o: int, B: int, wb, qpack,
                dbpack, stream, threads: int = THREADS, grid: int = 0):
    """Call the expansion's C entry point of `lib` on checked arguments on
    `stream`: count and scan, read the survivors' count, then scatter into
    outputs of that size; `grid` CTAs (0: one per tile)."""
    dev = wb.cum.device
    ints = torch.empty((len(COLS), 0), dtype=torch.int64, device=dev)
    floats = torch.empty((len(FLOATS), 0), dtype=torch.float64, device=dev)
    if B:
        tiles = -(-B // threads)
        keep = torch.empty(B, dtype=torch.uint8, device=dev)
        counts = torch.empty(tiles + 1, dtype=torch.int32, device=dev)
        ins = (wb.cum, wb.cand, wb.energy, qpack.sa, dbpack.sa,
               dbpack.pos_sid, dbpack.pos_ls, dbpack.pos_aoff,
               dbpack.pos_coff, qpack.bufs[1], qpack.bufs[2], dbpack.bufs[1],
               dbpack.bufs[2])
        sizes = [wb.cand.shape[1], *(t.shape[0] for t in ins[3:6]),
                 *(t.shape[0] for t in ins[9:]), o, B, d, max_len, threads,
                 grid, 0, 0]
        _expand_fn(lib, (*ins, keep, counts), sizes, stream)
        n = int(counts[tiles])  # the one read before the ungapped kernel
        ints = torch.empty((len(COLS), n), dtype=torch.int64, device=dev)
        floats = torch.empty((len(FLOATS), n), dtype=torch.float64,
                             device=dev)
        if n:
            sizes[-2:] = (1, n)
            _expand_fn(lib, (*ins, keep, counts, ints, floats), sizes, stream)
    return {**dict(zip(COLS, ints)), **dict(zip(FLOATS, floats))}


def _expand_fn(lib, tensors, sizes, stream):
    ptrs = [t.data_ptr() for t in tensors] + [0] * (17 - len(tensors))
    err = lib.fused_expand((ctypes.c_void_p * 17)(*ptrs),
                           (ctypes.c_longlong * len(sizes))(*sizes), None,
                           stream)
    if err != 0:
        raise RuntimeError(f"fused_expand kernel launch failed: CUDA error "
                           f"{err}")


def _check_threshold(res: dict, hits: dict):
    dev = res["q_sp"].device
    n = res["q_sp"].shape[0]
    for k in uop.INT_KEYS:
        nvcc.check_tensor(res[k], k, (n,), torch.int64, dev)
    for k in uop.FLOAT_KEYS:
        nvcc.check_tensor(res[k], k, (n,), torch.float32, dev)
    for k in ("dbseq_id", "pid"):
        nvcc.check_tensor(hits[k], k, (n,), torch.int64, dev)
    if n > MAX_BLOCK:
        raise ValueError(f"{n} hits; a block holds at most {MAX_BLOCK}")
    return dev


def threshold(p, res: dict, hits: dict) -> dict:
    """The extended hits at or below p.interaction_energy_threshold, in
    pair order, on the host, as search/fused.py:_thresh_core: `res` the
    ungapped kernel's output for `hits`, expand's output. The kernels for
    CUDA tensors, _thresh_core for CPU tensors."""
    dev = _check_threshold(res, hits)
    if dev.type == "cpu":
        return _plain()._thresh_core(p, res, hits)
    if dev.type != "cuda":
        raise ValueError(f"threshold runs on cuda or cpu, not {dev}")
    n = res["q_sp"].shape[0]
    with torch.cuda.device(dev):
        out = threshold_call(_lib(), p.interaction_energy_threshold, res,
                             hits, torch.cuda.current_stream(dev).cuda_stream)
    # no hits launch nothing
    nvcc.add_launches(globals(), "threshold_launches", int(n > 0))
    return out


def threshold_launch(lib, thr: float, res: dict, hits: dict, stream,
                     threads: int = THREADS, grid: int = 0):
    """Launch the threshold's count, scan and scatter of `lib` on checked
    arguments on `stream`, reading nothing back: (the packed buffer, sized
    for every hit; the tile counts, the kept hits' count last)."""
    dev = res["q_sp"].device
    n = res["q_sp"].shape[0]
    tiles = -(-n // threads)
    # with no hits the count is the only entry, 0; else the scan writes
    counts = (torch.empty if n else torch.zeros)(tiles + 1, dtype=torch.int32,
                                                 device=dev)
    packed = torch.empty(RECORD_BYTES * n, dtype=torch.uint8, device=dev)
    if n:
        ptrs = (*(res[k].data_ptr() for k in uop.INT_KEYS),
                *(res[k].data_ptr() for k in uop.FLOAT_KEYS),
                hits["dbseq_id"].data_ptr(), hits["pid"].data_ptr(),
                counts.data_ptr(), packed.data_ptr())
        sizes = (n, threads, grid)
        err = lib.fused_threshold((ctypes.c_void_p * len(ptrs))(*ptrs),
                                  (ctypes.c_longlong * len(sizes))(*sizes),
                                  (ctypes.c_double * 1)(thr), stream)
        if err != 0:
            raise RuntimeError(f"fused_threshold kernel launch failed: CUDA "
                               f"error {err}")
    return packed, counts


def threshold_call(lib, thr: float, res: dict, hits: dict, stream,
                   threads: int = THREADS, grid: int = 0) -> dict:
    """threshold_launch, then the kept hits' count read back and their
    records copied to the host in one copy (into pinned memory from a
    card); numpy views of the records."""
    packed, counts = threshold_launch(lib, thr, res, hits, stream, threads,
                                      grid)
    n2 = int(counts[-1])
    host = torch.empty(RECORD_BYTES * n2, dtype=torch.uint8,
                       pin_memory=packed.is_cuda)
    host.copy_(packed[: RECORD_BYTES * n2])
    return unpack(host.numpy(), n2)


def unpack(buf: np.ndarray, n: int) -> dict:
    """_thresh_core's dict as views of `n` packed records (uint8 `buf`)."""
    ints = buf[8 * n: 8 * n + 4 * len(PACKED_INTS) * n].view(np.int32)
    ints = ints.reshape(len(PACKED_INTS), n)
    floats = buf[8 * n + 4 * len(PACKED_INTS) * n:].view(np.float32)
    floats = floats.reshape(len(uop.FLOAT_KEYS), n)
    out = {k: ints[i] for i, k in enumerate(uop.INT_KEYS)}
    out.update(zip(uop.FLOAT_KEYS, floats))
    out["dbseq_id"] = ints[len(uop.INT_KEYS)]
    out["pid"] = buf[: 8 * n].view(np.int64)
    return out
