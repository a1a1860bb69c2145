"""The ungapped extension: a hand-written CUDA kernel for Hopper
(csrc/ungapped_extend.cu: a thread per hit, the values of a step carried
to the next, 32-bit positions, each step's loads issued a step ahead) and
its wrapper.

Replaces the JAX package's XLA programs for this step:
priblast_tpu/search/ungapped.py:ungapped_core (:94) and its windowed form
priblast_tpu/search/uwin.py:ungapped_window (:261), which the fused path
runs with ungapped_core as the tail for lanes the window leaves
unfinished. The kernel runs each hit to its own stop, so it needs neither
the window nor the tail.

`ungapped_extend` takes the arguments of
search/ungapped.py:ungapped_extend_flat and returns the same dict. On CUDA
tensors it launches the kernel; on CPU tensors it calls
`ungapped_extend_flat`, the plain version, which the kernel matches bit for
bit (integers and float32 energies).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path

import torch

from priblast_tpu_torch.ops import nvcc
from priblast_tpu_torch.search.ungapped import _tables, ungapped_extend_flat

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "ungapped_extend.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

launches = 0  # kernel launches by ungapped_extend(); plain calls not counted
# entries of a flat buffer, and hits of a batch, that the kernel's 32-bit
# positions allow (csrc/ungapped_extend.cu: kMaxSize)
MAX_ENTRIES = 1 << 30

INT_KEYS = ("q_sp", "db_sp", "q_len", "db_len", "dbseq_start")
FLOAT_KEYS = ("acc_e", "hyb_e", "energy")
# the kernel's integer output rows: q_len and db_len are one row
_INT_ROWS = ("q_sp", "db_sp", "q_len", "dbseq_start")
# the tables the kernel reads, in its pointer order, with their sizes
_TABLES = (("bp", 25), ("rtype", 7), ("stack", 49), ("mismI", 175),
           ("intloop", 31), ("i11", 1600), ("i21", 8000), ("i22", 40000))
_COLS = ("q_sp", "db_sp", "length", "dbseq_start", "qb", "qab", "dbb", "aoff",
         "coff")
# the flat buffers, in the kernel's pointer order
_BUFS = ("q_enc", "db_seq", "q_acc", "q_cond", "db_acc", "db_cond")


def check_sizes(B: int, buffer_sizes: dict) -> None:
    """Raise ValueError if the batch (B hits) or a flat buffer
    (buffer_sizes: name -> entries) is larger than the kernel's 32-bit
    positions allow (MAX_ENTRIES). The kernel narrows each hit's 64-bit
    base positions itself, so no column value needs a check."""
    for name, n in (("the batch", B), *buffer_sizes.items()):
        if n > MAX_ENTRIES:
            raise ValueError(f"{name} has {n} entries; the ungapped kernel's "
                             f"32-bit positions allow {MAX_ENTRIES}")


def build() -> Path:
    """Compile csrc/ungapped_extend.cu into build/kernels/ with nvcc (once
    per source version)."""
    return nvcc.build(_SRC, NVCC_FLAGS)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.ungapped_extend.restype = ctypes.c_int
    lib.ungapped_extend.argtypes = [ctypes.c_void_p] * 4
    return lib


_device_tables: dict = {}
_tables_lock = threading.Lock()  # shards of a split stage fill it at once


def _kernel_tables(device):
    key = str(device)
    with _tables_lock:
        if key not in _device_tables:
            t = _tables(device)
            for name, size in _TABLES:
                assert t[name].numel() == size, name
            _device_tables[key] = tuple(t[name].contiguous()
                                        for name, _ in _TABLES)
        return _device_tables[key]


def ungapped_extend(q_sp, db_sp, length, dbseq_start, acc_e, hyb_e, qb, qab,
                    dbb, aoff, coff, bufs, dbufs, d: int, dropout: int):
    """Ungapped extension of a batch of hits over flat buffers: the CUDA
    kernel for CUDA tensors, `ungapped_extend_flat` for CPU tensors.
    Arguments and result as `ungapped_extend_flat` (per-hit columns int64,
    acc_e/hyb_e float32; bufs = (q_enc int64, q_acc, q_cond float32),
    dbufs = (db_seq int64, db_acc, db_cond float32))."""
    dev = q_sp.device
    B = q_sp.shape[0]
    cols = (q_sp, db_sp, length, dbseq_start, qb, qab, dbb, aoff, coff)
    for name, t in zip(_COLS, cols):
        nvcc.check_tensor(t, name, (B,), torch.int64, dev)
    for name, t in (("acc_e", acc_e), ("hyb_e", hyb_e)):
        nvcc.check_tensor(t, name, (B,), torch.float32, dev)
    if len(bufs) != 3 or len(dbufs) != 3:
        raise ValueError("bufs and dbufs each hold three buffers")
    flat = (bufs[0], dbufs[0], bufs[1], bufs[2], dbufs[1], dbufs[2])
    for name, t in zip(_BUFS, flat):
        nvcc.check_tensor(t, name, None, torch.int64 if name in (
            "q_enc", "db_seq") else torch.float32, dev)
        if t.shape[0] == 0:
            raise ValueError(f"{name} is empty")
    check_sizes(B, {name: t.shape[0] for name, t in zip(_BUFS, flat)})
    if dev.type == "cpu":
        return ungapped_extend_flat(q_sp, db_sp, length, dbseq_start, acc_e,
                                    hyb_e, qb, qab, dbb, aoff, coff, bufs,
                                    dbufs, d, dropout)
    if dev.type != "cuda":
        raise ValueError(f"ungapped_extend runs on cuda or cpu, not {dev}")
    with torch.cuda.device(dev):
        out = _call(_lib().ungapped_extend, cols, acc_e, hyb_e, flat,
                    torch.cuda.current_stream(dev).cuda_stream, d, dropout)
    # an empty batch launches nothing
    nvcc.add_launches(globals(), "launches", int(B > 0))
    return out


def _call(fn, cols, acc_e, hyb_e, flat, stream, d: int, dropout: int):
    """Allocate the outputs and call the C entry point of
    csrc/ungapped_extend.cu (`fn`) on checked arguments on `stream`."""
    dev = cols[0].device
    B = cols[0].shape[0]
    ints = torch.empty((len(_INT_ROWS), B), dtype=torch.int64, device=dev)
    floats = torch.empty((len(FLOAT_KEYS), B), dtype=torch.float32,
                         device=dev)
    if B:
        ptrs = (*(t.data_ptr() for t in flat),
                *(t.data_ptr() for t in cols),
                acc_e.data_ptr(), hyb_e.data_ptr(),
                *(t.data_ptr() for t in _kernel_tables(dev)),
                ints.data_ptr(), floats.data_ptr())
        sizes = (*(t.shape[0] for t in flat), B)
        err = fn((ctypes.c_void_p * len(ptrs))(*ptrs),
                 (ctypes.c_longlong * len(sizes))(*sizes),
                 (ctypes.c_int * 2)(d, dropout), stream)
        if err != 0:
            raise RuntimeError(f"ungapped_extend kernel launch failed: CUDA "
                               f"error {err}")
    out = dict(zip(_INT_ROWS, ints))
    out["db_len"] = out["q_len"]
    return {**{k: out[k] for k in INT_KEYS}, **dict(zip(FLOAT_KEYS, floats))}
