"""The fused stage's expansion and threshold: a hand-written CUDA source for
Hopper (csrc/fused_expand.cu: a thread per candidate pair, each block's
order-preserving compaction in one launch with a decoupled look-back, the
threshold's records laid out for a few copies) and its wrappers.

Replaces the JAX package's XLA programs priblast_tpu/search/fused.py:
_expand_core (:102) and _thresh_core (:245).

`expand` takes the arguments of search/fused.py:_expand_core and returns
the same dict (the survivors' int64 columns, acc_e and hyb_e in float64,
the pair id) as views of outputs sized for the whole block, reading back
one number, the survivors' count. `threshold_start` takes those of
_thresh_core, launches the threshold and reads back the kept hits' count;
its `drain` streams the records to the host through a small pinned ring
(two slots, copied on a copy stream after an event on the compute
stream) into HostRecords, pageable arrays that a whole wave's blocks fill
in order, so no host memory is pinned per block. `threshold` does both
for one block and returns _thresh_core's dict. On CUDA tensors they
launch the kernels; on CPU tensors they call _expand_core and
_thresh_core, the plain versions, which the kernels match bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path

import numpy as np
import torch

from priblast_tpu_torch.ops import nvcc
from priblast_tpu_torch.ops import ungapped_extend as uop

SRC = Path(__file__).resolve().parents[1] / "csrc" / "fused_expand.cu"
NVCC_FLAGS = uop.NVCC_FLAGS
# threads per CTA, a tile of pairs or hits (fused_ab.py and chip_smoke.py
# [fused] time the others): small CTAs keep the expansion's warps busier
# across their barriers; the threshold's larger tiles spread its
# look-backs over more hits
EXPAND_THREADS = 128
THRESH_THREADS = 512
MAX_BLOCK = 1 << 23  # pairs of a block: the kernels' 32-bit indices
SCRATCH = 2  # int64 words before the tile states: the tile counter, total

expand_launches = 0  # expansions launched by expand(); plain calls not counted
threshold_launches = 0  # the same for threshold_start()

# the survivors' int64 columns, in the kernel's row order, then its float64
# ones: _expand_core's keys in its order
COLS = ("pid", "q_sp", "db_sp", "length", "dbseq_id", "dbseq_start", "qb",
        "qab", "dbb", "aoff", "coff")
FLOATS = ("acc_e", "hyb_e")
# a record: pid (int64), then these as int32, then FLOAT_KEYS as float32;
# records are laid out by field, each field a row of the records' capacity
PACKED_INTS = (*uop.INT_KEYS, "dbseq_id")
RECORD_BYTES = 8 + 4 * len(PACKED_INTS) + 4 * len(uop.FLOAT_KEYS)
RING_RECORDS = 1 << 16  # records a slot of the pinned ring holds (2.75 MiB)


def build() -> Path:
    """Compile csrc/fused_expand.cu into build/kernels/ with nvcc, with the
    ungapped kernel's flags (-fmad=false among them)."""
    return nvcc.build(SRC, NVCC_FLAGS)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entry points' types on a library built from the source."""
    for name in ("fused_expand", "fused_threshold", "fused_records_to_host",
                 "fused_copy_stream"):
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


def _call(fn, name: str, ptrs, sizes, scalars=None, stream=None):
    """One C entry point of the source on `stream`; raise on its error."""
    err = fn((ctypes.c_void_p * len(ptrs))(*ptrs),
             (ctypes.c_longlong * len(sizes))(*sizes),
             None if scalars is None else
             (ctypes.c_double * len(scalars))(*scalars), stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


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


class PendingHits:
    """A block's expansion launched on its card, until `result` reads the
    survivors' count; on the CPU, the plain version's dict."""

    def __init__(self, plain: dict | None = None, ints=None, floats=None,
                 scratch=None):
        self._plain, self._ints = plain, ints
        self._floats, self._scratch = floats, scratch

    def result(self) -> dict:
        """_expand_core's dict: on a card, views of the first columns of
        the outputs (sized for every pair of the block), each row
        contiguous, after the one read of the survivors' count."""
        if self._plain is not None:
            return self._plain
        n = int(self._scratch[1]) if self._scratch is not None else 0
        return {**{k: self._ints[i, :n] for i, k in enumerate(COLS)},
                **{k: self._floats[i, :n] for i, k in enumerate(FLOATS)}}


def expand_start(d: int, max_len: int, o: int, B: int, wb, qpack,
                 dbpack) -> PendingHits:
    """Pairs o .. o + B - 1 of the wave `wb` -> the hits that pass the
    interaction filter, in pair order, as search/fused.py:_expand_core:
    the kernel launched for CUDA tensors (nothing read back yet),
    _expand_core for CPU tensors."""
    dev = _check_expand(d, max_len, o, B, wb, qpack, dbpack)
    if dev.type == "cpu":
        return PendingHits(plain=_plain()._expand_core(
            d, max_len, o, B, wb, qpack, dbpack))
    if dev.type != "cuda":
        raise ValueError(f"expand runs on cuda or cpu, not {dev}")
    with torch.cuda.device(dev):
        out = expand_launch(_lib(), d, max_len, o, B, wb, qpack, dbpack,
                            torch.cuda.current_stream(dev).cuda_stream)
    # an empty block launches nothing
    nvcc.add_launches(globals(), "expand_launches", int(B > 0))
    return out


def expand(d: int, max_len: int, o: int, B: int, wb, qpack, dbpack) -> dict:
    """expand_start, then its result."""
    return expand_start(d, max_len, o, B, wb, qpack, dbpack).result()


def expand_launch(lib, d: int, max_len: int, o: int, B: int, wb, qpack,
                  dbpack, stream, threads: int = EXPAND_THREADS,
                  grid: int = 0) -> PendingHits:
    """Call the expansion's C entry point of `lib` on checked arguments on
    `stream`: one launch of `grid` CTAs (0: as many as the card holds at
    once; at most one per tile) into outputs sized for every pair of the
    block."""
    dev = wb.cum.device
    ints = torch.empty((len(COLS), B), dtype=torch.int64, device=dev)
    floats = torch.empty((len(FLOATS), B), dtype=torch.float64, device=dev)
    if not B:
        return PendingHits(ints=ints, floats=floats)
    scratch = torch.empty(SCRATCH + -(-B // threads), dtype=torch.int64,
                          device=dev)
    ins = (wb.cum, wb.cand, wb.energy, qpack.sa, dbpack.sa, dbpack.pos_sid,
           dbpack.pos_ls, dbpack.pos_aoff, dbpack.pos_coff, qpack.bufs[1],
           qpack.bufs[2], dbpack.bufs[1], dbpack.bufs[2])
    sizes = (wb.cand.shape[1], *(t.shape[0] for t in ins[3:6]),
             *(t.shape[0] for t in ins[9:]), o, B, d, max_len, threads, grid)
    _call(lib.fused_expand, "fused_expand",
          [t.data_ptr() for t in (*ins, scratch, ints, floats)], sizes,
          stream=stream)
    return PendingHits(ints=ints, floats=floats, scratch=scratch)


def expand_call(lib, d: int, max_len: int, o: int, B: int, wb, qpack,
                dbpack, stream, threads: int = EXPAND_THREADS,
                grid: int = 0) -> dict:
    """expand_launch, then its result."""
    return expand_launch(lib, d, max_len, o, B, wb, qpack, dbpack, stream,
                         threads, grid).result()


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


def threshold_launch(lib, thr: float, res: dict, hits: dict, stream,
                     threads: int = THRESH_THREADS, grid: int = 0):
    """Launch the threshold of `lib` on checked arguments on `stream`
    (one launch; `grid` CTAs, 0: as many as the card holds at once),
    reading nothing back:
    (the records, laid out for every hit; the scratch, which the C entry
    point zeroes and whose word 1 the kernel leaves the kept hits' count
    in)."""
    dev = res["q_sp"].device
    n = res["q_sp"].shape[0]
    # with no hits nothing is launched: the kept count, 0, is the only
    # word read
    scratch = (torch.empty if n else torch.zeros)(
        SCRATCH + -(-n // threads), dtype=torch.int64, device=dev)
    records = torch.empty(RECORD_BYTES * n, dtype=torch.uint8, device=dev)
    if n:
        ptrs = (*(res[k].data_ptr() for k in uop.INT_KEYS),
                *(res[k].data_ptr() for k in uop.FLOAT_KEYS),
                hits["dbseq_id"].data_ptr(), hits["pid"].data_ptr(),
                scratch.data_ptr(), records.data_ptr())
        _call(lib.fused_threshold, "fused_threshold", ptrs,
              (n, threads, grid), (thr,), stream)
    return records, scratch


class HostRecords:
    """Kept records on the host in pageable arrays of `capacity` records,
    filled in order (`put`): pid int64 [capacity], the int32 fields
    [6, capacity], the float32 fields [3, capacity]. Pages are taken only
    where records land, so a wave's arrays may be sized for all its pairs.
    `columns(n)` gives _thresh_core's dict, each column a contiguous view
    of a row."""

    def __init__(self, capacity: int):
        self.pid = np.empty(capacity, np.int64)
        self.ints = np.empty((len(PACKED_INTS), capacity), np.int32)
        self.floats = np.empty((len(uop.FLOAT_KEYS), capacity), np.float32)

    def put(self, rec: dict, at: int) -> None:
        """Records `rec` (_thresh_core's dict) at rows at .. at + len."""
        m = len(rec["pid"])
        self.pid[at: at + m] = rec["pid"]
        for i, k in enumerate(PACKED_INTS):
            self.ints[i, at: at + m] = rec[k]
        for i, k in enumerate(uop.FLOAT_KEYS):
            self.floats[i, at: at + m] = rec[k]

    def put_packed(self, buf: np.ndarray, m: int, at: int) -> None:
        """`m` records laid out for m (uint8 `buf`, as `unpack` reads it)
        at rows at .. at + m: three copies."""
        k = 8 + 4 * len(PACKED_INTS)
        self.pid[at: at + m] = buf[: 8 * m].view(np.int64)
        self.ints[:, at: at + m] = buf[8 * m: k * m].view(np.int32).reshape(
            len(PACKED_INTS), m)
        self.floats[:, at: at + m] = buf[k * m: RECORD_BYTES * m].view(
            np.float32).reshape(len(uop.FLOAT_KEYS), m)

    def columns(self, n: int) -> dict:
        out = {k: self.ints[i, :n] for i, k in enumerate(uop.INT_KEYS)}
        out.update((k, self.floats[i, :n])
                   for i, k in enumerate(uop.FLOAT_KEYS))
        out["dbseq_id"] = self.ints[len(uop.INT_KEYS), :n]
        out["pid"] = self.pid[:n]
        return out


def unpack(buf: np.ndarray, n: int) -> dict:
    """_thresh_core's dict as views of `n` records laid out for n (uint8
    `buf`: pid [n], the int32 fields [6][n], the float32 fields [3][n])."""
    ints = buf[8 * n: 8 * n + 4 * len(PACKED_INTS) * n].view(np.int32)
    ints = ints.reshape(len(PACKED_INTS), n)
    floats = buf[8 * n + 4 * len(PACKED_INTS) * n: RECORD_BYTES * n]
    floats = floats.view(np.float32).reshape(len(uop.FLOAT_KEYS), n)
    out = {k: ints[i] for i, k in enumerate(uop.INT_KEYS)}
    out.update(zip(uop.FLOAT_KEYS, floats))
    out["dbseq_id"] = ints[len(uop.INT_KEYS)]
    out["pid"] = buf[: 8 * n].view(np.int64)
    return out


class _Ring:
    """Two pinned slots of RING_RECORDS records, a copy stream and an event
    per slot, on one card. The stream is made by the source's C entry point
    (one stream; PyTorch's first side stream makes its whole pool) and
    does not wait on the legacy default stream."""

    def __init__(self, dev: torch.device):
        self.slots = [torch.empty(RECORD_BYTES * RING_RECORDS,
                                  dtype=torch.uint8, pin_memory=True)
                      for _ in range(2)]
        handle = ctypes.c_void_p()
        with torch.cuda.device(dev):
            _call(_lib().fused_copy_stream, "fused_copy_stream",
                  (ctypes.addressof(handle),), ())
        self.stream = torch.cuda.ExternalStream(handle.value, device=dev)
        self.done = [torch.cuda.Event() for _ in range(2)]


_rings: dict[torch.device, list[_Ring]] = {}  # free rings by card
_rings_lock = threading.Lock()


def _take_ring(dev: torch.device) -> _Ring:
    """A free ring of the card, made (and pinned) only when none is free:
    the process pins a ring per card and concurrent drain."""
    with _rings_lock:
        free = _rings.setdefault(dev, [])
        if free:
            return free.pop()
    return _Ring(dev)


def _give_ring(dev: torch.device, ring: _Ring) -> None:
    with _rings_lock:
        _rings[dev].append(ring)


def records_to_host(lib, records: torch.Tensor, n2: int, n: int,
                    ready: torch.cuda.Event, sink: HostRecords,
                    at: int) -> None:
    """The first n2 of `records` (laid out for n) into sink rows at ..
    at + n2, through a pinned ring: on its copy stream, after `ready`
    (an event on the stream that wrote them), chunks of RING_RECORDS go to
    the two slots in turn, each by the C entry point's three copies, and
    the host moves a chunk into the sink while the next one copies."""
    if not n2:
        return
    dev = records.device
    ring = _take_ring(dev)
    try:
        ring.stream.wait_event(ready)
        chunks = [(r0, min(RING_RECORDS, n2 - r0))
                  for r0 in range(0, n2, RING_RECORDS)]

        def queue(i: int) -> None:
            r0, m = chunks[i]
            slot = ring.slots[i % 2]
            _call(lib.fused_records_to_host, "fused_records_to_host",
                  (records.data_ptr(), slot.data_ptr()), (r0, m, n, m),
                  stream=ring.stream.cuda_stream)
            ring.done[i % 2].record(ring.stream)

        for i in range(min(2, len(chunks))):
            queue(i)
        for i, (r0, m) in enumerate(chunks):
            ring.done[i % 2].synchronize()
            sink.put_packed(ring.slots[i % 2].numpy(), m, at + r0)
            if i + 2 < len(chunks):
                queue(i + 2)
    finally:
        _give_ring(dev, ring)


def threshold_call(lib, thr: float, res: dict, hits: dict, stream,
                   threads: int = THRESH_THREADS, grid: int = 0) -> dict:
    """threshold_launch, the kept count read back, and the records copied
    by one call of the C entry point into a host buffer laid out for them
    (pageable: the copies wait on the host): _thresh_core's dict."""
    records, scratch = threshold_launch(lib, thr, res, hits, stream,
                                        threads, grid)
    n = res["q_sp"].shape[0]
    n2 = int(scratch[1])
    buf = np.empty(RECORD_BYTES * n2, np.uint8)
    _call(lib.fused_records_to_host, "fused_records_to_host",
          (records.data_ptr(), buf.ctypes.data), (0, n2, n, n2),
          stream=stream)
    return unpack(buf, n2)


class PendingRecords:
    """A block's thresholded records on its device, with the kept count n2
    read back, until `drain` moves them to the host; on the CPU, the
    plain version's dict."""

    def __init__(self, n2: int, plain: dict | None = None, records=None,
                 n: int = 0, ready=None):
        self.n2, self._plain = n2, plain
        self._records, self._n, self._ready = records, n, ready

    def drain(self, sink: HostRecords, at: int) -> None:
        """The records into sink rows at .. at + n2; frees them."""
        if self._plain is not None:
            sink.put(self._plain, at)
        elif self.n2:
            with torch.cuda.device(self._records.device):
                records_to_host(_lib(), self._records, self.n2, self._n,
                                self._ready, sink, at)
        self._plain = self._records = self._ready = None


def threshold_start(p, res: dict, hits: dict) -> PendingRecords:
    """The extended hits at or below p.interaction_energy_threshold, in
    pair order, as search/fused.py:_thresh_core: `res` the ungapped
    kernel's output for `hits`, expand's output. On CUDA tensors one
    launch and one read (the kept count); the records stay on the card
    until drained. On CPU tensors _thresh_core."""
    dev = _check_threshold(res, hits)
    if dev.type == "cpu":
        out = _plain()._thresh_core(p, res, hits)
        return PendingRecords(len(out["pid"]), plain=out)
    if dev.type != "cuda":
        raise ValueError(f"threshold runs on cuda or cpu, not {dev}")
    n = res["q_sp"].shape[0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        records, scratch = threshold_launch(
            _lib(), p.interaction_energy_threshold, res, hits,
            stream.cuda_stream)
        n2 = int(scratch[1]) if n else 0
        ready = torch.cuda.Event()
        ready.record(stream)
    # no hits launch nothing
    nvcc.add_launches(globals(), "threshold_launches", int(n > 0))
    return PendingRecords(n2, records=records, n=n, ready=ready)


def threshold(p, res: dict, hits: dict) -> dict:
    """threshold_start, then its records on the host: _thresh_core's
    dict (the kernel for CUDA tensors, _thresh_core for CPU tensors)."""
    pending = threshold_start(p, res, hits)
    sink = HostRecords(pending.n2)
    pending.drain(sink, 0)
    return sink.columns(pending.n2)
