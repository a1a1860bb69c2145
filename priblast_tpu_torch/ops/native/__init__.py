"""Native (C++) host engine: build on first use + ctypes bindings.

The shared library is compiled from the .cc sources in this directory with
g++ on first use and cached under ``build/native/`` at the repository root
(keyed on a hash of the sources, the build flags and the host CPU). It
holds the exact accessibility engine (byte-identical to the reference),
SA-IS, the k-mer hash, and the seed / mid / gapped / finish stages of the
search chain.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parents[2] / "build" / "native"
_SOURCES = ["exact_engine.cc", "suffix_array.cc", "sa_is.cc", "search.cc"]
_HEADERS = ["fastmath.hpp", "tables.hpp"]
_FLAGS = ["-std=c++17", "-O3", "-march=native", "-ffp-contract=off",
          "-fPIC", "-shared", "-fopenmp"]


def _host_arch_tag() -> bytes:
    """Host CPU identifier folded into the cache key: with -march=native a
    build from one machine can SIGILL on an older CPU."""
    tag = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    tag += "|" + line.split(":", 1)[1].strip()
                    break
                if line.startswith("flags"):
                    tag += "|" + hashlib.sha256(line.encode()).hexdigest()[:8]
                    break
    except OSError:
        pass
    return tag.encode()


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _host_arch_tag())
    for name in _SOURCES + _HEADERS:
        h.update((_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if no build for these sources exists yet; the
    write is atomic, so concurrent builders (test workers) are safe."""
    out = BUILD_DIR / f"libpriblast_native_{_source_hash()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        tmp_out = Path(td) / out.name
        # -march=native vectorizes the DP loops; -ffp-contract=off keeps
        # the float arithmetic exactly IEEE (no FMA contraction), which
        # byte parity with the reference's SSE2 fmath paths depends on
        cmd = ["g++", *_FLAGS, "-o", str(tmp_out),
               *[str(_DIR / s) for s in _SOURCES]]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp_out, out)
    return out


@functools.lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    so = ctypes.CDLL(str(build()))
    vp, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_double)
    so.rp_raccess.restype = i32
    so.rp_raccess.argtypes = [vp, i32, i32, i32, vp, vp]
    so.rp_sais.restype = None
    so.rp_sais.argtypes = [vp, i64, vp]
    so.rp_kmer_hash.restype = None
    so.rp_kmer_hash.argtypes = [vp, i64, vp, i32, vp, vp]
    so.rp_argsort_desc.restype = None
    so.rp_argsort_desc.argtypes = [vp, i64, vp]
    so.rp_search_chunk.restype = vp
    so.rp_search_chunk.argtypes = [
        vp, i32, vp, vp, vp,                 # query
        vp, i64, vp,                         # db seq + sa
        vp, vp,                              # hash
        vp, vp,                              # acc/cond
        vp, vp,                              # offsets
        vp, vp, i32,                         # seq_len/start_pos/n
        i32, i32, i32,
        f64, f64, f64,
        i32, i32, i32, i32,
    ]
    so.rp_chain_mid.restype = vp
    so.rp_chain_mid.argtypes = [vp, i32, vp, i64, f64, i64] + [vp] * 9
    so.rp_gapped_extend.restype = vp
    so.rp_gapped_extend.argtypes = (
        [vp, i32, vp, vp, vp, i64] + [vp] * 6
        + [i32, i32, i32, i32, i64] + [vp] * 9)
    so.rp_chain_finish.restype = vp
    so.rp_chain_finish.argtypes = ([vp, i32, vp, i64, f64, i64]
                                   + [vp] * 12)
    so.rp_result_sizes.restype = None
    so.rp_result_sizes.argtypes = [vp] * 3
    so.rp_result_copy.restype = None
    so.rp_result_copy.argtypes = [vp] * 13
    so.rp_result_free.restype = None
    so.rp_result_free.argtypes = [vp]
    _init_params(so)
    return so


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def sa_build(seq: np.ndarray) -> np.ndarray:
    """Suffix array of a uint8-encoded string (SA-IS, linear time)."""
    so = lib()
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    sa = np.empty(len(seq), dtype=np.int32)
    so.rp_sais(_ptr(seq), len(seq), _ptr(sa))
    return sa


def kmer_hash(seq: np.ndarray, sa: np.ndarray, hash_size: int):
    """SA intervals for every k-mer, k=1..hash_size, flattened level-major."""
    so = lib()
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    sa = np.ascontiguousarray(sa, dtype=np.int32)
    slots = (4 ** (hash_size + 1) - 4) // 3
    hstart = np.empty(slots, dtype=np.int32)
    hend = np.empty(slots, dtype=np.int32)
    so.rp_kmer_hash(_ptr(seq), len(seq), _ptr(sa), hash_size, _ptr(hstart),
                    _ptr(hend))
    return hstart, hend


def argsort_desc(lengths) -> np.ndarray:
    """Descending argsort with libstdc++ std::sort tie permutation."""
    so = lib()
    ln = np.ascontiguousarray(lengths, dtype=np.int64)
    order = np.empty(len(ln), dtype=np.int32)
    so.rp_argsort_desc(_ptr(ln), len(ln), _ptr(order))
    return order


def search_chunk(q_seq, q_sa, q_acc, q_cond, chunk, p, stage: int = 0):
    """Run the per-query-per-chunk search chain on the exact engine.

    `chunk` is a utils.store.DbChunk; `p` a RisParams. stage: 0 = full
    chain, 1 = stop after seed expansion, 2 = stop after ungapped
    extension (used to validate the device stages). Returns a dict of
    struct-of-arrays hit fields + base pairs.
    """
    so = lib()
    q_seq = np.ascontiguousarray(q_seq, dtype=np.uint8)
    q_sa = np.ascontiguousarray(q_sa, dtype=np.int32)
    q_acc = np.ascontiguousarray(q_acc, dtype=np.float32)
    q_cond = np.ascontiguousarray(q_cond, dtype=np.float32)
    handle = so.rp_search_chunk(
        _ptr(q_seq), len(q_seq), _ptr(q_sa), _ptr(q_acc), _ptr(q_cond),
        _ptr(chunk.seqs), len(chunk.seqs),
        _ptr(chunk.suffix_array), _ptr(chunk.hash_start), _ptr(chunk.hash_end),
        _ptr(chunk.acc), _ptr(chunk.cond), _ptr(chunk.acc_off),
        _ptr(chunk.cond_off), _ptr(chunk.seq_sizes), _ptr(chunk.start_pos),
        chunk.n_seqs,
        p.hash_size, p.max_seed_length, p.min_accessible_length,
        p.hybrid_energy_threshold, p.interaction_energy_threshold,
        p.final_threshold,
        p.drop_out_length_wo_gap, p.drop_out_length_w_gap,
        p.min_helix_length, stage,
    )
    if not handle:
        raise RuntimeError("rp_search_chunk failed (params not set?)")
    return _copy_result(so, handle)


HIT_KEYS = ("dbseq_id", "dbseq_start", "q_sp", "db_sp", "q_len", "db_len",
            "acc_e", "hyb_e", "energy")


def _hit_arrays(hits):
    out = {k: np.ascontiguousarray(hits[k], dtype=np.int32)
           for k in HIT_KEYS[:6]}
    for k in HIT_KEYS[6:]:
        out[k] = np.ascontiguousarray(hits[k], dtype=np.float64)
    return out


def chain_mid(q_enc, chunk, p, hits):
    """Sort + interaction-threshold dedup + seed base pairs (the chain
    between the ungapped and gapped extensions)."""
    so = lib()
    q_enc = np.ascontiguousarray(q_enc, dtype=np.uint8)
    arrs = _hit_arrays(hits)
    handle = so.rp_chain_mid(
        _ptr(q_enc), len(q_enc), _ptr(chunk.seqs), len(chunk.seqs),
        p.interaction_energy_threshold, len(arrs["q_sp"]),
        *[_ptr(arrs[k]) for k in HIT_KEYS])
    if not handle:
        raise RuntimeError("rp_chain_mid failed")
    return _copy_result(so, handle)


def gapped_extend(q_enc, q_acc, q_cond, chunk, p, hits):
    """Host gapped extension (both flags, no dangles) for a hit subset —
    the device sweep's oracle and its max_ext-overflow fallback."""
    so = lib()
    q_enc = np.ascontiguousarray(q_enc, dtype=np.uint8)
    q_acc = np.ascontiguousarray(q_acc, dtype=np.float32)
    q_cond = np.ascontiguousarray(q_cond, dtype=np.float32)
    arrs = _hit_arrays(hits)
    handle = so.rp_gapped_extend(
        _ptr(q_enc), len(q_enc), _ptr(q_acc), _ptr(q_cond),
        _ptr(chunk.seqs), len(chunk.seqs),
        _ptr(chunk.acc), _ptr(chunk.cond), _ptr(chunk.acc_off),
        _ptr(chunk.cond_off), _ptr(chunk.seq_sizes), _ptr(chunk.start_pos),
        chunk.n_seqs, p.min_accessible_length, p.drop_out_length_w_gap,
        p.min_helix_length, len(arrs["q_sp"]),
        *[_ptr(arrs[k]) for k in HIT_KEYS])
    if not handle:
        raise RuntimeError("rp_gapped_extend failed")
    return _copy_result(so, handle)


def chain_finish(q_enc, chunk, p, hits, bp_off, bp_q, bp_db):
    """Dangles + per-hit bp sort + final sort + final-threshold dedup."""
    so = lib()
    q_enc = np.ascontiguousarray(q_enc, dtype=np.uint8)
    arrs = _hit_arrays(hits)
    bp_off = np.ascontiguousarray(bp_off, dtype=np.int64)
    bp_q = np.ascontiguousarray(bp_q, dtype=np.int32)
    bp_db = np.ascontiguousarray(bp_db, dtype=np.int32)
    handle = so.rp_chain_finish(
        _ptr(q_enc), len(q_enc), _ptr(chunk.seqs), len(chunk.seqs),
        p.final_threshold, len(arrs["q_sp"]),
        *[_ptr(arrs[k]) for k in HIT_KEYS],
        _ptr(bp_off), _ptr(bp_q), _ptr(bp_db))
    if not handle:
        raise RuntimeError("rp_chain_finish failed")
    return _copy_result(so, handle)


def _copy_result(so, handle):
    try:
        n_hits = ctypes.c_int64()
        n_bps = ctypes.c_int64()
        so.rp_result_sizes(handle, ctypes.byref(n_hits), ctypes.byref(n_bps))
        n, b = n_hits.value, n_bps.value
        out = {k: np.empty(n, np.int32) for k in HIT_KEYS[:6]}
        out.update({k: np.empty(n, np.float64) for k in HIT_KEYS[6:]})
        out["bp_off"] = np.empty(n + 1, np.int64)
        out["bp_q"] = np.empty(b, np.int32)
        out["bp_db"] = np.empty(b, np.int32)
        so.rp_result_copy(handle, *[_ptr(out[k]) for k in (
            *HIT_KEYS, "bp_off", "bp_q", "bp_db")])
        if n == 0:
            out["bp_off"][0] = 0
        return out
    finally:
        so.rp_result_free(handle)


def _init_params(so: ctypes.CDLL) -> None:
    from priblast_tpu_torch.utils import thermo

    sp = thermo.scaled()
    r = thermo.RAW
    keep = []  # keep arrays alive for the duration of the call

    def ip(x):
        a = np.ascontiguousarray(x, dtype=np.int32)
        keep.append(a)
        return _ptr(a)

    def dp(x):
        a = np.ascontiguousarray(x, dtype=np.float64)
        keep.append(a)
        return _ptr(a)

    so.rp_set_params(
        ip(r.BP_pair), ip(r.rtype),
        dp(sp.hairpin), dp(sp.mismatch_h), dp(sp.mismatch_i), dp(sp.stack),
        dp(sp.bulge), dp(sp.internal), dp(sp.int11), dp(sp.int21),
        dp(sp.int22), dp(sp.dangle5), dp(sp.dangle3), dp(sp.ninio),
        ctypes.c_double(sp.ml_closing), ctypes.c_double(sp.ml_intern),
        ctypes.c_double(sp.ml_base), ctypes.c_double(sp.term_au),
        ctypes.c_double(sp.kT), ctypes.c_double(sp.lxc),
        ip(r.stack37), ip(r.mismatchI37), ip(r.int11_37), ip(r.int21_37),
        ip(r.int22_37), ip(r.internal_loop37), ip(r.bulge37),
        ip(r.dangle5_37), ip(r.dangle3_37),
        ctypes.c_int(int(r.TerminalAU)),
    )


def raccess(codes: np.ndarray, w: int, d: int):
    """Exact accessibility for one sequence.

    codes: uint8 array of 0..4 (0 unknown, 1..4 = ACGU), length n.
    Returns (acc, cond) float32 arrays of length n (acc valid in [0, n-d],
    cond valid in [d, n-1]); see reference src/raccess.cpp:484-528.
    """
    so = lib()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = len(codes)
    acc = np.zeros(n, dtype=np.float32)
    cond = np.zeros(n, dtype=np.float32)
    rc = so.rp_raccess(_ptr(codes), n, w, d, _ptr(acc), _ptr(cond))
    if rc != 0:
        raise RuntimeError(f"rp_raccess failed with {rc}")
    return acc, cond
