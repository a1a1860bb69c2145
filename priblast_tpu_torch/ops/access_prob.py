"""The accessibility DP's probability pass: a hand-written CUDA kernel for
Hopper (csrc/access_prob.cu) and its wrapper.

`window_probs` computes accessibility/batched.py:scan_probabilities
(make_prob_grids, probability_pass and the sum of their eight terms):
the unpaired probabilities p_w and p_w1, each [N+2, B], of every window
of size w and w + 1, from the inside scan's outputs and the outside
scan's. It replaces the JAX package's XLA program
priblast_tpu/accessibility/batched.py:make_prob_grids (:1111) +
probability_pass (:1175).

On CUDA tensors it launches the kernel (a failed build or launch raises);
on CPU tensors it calls scan_probabilities, its plain version, which the
kernel matches up to the order of some of its sums.

`window_energies`, the main path's call, computes the window energies
-kT log p / 1000 (acc and cond, float32) of accessibility/batched.py:
accessibility_from_probabilities straight from the scans' outputs (the JAX
package's priblast_tpu/accessibility/batched.py:1370-1390, the end of
_run_batch_impl): the same two launches, the sum launch writing the
energies from the probabilities it holds, so they take no launch, wrapper
call or probability buffer of their own. One [2, B, N] float32 tensor on
CUDA; on CPU tensors scan_probabilities, then
accessibility_from_probabilities, stacked.

`accessibility` computes the same energies from p_w and p_w1 given in
device memory, with a third kernel of the same source that shares the
sum launch's arithmetic (the form on given probabilities, off the main
path): the same bits as window_energies on the probabilities that
window_probs gives, and on the card as its plain version.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from priblast_tpu_torch.accessibility import batched as ab
from priblast_tpu_torch.ops import access_scan, nvcc

SRC = Path(__file__).resolve().parents[1] / "csrc" / "access_prob.cu"
# threads per CTA of the window kernel (a warp per 4 columns) and its
# columns per CTA: the stem rows of a tile and its halo fit in shared memory,
# two CTAs to an SM in float32 (on the H100 as fast as 256 threads at 64
# columns, faster than 256 at 32 or 128 at 16: access_ab.py --tile)
THREADS = 128
TILE = {torch.float32: 32, torch.float64: 16}

# launch counts, plain calls not counted: the probability pass's (its
# window and sum launches, by window_probs() or window_energies()), the sum
# launches that also write the window energies (window_energies()), and the
# epilogue kernel's (accessibility())
prob_launches = 0
energies_launches = 0
epilogue_launches = 0


def build() -> Path:
    """Compile csrc/access_prob.cu into build/kernels/ with nvcc, with the
    scan kernels' flags (-fmad=false among them)."""
    return nvcc.build(SRC, access_scan.NVCC_FLAGS)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name in ("access_prob", "access_prob_energies", "access_epilogue"):
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{dt}")
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 4
    return lib


def _fn(dtype, name: str = "access_prob"):
    return getattr(_lib(), f"{name}_f64" if dtype == torch.float64
                   else f"{name}_f32")


@functools.lru_cache(maxsize=16)
def _tables(w_span: int, dtype, device):
    """The kernel's tables on `device`: the interior kernel K_int[u1][u2]
    and the bulge kernel, each value rounded to the dtype as
    probability_pass rounds it; bp and rtype[bp] (int32); the float32
    stack, int11, int21 and int22 tables of make_prob_grids."""
    lm = ab._linmodel(w_span)
    npdt = ab._npdt(dtype)
    bp = np.asarray(lm.bp, np.int32)

    def f(x, dt):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(x, dt)
                                                    .reshape(-1)),
                               device=device)

    return (f(np.asarray(lm.K_int).astype(npdt), npdt),
            f(np.asarray(lm.K_bulge).astype(npdt), npdt),
            f(bp, np.int32), f(np.asarray(lm.rtype)[bp], np.int32),
            f(lm.W_stack, np.float32), f(lm.W_int11, np.float32),
            f(lm.W_int21, np.float32), f(lm.W_int22, np.float32))


@functools.lru_cache(maxsize=16)
def _scalars(w_span: int, w: int, dtype):
    """sigma^-1 .. sigma^-4, sigma^-w, sigma^-(w+1) and 128 ln 2, each
    rounded to the dtype as the plain version rounds it, and the float32
    bulge weight of one unpaired base."""
    lm = ab._linmodel(w_span)
    npdt = ab._npdt(dtype)
    return (*(float(npdt(np.exp(-k * lm.lsig))) for k in (1, 2, 3, 4, w,
                                                           w + 1)),
            float(npdt(128.0 * np.float32(np.log(2.0)))),
            float(np.float32(lm.W_bulge_len[1])))


def _scratch_slots(w: int, band: int) -> int:
    """Values per (column, row) that the window kernel hands the sum
    kernel: the hairpin suffix sums, srcL, the running sums of srcL and
    srcR over u, and the sum of srcR."""
    nu = max(ab.ML - w + 1, 0)
    return max(band - 1 - w, 0) + nu + 2 * max(nu - 1, 0) + 1


def _check(g, s_padded, lengths, w: int, n_max: int, band: int, dtype, ins,
           outs, checked: bool):
    if len(ins) != 8 or len(outs) != 5:
        raise ValueError("ins must hold 8 tensors and outs 5")
    dev = g.hpW.device
    B = g.hpW.shape[1] if g.hpW.dim() == 3 else 0
    shape = (n_max + 1, B, band)
    names = ("stem", "stem_m", "stem_a", "multi", "multi1", "multi2")
    for name, x in zip(names, ins[:6]):
        nvcc.check_tensor(x, name, shape, dtype, dev)
    for name, x in zip(("bse", "bse_m", "bse_a", "b_multi", "b_multi2"),
                       outs):
        nvcc.check_tensor(x, name, shape, dtype, dev)
    nvcc.check_tensor(g.hpW, "hpW", shape, dtype, dev)
    for name, x in (("A_full", ins[6]), ("B_full", ins[7])):
        nvcc.check_tensor(x, name, (n_max + 1, B), dtype, dev)
    if s_padded.dim() != 2:
        raise ValueError("s_padded must be [B, S]")
    nvcc.check_tensor(s_padded, "s_padded", (B, s_padded.shape[1]),
                      torch.int64, dev)
    access_scan._check_lengths(lengths, n_max, B, dev, checked)
    if w < 1:
        raise ValueError(f"the window size must be at least 1, not {w}")
    return dev, B


def window_probs(t: ab.Tables, g: ab.Grids, s_padded, lengths,
                 min_acc_len: int, n_max: int, band: int, dtype, ins, outs,
                 *, checked: bool = False):
    """(p_w, p_w1), each [N+2, B], as scan_probabilities: `ins` the inside
    scan's eight outputs (six planes, A_full, B_full), `outs` the outside
    scan's five planes, all contiguous; s_padded [B, S] int64 codes;
    lengths [B] int64 in [0, n_max]; `checked`: the caller has checked
    their range on the host, so none is read from the device."""
    dev, B = _check(g, s_padded, lengths, min_acc_len, n_max, band, dtype,
                    ins, outs, checked)
    if dev.type == "cpu":
        return ab.scan_probabilities(t, g, s_padded, lengths, min_acc_len,
                                     n_max, band, dtype, ins, outs)
    if dev.type != "cuda":
        raise ValueError(f"window_probs runs on cuda or cpu, not {dev}")
    with torch.cuda.device(dev):
        out = _prob_call(_fn(dtype), g, s_padded, lengths, min_acc_len,
                         n_max, band, dtype, ins, outs,
                         torch.cuda.current_stream(dev).cuda_stream)
    # an empty batch launches nothing
    nvcc.add_launches(globals(), "prob_launches", int(B > 0))
    return out


def _pass_args(g, s_padded, lengths, w: int, n_max: int, band: int, dtype,
               ins, outs, p_w, p_w1, threads: int, tile: int | None,
               staged: bool):
    """The pointers, sizes and scalars that both entry points of the
    probability pass take, on checked arguments (p_w and p_w1 may be None:
    null pointers), and the tensors they point to that are made here (keep
    them until the call is enqueued)."""
    dev = g.hpW.device
    B = g.hpW.shape[1]
    logZ = ins[6].gather(0, lengths[None, :])[0].contiguous()
    scr = torch.empty((_scratch_slots(w, band), n_max + 1, B), dtype=dtype,
                      device=dev)
    planes = (*ins[:4], ins[5], *outs, g.hpW, ins[6], ins[7], logZ, s_padded)
    ptrs = (*(x.data_ptr() for x in planes),
            *(x.data_ptr() for x in _tables(band - 2, dtype, dev)),
            scr.data_ptr(), *(0 if x is None else x.data_ptr()
                              for x in (p_w, p_w1)))
    sizes = (n_max + 1, B, band, ab.ML, w, s_padded.shape[1],
             tile or TILE[dtype], threads, int(staged))
    return ptrs, sizes, _scalars(band - 2, w, dtype), (logZ, scr)


def _launch(fn, ptrs, sizes, scalars, stream, what: str) -> None:
    err = fn((ctypes.c_void_p * len(ptrs))(*ptrs),
             (ctypes.c_longlong * len(sizes))(*sizes),
             (ctypes.c_double * len(scalars))(*scalars), stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _prob_call(fn, g, s_padded, lengths, w: int, n_max: int, band: int,
               dtype, ins, outs, stream, threads: int = THREADS,
               tile: int | None = None, staged: bool = True):
    """Allocate the scratch buffer and the outputs and call the C entry
    point of csrc/access_prob.cu (`fn`) on checked arguments on `stream`;
    `staged` = False keeps the stem rows in device memory."""
    B = g.hpW.shape[1]
    p = torch.empty((2, n_max + 2, B), dtype=dtype, device=g.hpW.device)
    ptrs, sizes, scalars, _keep = _pass_args(
        g, s_padded, lengths, w, n_max, band, dtype, ins, outs, p[0], p[1],
        threads, tile, staged)
    _launch(fn, ptrs, sizes, scalars, stream, "access_prob")
    return p[0], p[1]


def _energies_call(fn, g, s_padded, lengths, w: int, n_max: int, band: int,
                   dtype, ins, outs, kT: float, stream, probs: bool = False,
                   threads: int = THREADS, tile: int | None = None,
                   staged: bool = True):
    """Allocate the scratch buffer and the [2, B, n_max] float32 energies
    and call an energies entry point of csrc/access_prob.cu (`fn`) on
    checked arguments on `stream`. With `probs`, also p_w and p_w1:
    returns (energies, p_w, p_w1)."""
    dev = g.hpW.device
    B = g.hpW.shape[1]
    out = torch.empty((2, B, n_max), dtype=torch.float32, device=dev)
    p = (torch.empty((2, n_max + 2, B), dtype=dtype, device=dev) if probs
         else (None, None))
    ptrs, sizes, scalars, _keep = _pass_args(
        g, s_padded, lengths, w, n_max, band, dtype, ins, outs, p[0], p[1],
        threads, tile, staged)
    _launch(fn, (*ptrs, lengths.data_ptr(), out[0].data_ptr(),
                 out[1].data_ptr()), sizes,
            (*scalars, float(np.float32(kT))), stream, "access_prob energies")
    return (out, p[0], p[1]) if probs else out


def window_energies(t: ab.Tables, g: ab.Grids, s_padded, lengths,
                    min_acc_len: int, n_max: int, band: int, dtype, ins,
                    outs, kT: float, *, checked: bool = False):
    """The window energies of accessibility_from_probabilities on the
    probabilities of scan_probabilities, as one [2, B, n_max] float32
    tensor (acc, then cond), from the inputs of window_probs (the same
    checks), and kT. On CUDA tensors one call of the pass's two launches,
    the sum launch writing the energies; on CPU tensors the plain
    versions."""
    dev, B = _check(g, s_padded, lengths, min_acc_len, n_max, band, dtype,
                    ins, outs, checked)
    if dev.type == "cpu":
        return torch.stack(ab.accessibility_from_probabilities(
            *ab.scan_probabilities(t, g, s_padded, lengths, min_acc_len,
                                   n_max, band, dtype, ins, outs),
            lengths, min_acc_len, n_max, kT))
    if dev.type != "cuda":
        raise ValueError(f"window_energies runs on cuda or cpu, not {dev}")
    with torch.cuda.device(dev):
        out = _energies_call(_fn(dtype, "access_prob_energies"), g, s_padded,
                             lengths, min_acc_len, n_max, band, dtype, ins,
                             outs, kT,
                             torch.cuda.current_stream(dev).cuda_stream)
    # an empty batch launches nothing
    nvcc.add_launches(globals(), "prob_launches", int(B > 0))
    nvcc.add_launches(globals(), "energies_launches", int(B > 0))
    return out


def accessibility(p_w, p_w1, lengths, w: int, n_max: int, kT: float, *,
                  checked: bool = False):
    """The window energies of accessibility_from_probabilities, as one
    [2, B, n_max] float32 tensor (acc, then cond): p_w and p_w1 [n_max + 2,
    B] float32 or float64, contiguous; lengths [B] int64 in [0, n_max]
    (`checked`: the caller has checked their range on the host, so none is
    read from the device); w the least accessible length. The epilogue
    kernel for CUDA tensors, accessibility_from_probabilities for CPU
    tensors. Off the main path (window_energies computes these there)."""
    dev = p_w.device
    B = p_w.shape[1] if p_w.dim() == 2 else 0
    if p_w.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"p_w has dtype {p_w.dtype}, expected float32 or "
                         "float64")
    for name, x in (("p_w", p_w), ("p_w1", p_w1)):
        nvcc.check_tensor(x, name, (n_max + 2, B), p_w.dtype, dev)
    access_scan._check_lengths(lengths, n_max, B, dev, checked)
    if w < 1:
        raise ValueError(f"the window size must be at least 1, not {w}")
    if dev.type == "cpu":
        return torch.stack(ab.accessibility_from_probabilities(
            p_w, p_w1, lengths, w, n_max, kT))
    if dev.type != "cuda":
        raise ValueError(f"accessibility runs on cuda or cpu, not {dev}")
    with torch.cuda.device(dev):
        out = _epilogue_call(_fn(p_w.dtype, "access_epilogue"), p_w, p_w1,
                             lengths, w, n_max, kT,
                             torch.cuda.current_stream(dev).cuda_stream)
    # an empty batch launches nothing
    nvcc.add_launches(globals(), "epilogue_launches", int(B * n_max > 0))
    return out


def _epilogue_call(fn, p_w, p_w1, lengths, w: int, n_max: int, kT: float,
                   stream):
    """Allocate the output and call an epilogue entry point of
    csrc/access_prob.cu (`fn`) on checked arguments on `stream`."""
    B = p_w.shape[1]
    out = torch.empty((2, B, n_max), dtype=torch.float32, device=p_w.device)
    ptrs = (p_w.data_ptr(), p_w1.data_ptr(), lengths.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr())
    _launch(fn, ptrs, (B, n_max, w), (float(np.float32(kT)),), stream,
            "access_epilogue")
    return out
