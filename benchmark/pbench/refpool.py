"""The process pool the reference runs in once the window has closed:
spawned workers (the run's process holds threads and the card), as many
as the traffic's `check_processes` and the host's cores allow."""

from __future__ import annotations

import contextlib
import multiprocessing
import os


@contextlib.contextmanager
def pool(run):
    n = min(run.traffic.get("check_processes", 8), os.cpu_count() or 1)
    p = multiprocessing.get_context("spawn").Pool(n)
    try:
        yield p
        p.close()
    finally:
        p.terminate()
        p.join()


def longest_first(p, fn, args, sizes):
    """p.map of fn over args, the largest first (the reference's wall is
    its longest sequence's), results in the order of args."""
    order = sorted(range(len(args)), key=lambda i: -sizes[i])
    got = p.map(fn, [args[i] for i in order], chunksize=1)
    out = [None] * len(args)
    for i, g in zip(order, got):
        out[i] = g
    return out
