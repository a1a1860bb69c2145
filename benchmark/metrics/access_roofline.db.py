"""access_roofline.db: the accessibility kernels' share of their roofline
in the db cells, in %: the least time the card could take for the work
the window's sequences need (the weight grids' two launches, the two
column scans and the probability pass, each sequence counted at its own
length; pbench/counts.py) at the H100's published peaks, over the
kernels' summed device time in the trace. None without a trace or where
no accessibility kernel ran."""

import re

from pbench import counts

# the kernels of priblast_tpu_torch/csrc/access_{grids,inside,outside,
# prob}.cu (anonymous namespaces; the grid and scan launches share the
# names inside_kernel and outside_kernel)
ACCESS = re.compile(r"\b(inside|outside|window|sum|epilogue)_kernel<")


def read(run):
    t = run.devtrace
    lengths = getattr(run, "page_lengths", None)
    if t is None or not lengths:
        return None
    dev = sum(s for name, s in t.kernels
              if ACCESS.search(name) and "at::" not in name)
    if dev <= 0:
        return None
    cfg = run.config["db"]
    least = counts.least_seconds(counts.access_work(
        lengths, cfg["maximal_span"], cfg["min_accessible_length"]))
    run.log("[access_roofline.db] least s by kernel: " + ", ".join(
        f"{k} {s!r} ({by})" for k, (s, by) in least.items())
        + f"; device s {dev!r}")
    return 100.0 * sum(s for s, _ in least.values()) / dev
