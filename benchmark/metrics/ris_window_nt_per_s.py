"""ris_window_nt_per_s: the query nucleotides of all ris jobs of the traced
window over the window's whole time (the last job runs to its end), in
nt/s: the jobs' throughput on the host's clock, read per layer because it
spreads too widely between runs for an end-to-end bound."""


def read(run):
    if run.work_nt <= 0 or run.window_s <= 0:
        return None
    return run.work_nt / run.window_s
