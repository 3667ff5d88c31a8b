"""100 less the device's busy share of the traced window: the union of
every CUDA activity's interval (trace.py), a mean over the ranks."""


def read(run):
    if run.trace is None:
        return None
    ranks = run.trace["ranks"]
    busy = sum(r["busy_s"] / r["window_s"] for r in ranks) / len(ranks)
    return 100.0 * (1.0 - busy)
