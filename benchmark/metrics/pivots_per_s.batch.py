"""A batched class's pivots (its slowest lane's) over the seconds of its
solve (the entry's call to its outputs on the host), over the window."""


def read(run):
    pivots = sum(max(rq["iterations"]) for rq in run.requests)
    secs = sum(rq["solve_s"] for rq in run.requests)
    return pivots / secs if secs > 0 else None
