"""LPs returned OPTIMAL in the window, over the window's seconds."""


def read(run):
    optimal = sum(int(s) == 0 for rq in run.requests for s in rq["status"])
    return optimal / run.window_s if run.window_s > 0 else None
