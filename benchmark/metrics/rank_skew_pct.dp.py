"""How far the slowest rank lags: per class, the slowest rank's solve wall
less the mean rank's over the mean (each rank's own clock, from the
entry's call to its lanes solved), a mean over the window's classes."""


def read(run):
    skews = []
    for rq in run.requests:
        walls = rq["rank_solve_s"]
        mean = sum(walls) / len(walls)
        if len(walls) > 1 and mean > 0:
            skews.append(100.0 * (max(walls) - mean) / mean)
    return sum(skews) / len(skews) if skews else None
