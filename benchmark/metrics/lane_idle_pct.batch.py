"""The share of lane iterations a batch spends on stopped lanes: 1 less
the lanes' iterations (pd: pivots) over lanes x the slowest lane's, summed
over the window's classes, from the per-lane counts the batch entry
returns."""


def read(run):
    done = sum(sum(rq["iterations"]) for rq in run.requests)
    held = sum(len(rq["iterations"]) * max(rq["iterations"])
               for rq in run.requests)
    return 100.0 * (1.0 - done / held) if held else None
