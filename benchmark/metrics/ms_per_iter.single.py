"""Seconds in the solver stages over their iterations (Solution.stages),
summed over the window, in ms."""


def read(run):
    stages = [st for rq in run.requests for lp in rq["stages"] for st in lp]
    its = sum(st["iterations"] for st in stages)
    return 1e3 * sum(st["seconds"] for st in stages) / its if its else None
