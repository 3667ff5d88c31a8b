"""Mean iterations an LP, over every stage and retry (Solution.iterations)."""


def read(run):
    its = [i for rq in run.requests for i in rq["iterations"]]
    return sum(its) / len(its) if its else None
