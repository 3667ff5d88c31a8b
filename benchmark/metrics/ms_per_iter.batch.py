"""A batched class's stage seconds over its iterations (each stage: its
slowest lane's), summed over the window, in ms (the first rank's stages
under a mesh)."""


def read(run):
    secs = its = 0
    for rq in run.requests:
        for stages in rq["stages"]:
            for st in stages:
                secs += st["seconds"]
                its += int(max(st["iterations"]))
    return 1e3 * secs / its if its else None
