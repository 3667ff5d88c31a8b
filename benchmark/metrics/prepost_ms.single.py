"""Mean of a request's latency less the seconds of its solver stages
(Solution.stages): canonicalize, pad, upload, recover."""


def read(run):
    rest = [rq["latency_s"] - sum(st["seconds"] for lp in rq["stages"]
                                  for st in lp)
            for rq in run.requests]
    return 1e3 * sum(rest) / len(rest) if rest else None
