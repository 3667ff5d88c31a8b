"""The median request latency: from handing the program a request's LPs to
their answers on the host."""

import statistics


def read(run):
    lat = [rq["latency_s"] for rq in run.requests]
    return statistics.median(lat) if lat else None
