"""The one general generator: a cell's LPs, request by request, from its
configuration, its traffic mix and the seed.

A configuration names sets of LP shapes ("sets": {name: {"rows": [m0, dm],
"cols": [n0, dn], "count": k}}: k LPs, the j-th (m0 + dm j) x (n0 + dn j))
and the generator's parameters ("generator": {"density": ...}).  A traffic
mix names the set it draws from and how a request is made of it:

    set      the configuration's set
    repeat   a request holds the set's LPs this many times (lanes
             set-count * repeat); lane l has the set's shape l % count
    pool     matrices per lane: request r takes member (r + lane) % pool
             on lane `lane`, so that a class mixes the members
    entry, method
             how the request reaches the program (drivers.py)
    trace_seconds
             how much of a --trace 1 window the profiler covers (by
             default all of it)

Each lane's matrices are made once, at set-up, from (seed, 0, lane,
member); every request draws its own c, x0 and slack, so a new b, from
(seed, 1, request, lane); the warm-up request from (seed, 2, lane).  Every
seed gives the same shapes and the same amount of work, in other numbers.
"""

from __future__ import annotations

from . import lpgen


def lane_shapes(config: dict, traffic: dict) -> list:
    """(m, n) of every lane of a request, in lane order."""
    spec = config["sets"][traffic["set"]]
    (m0, dm), (n0, dn), k = spec["rows"], spec["cols"], spec["count"]
    shapes = [(m0 + dm * j, n0 + dn * j) for j in range(k)]
    return shapes * int(traffic.get("repeat", 1))


class Workload:
    """A cell's matrices (made at construction) and its requests."""

    def __init__(self, config: dict, traffic: dict, seed: int):
        self.seed = seed
        self.shapes = lane_shapes(config, traffic)
        self.pool = int(traffic.get("pool", 1))
        density = float(config["generator"]["density"])
        self.matrices = [
            [lpgen.pool_matrix(m, n, density, lpgen.stream(seed, 0, lane, k))
             for k in range(self.pool)]
            for lane, (m, n) in enumerate(self.shapes)]

    @property
    def lanes(self) -> int:
        return len(self.shapes)

    def member(self, request: int, lane: int) -> int:
        """The pool member that lane `lane` of request `request` (-1: the
        warm-up) uses."""
        return (max(request, 0) + lane) % self.pool

    def request(self, request: int) -> list:
        """The NaturalLP of each lane of request `request` (-1: the warm-up
        request)."""
        return [lpgen.request_lp(*self.matrices[lane][self.member(request,
                                                                   lane)],
                                 lpgen.stream(self.seed, 2, lane)
                                 if request < 0 else
                                 lpgen.stream(self.seed, 1, request, lane))
                for lane in range(self.lanes)]
