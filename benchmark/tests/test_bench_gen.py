"""The frozen LP generator and the workload built on it."""

import json
import os

import numpy as np
import pytest

from benchmark import lpgen, reference, workload

from conftest import REPO


def test_random_bounded_lp_repeats_per_seed():
    a, b = (lpgen.random_bounded_lp(40, 80, seed=7) for _ in range(2))
    for f in ("A", "b", "c", "u"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    c = lpgen.random_bounded_lp(40, 80, seed=8)
    assert not np.array_equal(a.c, c.c)


def test_random_bounded_lp_is_feasible_and_has_randlp_layout():
    lp = lpgen.random_bounded_lp(60, 120, seed=3)
    assert lp.n_eq == 6
    x0 = np.random.default_rng(3)
    # an interior point exists: the reference solves it
    assert reference.feasibility(lp, np.clip(lp.u / 2, 0, None)) >= 0
    assert np.all((lp.u >= 1) & (lp.u <= 3))


def test_large_and_negative_seeds_map_to_streams():
    for seed in (2**40 + 3, -5, 0):
        assert lpgen.stream(seed, 1).random() == lpgen.stream(seed, 1).random()
    assert lpgen.stream(2**40, 1).random() != lpgen.stream(2**40 + 1, 1).random()


@pytest.mark.parametrize("config,traffic", [
    ("netlib-mid-corpus", "class-hsd16"),
    ("netlib-mid-corpus", "class-pd4"),
    ("netlib-mid-corpus", "class-hsd64-dp4"),
])
def test_lane_shapes(config, traffic):
    conf = json.load(open(os.path.join(REPO, "benchmark", "configs",
                                       config + ".json")))
    traf = json.load(open(os.path.join(REPO, "benchmark", "traffic",
                                       traffic + ".json")))
    shapes = workload.lane_shapes(conf, traf)
    spec = conf["sets"][traf["set"]]
    assert len(shapes) == spec["count"] * traf.get("repeat", 1)
    assert shapes[1] == (spec["rows"][0] + spec["rows"][1],
                         spec["cols"][0] + spec["cols"][1])


def test_workload_requests_repeat_and_differ():
    conf = {"sets": {"s": {"rows": [20, 2], "cols": [40, 4], "count": 2}},
            "generator": {"density": 0.3}}
    traf = {"set": "s", "pool": 2, "repeat": 1}
    w1, w2 = (workload.Workload(conf, traf, 2**33 + 1) for _ in range(2))
    r1, r2 = w1.request(3), w2.request(3)
    assert [lp.shape for lp in r1] == [(20, 40), (22, 44)]
    for a, b in zip(r1, r2):
        np.testing.assert_array_equal(a.b, b.b)
        np.testing.assert_array_equal(a.c, b.c)
    # the same matrix, a new c and b, request by request
    r5 = w1.request(5)
    assert r5[0].A is r1[0].A and not np.array_equal(r5[0].c, r1[0].c)
    # another seed, the same shapes and amount of work
    w3 = workload.Workload(conf, traf, 9)
    assert [lp.shape for lp in w3.request(3)] == [lp.shape for lp in r1]
    assert not np.array_equal(w3.request(3)[0].c, r1[0].c)
