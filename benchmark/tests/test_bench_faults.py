"""A run whose timed path is broken underneath comes out not correct: the
harness drives the program on the CPU (skipping its look for a card)
with each fault that a cell can have planted in the program."""

import os

import torch

import vanderbei_tpu_torch as vtt
from vanderbei_tpu_torch.models import hsd as hsd_mod
from vanderbei_tpu_torch.parallel import batch as pb
from benchmark import drivers, harness


def run(root, cell, seconds=0.5):
    code, result, lines = harness.run_cell(root, cell, 21, seconds, False,
                                           "cpu", 0.0)
    assert code == 0, lines
    return result


def test_sound_runs_are_correct(tiny_root):
    for cell in ("pilot87-hsd", "midcorpus-batch-hsd"):
        assert run(tiny_root, cell)["correct"]


def test_answer_altered_where_it_is_produced(tiny_root, monkeypatch):
    solve = vtt.solve

    def altered(lp, **kw):
        sol = solve(lp, **kw)
        sol.x = sol.x.copy()
        sol.x[0] += 1e-3
        return sol
    monkeypatch.setattr(drivers.vtt, "solve", altered)
    result = run(tiny_root, "pilot87-hsd")
    assert not result["correct"]


def test_step_returns_its_state_unchanged(tiny_root, monkeypatch):
    def stuck(A, b, c, f, state, **kw):
        return state._replace(status=torch.zeros_like(state.status)), False
    monkeypatch.setattr(hsd_mod, "_hsd_loop", stuck)
    for cell in ("pilot87-hsd", "midcorpus-batch-hsd"):
        assert not run(tiny_root, cell)["correct"]


def test_half_of_the_batch_left_out(tiny_root, monkeypatch):
    for name in ("solve_batch_hsd", "solve_batch_pd"):
        entry = getattr(pb, name)

        def half(A, b, c, *, entry=entry, **kw):
            B = A.shape[0]
            keep = slice(0, B // 2)
            if kw.get("ub") is not None:
                kw["ub"] = pb.UbTail(kw["ub"].idx2[keep], kw["ub"].w2[keep])
            out = entry(A[keep], b[keep], c[keep], **kw)
            # the lanes left out take the others' answers
            return tuple(torch.cat([t, t])[:B] for t in out)
        monkeypatch.setattr(pb, name, half)
    for cell in ("midcorpus-batch-hsd", "midcorpus-batch-pd"):
        assert not run(tiny_root, cell)["correct"]


GATHER = """
def gather_lanes(arrays, mesh):
    size = mesh.size(0)
    pos = mesh.get_local_rank("batch")
    out = []
    for t in arrays:
        B = t.shape[0]
        full = t.new_zeros(B * size, *t.shape[1:])
        full[pos * B:(pos + 1) * B] = t
        out.append(full)
    return out
"""
# the other ranks' processes take the broken gather at start-up
SITE = ("import vanderbei_tpu_torch.parallel.batch as pb\n" + GATHER
        + "pb.gather_lanes = gather_lanes\n")


def test_exchange_between_chips_left_out(tiny_root, monkeypatch, tmp_path):
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(SITE)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([str(site), tiny_root]))
    ns = {}
    exec(GATHER, ns)
    monkeypatch.setattr(pb, "gather_lanes", ns["gather_lanes"])
    result = run(tiny_root, "midcorpus-batch-hsd-dp4", seconds=0.2)
    assert result["device"]["count"] == 2
    assert not result["correct"]
    assert result["checks"]["feas_rel"]["value"] > 1e-3


def test_sharded_run_is_correct(tiny_root):
    result = run(tiny_root, "midcorpus-batch-hsd-dp4", seconds=0.2)
    assert result["correct"] and result["device"]["count"] == 2
