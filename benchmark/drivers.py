"""How a request reaches the program: the public entries of
vanderbei_tpu_torch that a traffic mix's "entry" names.

    solve   one LP a request: vanderbei_tpu_torch.solve(lp, method)
    batch   the request's LPs grouped into size classes as the batched
            corpus sweep groups them (parallel.batch.group_by_class,
            granularity 512, the UbTail structure for the hsd family),
            each class stacked and solved by the batch entry of the
            method, fetched to the host and recovered to each LP's own
            variables; under a mesh each rank takes its lanes
            (shard_batch) and gather_lanes assembles the class

A request's answer is, for each LP, (status, objective, x) on the host in
the LP's own variables.  This is the only module of the harness that
imports the program.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import vanderbei_tpu_torch as vtt
from vanderbei_tpu_torch.core.canonicalize import recover_solution
from vanderbei_tpu_torch.core.lp import LP
from vanderbei_tpu_torch.parallel import batch as pb

GRANULARITY = 512


def port_matrix(A, n_eq: int) -> tuple:
    """The CSC arrays (values, row indices, column starts) of A as the
    program's LP holds it: the <= rows negated into >= rows."""
    m, n = A.shape
    rows, cols = np.nonzero(A)
    order = np.argsort(cols * m + rows, kind="stable")
    rows, cols = rows[order], cols[order]
    vals = A[rows, cols] * np.where(rows < n_eq, 1.0, -1.0)
    kA = np.concatenate([[0], np.cumsum(np.bincount(cols, minlength=n))])
    return vals, rows.astype(np.int64), kA.astype(np.int64)


class Program:
    """The program under test, driven as the traffic mix says, on
    `device`, by one rank of `mesh` (None: no mesh)."""

    def __init__(self, workload, traffic: dict, device, mesh=None):
        self.workload = workload
        self.method = traffic["method"]
        self.entry = traffic["entry"]
        self.device = torch.device(device)
        self.mesh = mesh
        self.cfg = vtt.SolverConfig()
        # the CSC arrays of every matrix of the pool, made at set-up
        self._csc = {}
        for lane, members in enumerate(workload.matrices):
            for k, (A, _) in enumerate(members):
                m, n = A.shape
                self._csc[lane, k] = (*port_matrix(A, m // 10),
                                      [f"R{i}" for i in range(m)],
                                      [f"C{j}" for j in range(n)])
        # host spans (name, start, end) on time.perf_counter_ns, for the
        # trace's idle gaps
        self.spans = []

    def _span(self, name: str, start_ns: int) -> int:
        now = time.perf_counter_ns()
        self.spans.append((name, start_ns, now))
        return now

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def lp(self, lane: int, member: int, nat) -> LP:
        """The program's LP for a NaturalLP on lane `lane`'s matrix
        `member`."""
        vals, iA, kA, rowlab, collab = self._csc[lane, member]
        m, n = nat.shape
        b = nat.b.copy()
        b[nat.n_eq:] = -b[nat.n_eq:]
        return LP(name=f"L{lane}", m=m, n=n, A=vals, iA=iA, kA=kA, b=b,
                  c=nat.c, f=0.0,
                  r=np.where(np.arange(m) < nat.n_eq, 0.0, np.inf),
                  l=np.zeros(n), u=nat.u, Q=np.zeros(0),
                  iQ=np.zeros(0, np.int64), kQ=np.zeros(n + 1, np.int64),
                  qnz=0, varsgn=np.ones(n, np.int64), rowlab=rowlab,
                  collab=collab)

    def lps(self, request: int, nats) -> list:
        return [self.lp(lane, self.workload.member(request, lane), nat)
                for lane, nat in enumerate(nats)]

    def run(self, lps) -> dict:
        """One request: {"answers": [(status, objective, x)] (None on a
        rank other than the mesh's first), "iterations": per LP (pd:
        pivots), "f32_iterations": per LP, its iterations in f32 stages
        (None under a mesh: a rank holds only its own lanes' stages),
        "stages": the stage records, "solve_s": seconds from the
        entry's call to its outputs on the host (under a mesh: to this
        rank's lanes solved, as "rank_solve_s")}."""
        if self.entry == "solve":
            return self._solve(lps)
        if self.entry == "batch":
            return self._batch(lps)
        raise ValueError(f"unknown entry {self.entry!r}")

    def _solve(self, lps) -> dict:
        answers, iters, f32, stages = [], [], [], []
        t0 = time.perf_counter()
        for lp in lps:
            ns = time.perf_counter_ns()
            sol = vtt.solve(lp, method=self.method, device=self.device)
            self._span("solve", ns)
            answers.append((sol.status, sol.primal_obj, sol.x))
            iters.append(sol.iterations)
            f32.append(sum(st["iterations"] for st in sol.stages
                           if st["precision"] == "f32"))
            stages.append(sol.stages)
        return dict(answers=answers, iterations=iters, f32_iterations=f32,
                    stages=stages, solve_s=time.perf_counter() - t0)

    def _batch(self, lps) -> dict:
        cfg = self.cfg
        hsd = self.method in ("hsd", "hsdls")
        ns = time.perf_counter_ns()
        classes, aborted = pb.group_by_class(
            lps, granularity=GRANULARITY, use_ub_structure=hsd,
            scale=cfg.scale, free_vars=cfg.free_vars)
        answers = [None] * len(lps)
        iters = [0] * len(lps)
        f32 = [None] * len(lps)
        for idx, status in aborted:
            n = lps[idx].n
            answers[idx] = (status, float("nan"), np.full(n, np.nan))
        stages, solve_s, rank_s = [], 0.0, 0.0
        for key, entries in classes.items():
            if key[0] == "s":
                A, b, c, ub = pb.stack_class_structured(entries, *key[1:])
            else:
                A, b, c = pb.stack_class(entries, *key[-2:])
                ub = None
            ns = self._span("canonicalize+stack", ns)
            t0 = time.perf_counter()
            out, st, rank_done = self._entry(A, b, c, ub)
            solve_s += time.perf_counter() - t0
            rank_s += (rank_done or time.perf_counter()) - t0
            ns = self._span("solve", ns)
            stages.append(st)
            f32_st = [s["iterations"] for s in st if s["precision"] == "f32"]
            if self.mesh is None and all(len(its) == len(entries)
                                         for its in f32_st):
                for j, (idx, _) in enumerate(entries):
                    f32[idx] = int(sum(its[j] for its in f32_st))
            if out is None:
                continue
            status, x, y, w, z, it = out
            for j, (idx, canon) in enumerate(entries):
                yj, wj = y[j], w[j]
                if key[0] == "s":
                    # the structured layout is [head M1 | tail K]; the
                    # canonical row order is [head m1 | tail k]
                    k, M1 = len(canon.ub_cols), key[1]
                    m1 = canon.m - k
                    yj = np.concatenate([yj[:m1], yj[M1:M1 + k]])
                    wj = np.concatenate([wj[:m1], wj[M1:M1 + k]])
                xo, _, _, _, pobj, _, _ = recover_solution(canon, x[j], yj,
                                                           wj, z[j])
                answers[idx] = (int(status[j]), pobj, xo)
                iters[idx] = int(it[j])
            ns = self._span("recover", ns)
        if self.mesh is not None and self.mesh.get_local_rank("batch") != 0:
            answers = None
        return dict(answers=answers, iterations=iters, f32_iterations=f32,
                    stages=stages, solve_s=solve_s, rank_solve_s=rank_s)

    def _entry(self, A, b, c, ub):
        """The batch entry of the method on one stacked class: (its six
        outputs on the host, or None on a rank that does not fetch them;
        the stage records; under a mesh the clock's reading when this
        rank's lanes were solved, before the gather, else None)."""
        cfg, dev, stages, done = self.cfg, self.device, [], None
        if self.method in ("hsd", "hsdls"):
            long_step = self.method == "hsdls"
            if self.mesh is None:
                out = pb.solve_batch_hsd(A, b, c, ub=ub, long_step=long_step,
                                         corrector=cfg.hsd_corrector,
                                         device=dev, stages=stages)
            else:
                A_k, b_k, c_k, i_k, w_k = pb.shard_batch(
                    [A, b, c, ub.idx2, ub.w2], self.mesh)
                out = pb.solve_batch_hsd(A_k, b_k, c_k, ub=pb.UbTail(i_k, w_k),
                                         long_step=long_step,
                                         corrector=cfg.hsd_corrector,
                                         device=dev, stages=stages,
                                         mesh=self.mesh)
                self.sync()
                done = time.perf_counter()
                out = pb.gather_lanes(list(out), self.mesh)
                if self.mesh.get_local_rank("batch") != 0:
                    return None, stages, done
        elif self.method == "pd":
            out = pb.solve_batch_pd(A, b, c, max_iter=cfg.max_iter or 20_000,
                                    refresh_every=cfg.refresh_every,
                                    seed=cfg.seed, device=dev)
        else:
            raise ValueError(f"no batch entry for method {self.method!r}")
        return [t.cpu().numpy() for t in out], stages, done
