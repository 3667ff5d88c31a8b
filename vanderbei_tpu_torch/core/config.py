"""Solver configuration (a copy of vanderbei_tpu/core/config.py, so both
packages read one set of knobs).  The TPU watchdog's xl_chunk_* budgets
are carried unused: the port keeps only the time_limit deadline.

One dataclass replaces the reference's three config layers (MPS header
keywords iolp.c:167-183, the generic param[] store iolp.c:270-277, and the
AMPL key=val options amplio.c:94-151).  Numeric-kernel knobs default to the
reference's constants, cited per field.

All float/int knobs are consumed as TRACED scalars by the solver loops —
changing them never triggers a recompile.  Only `precision`, `method`,
`free_vars`, verbosity-derived trace flags and shape-affecting values
(refresh_every, max_refine) key new XLA programs.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    method: str = "hsd"             # reference default METHOD (ipo/makefile:57)
    max_iter: int = 0               # 0 -> per-method default (see registry)
    verbose: int = 0

    # interior-point tolerances
    ipm_eps: float = 1.0e-6         # intpt.c:30 residual/gap stop
    hsd_eps: float = 1.0e-12        # hsd.c:24 / hsdls.c mu stop
    delta: float = 0.02             # intpt centering (intpt.c:110)
    step_factor: float = 0.9        # intpt step damping r (intpt.c:111)
    hsd_step_factor: float = 0.95   # hsd.c:259
    beta: float = 0.80              # hsdls neighborhood (hsdls.c:112)
    # "mehrotra": one factorization drives predictor + second-order
    # corrector with adaptive centering (roughly halves trips);
    # "reference": the hsd.c:138-142 alternating delta=0/1 scheme
    hsd_corrector: str = "mehrotra"
    # intpt's divergence-based infeasibility certificate (normr>10*normr0,
    # intpt.c:175-182 — the reference itself labels it "(unreliable)").
    # On badly-scaled instances (AGG family, GROW*, SCFXM*) roundoff in
    # the normal-equations path can fake the 10x jump and certify a
    # reference-optimal problem infeasible; switch off to run those to
    # the optimal/iteration-limit stop instead.
    div_detect: bool = True

    # KKT / linear-algebra knobs (ldlt.c:27-32)
    epssol: float = 1.0e-6
    epsdiag: float = 1.0e-14
    refine_tol: float = 1.0e-10     # iterative refinement target (ldlt.c:411)
    max_refine: int = 8

    # Precision ladder.  The reference is an f64 CPU code with an optional
    # double-double mode; TPUs run f32 at MXU speed and f64 by emulation.
    #   "auto"   (default): "mixed" when the factored normal-matrix dim is
    #            >= mixed_min_dim (where the f32 sprint pays), else "f64"
    #            (small problems are launch-bound; f64 direct keeps
    #            reference-parity iteration paths).
    #   "mixed": stage 1 runs the WHOLE solve in f32 until mu < stage1_mu,
    #            then stage 2 resumes the state in f64 to the reference
    #            tolerance (hsd.c:24 mu < 1e-12).  Same statuses/objectives,
    #            MXU-speed bulk iterations; if the warm-started polish hits
    #            the iteration limit, one clean f64 retry runs (the f32
    #            path can wander on degenerate problems).
    #   "f32factor": f64 data, f32 Cholesky factor + f64 refinement.
    #   "f64":   single-stage f64 (closest to the reference's arithmetic).
    #   "dd":    QuadPrec-equivalent (reference -DQuadPrec, Quad.h:43-44):
    #            f64 stage with residuals/inner products evaluated in
    #            DOUBLE the working precision via error-free transforms
    #            (ops/quad.matvec2 / dot2) — for sf_req > 8 accuracy.
    precision: str = "auto"
    stage1_mu: float = 1.0e-4       # mixed-mode stage boundary (mu)
    mixed_min_dim: int = 1024       # "auto": mixed only at/above this dim
    # beyond this factored dim the f64-polish stage keeps an f32 FACTOR
    # (f64 data + refinement): an f64 factor of a 14.8k KEN-11 head
    # overflows the 16G HBM by ~45M at compile time, and at that scale
    # the f64 blocked factor dominates runtime anyway
    xl_f32factor_dim: int = 8192
    # ...or when the head operand A1 itself is large: every f64 gemm
    # against A1 materializes bf16 split-stack copies of it (the TPU f64
    # emulation), so a 6144x13824 FIT2P head costs ~17 GB of HLO temps in
    # full f64 — the f32 factor + f32 M formation removes the dominant
    # (A1*D)@A1' f64 gemm entirely
    xl_f32factor_elems: int = 60_000_000
    # XL solves chunk their while_loop launches tightly: one launch must
    # stay under the remote worker's watchdog even when every iteration
    # pays a Tikhonov escalation (registry._deadline_iter_budget;
    # GREENBEA-class crash root cause).  Below this dim, chunks are
    # 25-50 iterations — the sticky state-carried reg (kkt_factor reg0)
    # bounds the per-iteration worst case that forced 5-iteration chunks
    # at 2048 in r4
    xl_chunk_dim: int = 6144
    xl_chunk_iters: int = 5

    # quality-gate retries (registry.solve): on a SUBOPTIMAL verdict,
    # re-solve unscaled, then cross-check with intpt.  Disable for
    # throughput benchmarking — the primary path's honest status IS the
    # measurement there, and a GREENBEA-class retry chain costs ~1000 s
    # per rep
    quality_retries: bool = True

    # Schur-eliminate singleton upper-bound rows from the KKT factor
    # (ops/kkt.UbTail).  Disable to force the fully dense canonical system.
    use_ub_structure: bool = True

    time_limit: float = float("inf")   # TIMLIM header / cfg seconds budget

    # simplex tolerances (pd.c:38-42)
    eps: float = 1.0e-8             # EPS / EPS1 pivot tolerance
    eps2: float = 1.0e-12           # EPS2 perturbation floor
    eps3: float = 1.0e-10           # EPS3 mu optimality cutoff
    simplex_max_iter: int = 200_000  # chunked run cap (reference pd.c:42 1e6)
    refresh_every: int = 64         # dense B^-1 refresh cadence (replaces
                                    # the eta-file/bump refactor heuristic,
                                    # lueta.c:104-131)

    # problem equilibration: "geometric" (default) applies geometric-mean
    # row/col scaling to the canonical form (power-of-two factors, undone
    # on recovery).  The reference solves unscaled — and on wide-coefficient
    # instances (NESM, SCRS8, GANGES) its achieved objectives miss the
    # published optima by ~1e-6; scaling recovers them.  "none" = parity.
    scale: str = "geometric"

    seed: int = 0                   # jax.random key for perturbations
                                    # (replaces drand48, pd.c:193-200)
    dtype: np.dtype = np.float64
    # free (l = -inf) variables: "reject" = reference parity (solve.c:79-87
    # returns status 3); "split" = x+ - x- column splitting, which actually
    # solves the netlib instances the reference gives up on
    free_vars: str = "reject"

    def with_(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)

    def apply_lp_params(self, lp) -> "SolverConfig":
        """Fold the LP's MPS-header run parameters into this config —
        the analogue of the reference reading lp->itnlim / lp->timlim /
        lp->verbose / lp->sf_req after readlp (iolp.c:167-183 parses them
        into the LP).  Only headers explicitly present in the file override
        (every header line lands in lp.params, iolp.c:270-277 semantics).
        """
        explicit = set(getattr(lp, "params", {}) or {})
        cfg = self
        if "ITNLIM" in explicit and self.max_iter == 0:
            cfg = cfg.with_(max_iter=int(lp.itnlim))
        if "TIMLIM" in explicit and not np.isfinite(self.time_limit):
            cfg = cfg.with_(time_limit=float(lp.timlim))
        if "VERBOSE" in explicit and self.verbose == 0:
            cfg = cfg.with_(verbose=int(lp.verbose))
        if "SIGFIG" in explicit:
            # sf_req significant figures; the defaults sf_req=8 (iolp.c:96)
            # correspond to the reference stops mu<1e-12 (hsd.c:24) and
            # eps=1e-6 (intpt.c:30) — scale both with the request; beyond
            # ~10 figures plain f64 residuals drown in roundoff, which is
            # what the reference's QuadPrec rebuild was for — switch to the
            # compensated-arithmetic mode automatically
            sf = int(lp.sf_req)
            cfg = cfg.with_(hsd_eps=10.0 ** (-(sf + 4)),
                            ipm_eps=10.0 ** (-(sf - 2)))
            if sf > 9 and cfg.precision in ("auto", "mixed", "f64"):
                cfg = cfg.with_(precision="dd")
        return cfg
