#!/usr/bin/env python3
"""Smoke run of vanderbei_tpu_torch on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, one line each; any failure exits non-zero and prints no result:

1. device: the card's name and power limit (nvidia-smi).
2. build: compile csrc/scaled_syrk.cu with nvcc (or reuse the build), and
   count the HGMMA (wgmma) instructions in the library's SASS: none fails.
3. kernel: the scaled-syrk kernel against its plain torch version and an
   f64 product, at the solver's head shape (2560, 4096), a ragged shape, the
   strided transposed view of the dual form, a batch of 3, a column scale
   spread over 1e-8..1e8, and the edges of both copy paths (ragged
   transposed, a column step, an unaligned base, a 7 x 5 X, a batch of
   transposed views), intpt's dual-form A' (4096, 6656), the QP's
   dual-form A' (1024, 2048) and the two batched solves' launches, the
   hsd class (16, 1024, 1536) and intpt's transposed class A'
   (8, 1024, 1536), and the mesh phases' shards, the smoke LP's head on
   one of 2 model ranks (2560, 2048), the phase-10 class on one rank of a
   (2, 2) mesh (8, 1024, 768), on one of 2 batch ranks (8, 1024, 1536)
   and on one of 4 (4, 1024, 1536), tools/multichip_scaling.py --ranks 4's;
   kernel and plain times, the kernel's TFLOP/s of lower-tile work and its
   bound (see bound()), at (2560, 4096) (TMA copies), its transposed view
   (TMA), (1000, 1537) (cp.async copies), the dual-form A' of intpt and of
   the QP, the two batched classes and the four shards (all TMA).
4. solve: a seeded 2000 x 4000 bounded LP (200 equality rows, 2% dense),
   written to MPS and solved through the CLI on the card; it must be
   OPTIMAL within 1e-8 of scipy's HiGHS on the LP read back from the file,
   run an f32 stage, and launch the kernel.
5. intpt: the smoke LP with its equality rows widened to ranges of width 1
   (the same canonical shape, 6200 x 4000, padded to 6656 x 4096) through
   the CLI with --method intpt: OPTIMAL within 1e-6 of HiGHS (intpt stops
   at a 1e-6 gap), an f32 stage, and every kernel launch on the
   transposed (dual-form A') layout.
6. qp: a seeded 500 x 1000 bounded LP plus a banded PSD Q, written with
   QUADS and solved through the CLI with --method hsd on the card, which
   must route it to intpt and launch the kernel; the same file solved in
   process on the CPU (the plain versions) must agree: both OPTIMAL,
   iterations within 3, objectives within 1e-8; the card's point (of an
   in-process solve on the card) and the CPU's satisfy the rows and
   bounds of the file to 1e-6 relative and agree to 1e-3 relative.
7. dd: a seeded 500 x 1000 LP through the CLI with --precision dd
   --metrics: OPTIMAL within 1e-8 of HiGHS; the CSV finite, one row per
   iteration of its run (iter 0..k-1), mu falling by at least 1e8.
8. simplex: a seeded 300 x 600 LP through the CLI with --method pd and
   --method twophase: each OPTIMAL within 1e-8 of HiGHS; pivots, seconds.
9. native: the smoke MPS read with the native reader (built by g++ here)
   equals the Python reader's LP, array for array.
10. batch-hsd: 16 seeded bounded LPs (560 + 4j) x (1100 + 9j), j = 0..15,
   written to MPS and read back, grouped as the batched corpus sweep
   groups them (granularity 512, the UbTail structure) into ONE class
   ("s", 1024, 1536, 1536), solved by parallel.batch.solve_batch_hsd
   (mixed) on the card: every lane OPTIMAL from the batched solve itself
   and within 1e-8 of HiGHS, one kernel launch per f32 iteration at
   (16, 1024, 1536).
11. batch-intpt: the ranged twins (as phase 5 builds them) of 8 seeded
   LPs (400 + 10j) x (800 + 20j), one dense class (1536, 1024) through
   solve_batch_intpt: every lane OPTIMAL within 1e-6 of HiGHS, the kernel
   on the transposed batched view A' (8, 1024, 1536).
12. batch-pd: 4 seeded LPs (300 + 10j) x (600 + 20j) through
   solve_batch_pd: every lane OPTIMAL within 1e-8 of HiGHS; pivots per
   lane and pivots/s.
13. mesh-tp: phase 4's MPS solved tensor-parallel, solve(lp,
   mesh=make_mesh(2, model_parallel=2)) on 2 ranks sharing the card
   (gloo on CUDA tensors, run_ranks): OPTIMAL with the same status,
   iterations and objective on both ranks, within 1e-9 of phase 4's
   objective and 1e-8 of HiGHS, iterations within 2 of phase 4's, and on
   each rank one kernel launch per f32 iteration, all at its shard
   (2560, 2048); then a warm solve and one under torch.profiler (the
   rank's device-busy share); all-reduces, bytes and the share of the
   wall in all-reduce calls per iteration; beside them the wall of one
   solve() of the LP on the card alone, cold and warm.
14. mesh-nccl: the same solve in this process on a world of 1 under
   nccl: equal to phase 4 to 1e-12 relative, in as many iterations.
15. mesh-batch: phase 10's class through shard_batch and
   solve_batch_hsd(mesh=) on a (2, 2) mesh, 4 ranks sharing the card
   (gloo): every lane OPTIMAL within 1e-8 of HiGHS, each lane's
   iterations within 2 of phase 10's, each rank one launch per f32
   iteration at (8, 1024, 768).
16. mesh-dd: phase 4's MPS solved tensor-parallel in precision "dd"
   (column sums compensated across the ranks, ColumnShards.sum2), 2 ranks
   sharing the card (gloo), cold then warm, then in "f64" on the same
   mesh: OPTIMAL with the same bits on both ranks, within 1 iteration and
   1e-12 of a single-card "dd" solve of the LP and within 1e-8 of HiGHS;
   the all-reduces by method beside the f64 solve's, the same once 5 a
   refinement pass and 1 a factor retry are set aside (when the
   iterations agree); no kernel launch ("dd" has no f32 stage).
17. dp-scaling: tools/multichip_scaling.py's runs of phase 10's class on
   2 ranks sharing the card (gloo), a (2, 1) mesh: one card, then the
   "batch" ranks, a warm-up and 3 jiggled reps each, then a profiled
   rep; every lane OPTIMAL with the single run's statuses and iterations,
   the warm-up's equal to phase 10's; each rank one launch per f32
   iteration at (8, 1024, 1536); t_single_s, t_sharded_s, overhead_frac,
   each rank's device-busy share and the tool's JSON line.
19. hsd-graph: the smoke LP (phase 4's, made in memory) and a PILOT87-
   shaped LP (2030 x 4883, the benchmark's pilot87-hsd shape) solved
   twice each by solve() on the card, cold then warm, with the loop's
   CUDA graph (models/hsd.py: one replay an iteration) and forced eager
   (the test-only hook hsd._graph_engages): the same statuses and
   iterations, objectives within 1e-12 relative, and kernel launches on
   the same paths, as many as the f32 stage's replays (each launches the
   kernel, its step kept or not) and redos (each launches it once more);
   the graph counters (captures cold and warm, replays, redos) and both
   warm times.
18. every (shape, layout) the solves of phases 4-6, 10-11, 13-17 and 19
   handed the kernel (the ranks' too) is one that phase 3 held against
   the plain version, or the run fails; then phases 7-9, the total time,
   the kernels' JSON line (launches split by path: hsd, intpt, qp,
   batch-hsd, batch-intpt, mesh-tp, mesh-nccl, mesh-batch, mesh-dd,
   dp-scaling, hsd-graph), the card line, and {"ok": true, "device":
   {...}} last.

Phases 13, 16 and 17 share one spawn of their 2 ranks (run_pair), whose
records each phase then checks.  A rank that fails or outlasts its limit
fails the script.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

# tolerances: |M - M_f64| <= BOUND * (|X| diag|s| |X|' + diag|e|) entrywise
# (f32 accumulation over n terms); RTOL/ATOL as tests/test_pallas.py holds
# the TPU kernel, applied at its shapes, where n <= 1024
BOUND = 1e-4
RTOL, ATOL = 2e-5, 2e-4
# the card's peaks at 700 W (NVIDIA's H100 SXM data sheet): HBM3 at 3.35
# TB/s; f32-accurate products by 3xTF32 at a third of the dense TF32 rate
# (495 TFLOP/s), above the 67 TFLOP/s of f32 FFMA outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_3XTF32_FLOPS = 495e12 / 3
OBJ_RTOL = 1e-8
MESH_RTOL = 1e-9           # a tensor-parallel solve against phase 4's
NCCL_RTOL = 1e-12          # ... on a world of 1
MESH_DD_RTOL = 1e-12       # a tensor-parallel "dd" solve against one card's
MESH_ITERS = 2             # two shards reassociate the f32 sprint's sums
GRAPH_RTOL = 1e-12         # the hsd loop's CUDA graph against eager
RANK_TIMEOUT_S = 300
INTPT_RTOL = 1e-6          # intpt stops at ipm_eps = 1e-6 (core/config.py)
FEAS_RTOL = 1e-6
X_RTOL = 1e-3              # the QP's card and CPU points (see check_qp)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def check_kernel(syrk, torch):
    """Phase 3: returns (max |kernel - plain| at the head shape, kernel ms,
    plain ms, the set of (shape, layout) held against the plain version)."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(shape, spread=False, transposed=False, step=1, offset=0):
        *lead, m, n = shape
        xs = (*lead, n, m) if transposed else (*lead, m, offset + n * step)
        X = torch.randn(xs, generator=gen, device="cuda")
        if transposed:
            X = X.mT                      # strides (.., 1, m): read in place
        else:
            X = X[..., offset::step]      # a view: unaligned base or stride
        u = torch.rand((*lead, n), generator=gen, device="cuda")
        s = 10.0 ** (16.0 * u - 8.0) if spread else 0.5 + 1.5 * u
        e = 0.5 + 1.5 * torch.rand((*lead, m), generator=gen, device="cuda")
        return X, s, e

    cases = [("pallas-test", (256, 512), {}), ("pallas-test", (128, 1024), {}),
             ("pallas-test", (256, 256), {}), ("head", (2560, 4096), {}),
             ("ragged", (1000, 1537), {}),
             ("transposed", (2560, 4096), {"transposed": True}),
             ("batch", (3, 256, 512), {}),
             ("spread", (2560, 4096), {"spread": True}),
             # edges of the copy paths: cp.async of the transposed view,
             # a column step, an unaligned base, a tile smaller than one
             # wgmma, a batch of transposed views by TMA
             ("ragged-transposed", (1001, 1537), {"transposed": True}),
             ("strided", (300, 700), {"step": 2}),
             ("offset", (257, 513), {"offset": 1}),
             ("tiny", (7, 5), {}),
             ("batch-transposed", (2, 300, 200), {"transposed": True}),
             # intpt's dual form on the ranged smoke LP (phase 5): A' of
             # the padded 6656 x 4096 canonical A
             ("dual-form", (4096, 6656), {"transposed": True}),
             # the QP's dual form (phase 6): A' of the padded 2048 x 1024 A
             ("qp-dual-form", (1024, 2048), {"transposed": True}),
             # the batched solves (phases 10, 11): the hsd class's UbTail
             # heads and the intpt class's dual-form A'
             ("batch-hsd", (16, 1024, 1536), {}),
             ("batch-intpt", (8, 1024, 1536), {"transposed": True}),
             # the mesh phases (13, 15): a rank's column shard of the
             # smoke LP's head and of the phase-10 class
             ("tp-shard", (2560, 2048), {}),
             ("dp-tp-shard", (8, 1024, 768), {}),
             # phase 17: a rank's 8 lanes of the phase-10 class, all columns;
             # tools/multichip_scaling.py --ranks 4: a rank's 4 lanes
             ("dp-shard", (8, 1024, 1536), {}),
             ("dp-shard-4", (4, 1024, 1536), {}),
             # phase 19: the PILOT87-shaped LP's UbTail head, padded
             ("pilot87-head", (2560, 5120), {})]
    head_err = None
    checked = set()
    for label, shape, kw in cases:
        X, s, e = inputs(shape, **kw)
        checked.add((tuple(X.shape), syrk.layout(X)))
        Mk = syrk.scaled_syrk_cuda(X, s, e)
        torch.cuda.synchronize()
        Mp = syrk.scaled_syrk_reference(X, s, e)
        torch.cuda.synchronize()
        M64 = syrk.scaled_syrk_reference(X.double(), s.double(), e.double())
        G = syrk.scaled_syrk_reference(X.double().abs(), s.double().abs(),
                                       e.double().abs())
        rk = ((Mk.double() - M64).abs() / G).max().item()
        rp = ((Mp.double() - M64).abs() / G).max().item()
        kp = (Mk - Mp).abs().max().item()
        ok = (torch.isfinite(Mk).all().item() and rk <= BOUND
              and ((Mk.double() - Mp.double()).abs()
                   <= 2 * BOUND * G).all().item())
        if label == "pallas-test":
            ok = ok and torch.allclose(Mk.double(), M64, rtol=RTOL, atol=ATOL)
        print(f"kernel {label} {tuple(X.shape)} strides {X.stride()} "
              f"[{syrk.route(X)}]: "
              f"max|k-f64|/G {rk:.3e}  max|plain-f64|/G {rp:.3e}  "
              f"max|k-plain| {kp:.3e}  {'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            fail(f"kernel disagrees at {label} {tuple(X.shape)}")
        if label == "head":
            head_err = kp

    def ms(fn, reps=20):
        for _ in range(3):
            fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    times = {}
    for label, shape, kw, want in (
            ("head", (2560, 4096), {}, "tma"),
            ("transposed", (2560, 4096), {"transposed": True}, "tma"),
            ("ragged", (1000, 1537), {}, "cp.async"),
            ("dual-form", (4096, 6656), {"transposed": True}, "tma"),
            ("qp-dual-form", (1024, 2048), {"transposed": True}, "tma"),
            ("batch-hsd", (16, 1024, 1536), {}, "tma"),
            ("batch-intpt", (8, 1024, 1536), {"transposed": True}, "tma"),
            ("tp-shard", (2560, 2048), {}, "tma"),
            ("dp-tp-shard", (8, 1024, 768), {}, "tma"),
            ("dp-shard", (8, 1024, 1536), {}, "tma"),
            ("dp-shard-4", (4, 1024, 1536), {}, "tma")):
        X, s, e = inputs(shape, **kw)
        if syrk.route(X) != want:
            fail(f"{label} {tuple(X.shape)} took {syrk.route(X)}, not {want}")
        plain = lambda: syrk.scaled_syrk_reference(X, s, e)
        kern = lambda: syrk.scaled_syrk_cuda(X, s, e)
        p1, k1, k2, p2 = ms(plain), ms(kern), ms(kern), ms(plain)
        t_k, t_p = (k1 + k2) / 2, (p1 + p2) / 2
        b_ms, b_by = bound(shape)
        times[label] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                            bound_by=b_by)
        *lead, m, n = shape
        rate = lower_tile_flops(m, n) * (lead[0] if lead else 1) / t_k / 1e9
        print(f"kernel time {label} {tuple(X.shape)} [{want}]: kernel "
              f"{t_k:.4f} ms ({k1:.4f}, {k2:.4f})  plain torch (cuBLAS) "
              f"{t_p:.4f} ms ({p1:.4f}, {p2:.4f})  [{rate:.1f} TFLOP/s of "
              f"lower-tile work; bound {b_ms:.4f} ms by {b_by}, "
              f"{100 * b_ms / t_k:.1f} % of it]", flush=True)
    return head_err, times, checked


def bound(shape):
    """(least ms, "bytes" or "operations") of M = X diag(s) X' + diag(e)
    for X of `shape`: the exact lower triangle's m(m+1)/2 * n multiply-adds
    at the 3xTF32 rate against X, s, e read once and M written once at the
    HBM rate."""
    *lead, m, n = shape
    B = lead[0] if lead else 1
    flops = B * m * (m + 1) / 2 * n * 2
    nbytes = B * (m * n + n + m + m * m) * 4
    t_ops, t_bytes = flops / F32_3XTF32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def record_kernel_shapes(syrk):
    """Wrap the kernel's wrapper so that every (shape, layout) a solve
    hands it is recorded; returns the set it fills."""
    seen = set()
    launch = syrk.scaled_syrk_cuda

    def recorded(X, s, e):
        seen.add((tuple(X.shape), syrk.layout(X)))
        return launch(X, s, e)

    syrk.scaled_syrk_cuda = recorded
    return seen


def lower_tile_flops(m, n, tile=128):
    """2n flops for every entry of M in the kernel's lower tiles (i >= j)."""
    sizes = [min(tile, m - r) for r in range(0, m, tile)]
    return 2.0 * n * sum(a * b for i, a in enumerate(sizes)
                         for b in sizes[:i + 1])


def hgmma_count(library: str, nvcc: str) -> int:
    """HGMMA (wgmma) instructions in the built library's SASS."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                         text=True, check=True).stdout
    return sum(line.count("HGMMA") for line in out.splitlines())


def highs_objective(lp):
    """scipy HiGHS (interior point) on an LP in b <= Ax <= b+r form."""
    import numpy as np
    from scipy.optimize import linprog
    from scipy.sparse import csc_matrix, vstack
    A = csc_matrix((lp.A, lp.iA, lp.kA), shape=(lp.m, lp.n)).tocsr()
    eq = lp.r == 0.0
    lower = ~eq                                   # b <= a'x  ->  -a'x <= -b
    upper = np.isfinite(lp.r) & ~eq               # a'x <= b + r
    A_ub = vstack([-A[lower], A[upper]])
    b_ub = np.concatenate([-lp.b[lower], (lp.b + lp.r)[upper]])
    bounds = [(None if np.isinf(lo) else lo, None if np.isinf(hi) else hi)
              for lo, hi in zip(lp.l, lp.u)]
    sign = -1.0 if lp.maximize else 1.0
    res = linprog(sign * lp.c, A_ub=A_ub, b_ub=b_ub, A_eq=A[eq],
                  b_eq=lp.b[eq], bounds=bounds, method="highs-ipm")
    if res.status != 0:
        fail(f"HiGHS did not solve the smoke LP: {res.message}")
    return sign * res.fun + lp.f


def solve_end_to_end(syrk, torch, m=2000, n=4000, device="cuda"):
    """Phase 4: returns (the kernel's launch count in the solve, the HiGHS
    objective, the MPS path, the objective, the iterations)."""
    from vanderbei_tpu_torch import cli, read_mps, write_lp
    from vanderbei_tpu_torch.utils.randlp import random_bounded_lp
    work = os.path.join(syrk.BUILD_DIR, "smoke")
    os.makedirs(work, exist_ok=True)
    mps = os.path.join(work, f"rand{m}.mps")
    out = os.path.join(work, f"rand{m}.out")
    if os.path.exists(out):
        os.remove(out)
    t0 = time.perf_counter()
    write_lp(random_bounded_lp(m, n, density=0.02, seed=0), mps)
    t_gen = time.perf_counter() - t0

    syrk.reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([mps, "--device", device, "--out", out])
    t_cli = time.perf_counter() - t0
    launches = syrk.launch_count()
    text = buf.getvalue()
    if rc != 0:
        fail(f"cli returned {rc}")
    if "optimal solution" not in text.splitlines():
        fail(f"solve not optimal:\n{text}")
    if not os.path.exists(out):
        fail("no .out written")
    obj = float(re.search(r"primal objective: (\S+)", text).group(1))
    iters = int(re.search(r"iterations: (\d+)", text).group(1))
    stages = re.findall(r"stage (.+?): iterations (\d+), ([0-9.]+) s", text)
    if not any(p == "f32" and int(k) > 0 for p, k, _ in stages):
        fail(f"no f32 stage ran: {stages}")
    if launches <= 0:
        fail("the solve launched the scaled_syrk kernel 0 times")

    t0 = time.perf_counter()
    ref = highs_objective(read_mps(mps))
    t_ref = time.perf_counter() - t0
    rel = abs(obj - ref) / max(1.0, abs(ref))
    stage_txt = ", ".join(f"{p} {k} it {float(t):.3f} s" for p, k, t in stages)
    print(f"solve {m}x{n} LP on {device}: OPTIMAL obj {obj!r} vs HiGHS(ipm, "
          f"read-back MPS) {ref!r} rel {rel:.3e}; {iters} iterations "
          f"[{stage_txt}]; kernel launches {launches}; cli {t_cli:.2f} s, "
          f"LP generation + MPS write {t_gen:.2f} s, HiGHS {t_ref:.2f} s",
          flush=True)
    if not rel <= OBJ_RTOL:
        fail(f"objective {obj!r} is {rel:.3e} from HiGHS {ref!r}")
    return launches, ref, mps, obj, iters


def run_cli(args):
    """cli.main(args) in this process; fails unless it returns 0.  Returns
    (stdout, seconds, status line, objective, iterations, stages)."""
    from vanderbei_tpu_torch import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    secs = time.perf_counter() - t0
    text = buf.getvalue()
    if rc != 0:
        fail(f"cli {args} returned {rc}")
    from vanderbei_tpu_torch.core.status import STATUS_MESSAGES
    status = next((l for l in text.splitlines() if l in STATUS_MESSAGES), "")
    obj = float(re.search(r"primal objective: (\S+)", text).group(1))
    iters = int(re.search(r"iterations: (\d+)", text).group(1))
    stages = [(p, int(k), float(t)) for p, k, t in
              re.findall(r"stage (.+?): iterations (\d+), ([0-9.]+) s", text)]
    return text, secs, status, obj, iters, stages


def stage_text(stages):
    return ", ".join(f"{p} {k} it {t:.3f} s" for p, k, t in stages)


def check_intpt(syrk, mps, device="cuda"):
    """Phase 5: returns the kernel's launch count in the solve.

    intpt runs on the smoke LP with each equality row b <= a'x <= b
    widened to b <= a'x <= b + 1, which keeps the canonical shape (an
    equality row, like a ranged one, appends its upper side as a row).
    On the smoke LP itself intpt, the JAX package's as much as this one,
    stops DUAL_INFEASIBLE: canonicalize turns each equality into a pair of
    opposed inequalities, so the primal has no interior, and the dual-form
    KKT solve breaks down at iteration 29 (PERF.md)."""
    import numpy as np
    from vanderbei_tpu_torch import read_mps, write_lp
    lp = read_mps(mps)
    lp.r = np.where(lp.r == 0.0, 1.0, lp.r)
    ranged = mps[:-len(".mps")] + "r.mps"
    write_lp(lp, ranged)
    ref = highs_objective(read_mps(ranged))
    syrk.reset_counts()
    text, secs, status, obj, iters, stages = run_cli(
        [ranged, "--method", "intpt", "--device", device, "--no-out"])
    launches, routes = syrk.launch_count(), dict(syrk.route_launches)
    if status != "optimal solution":
        fail(f"intpt not optimal:\n{text}")
    if not any(p == "f32" and k > 0 for p, k, _ in stages):
        fail(f"intpt ran no f32 stage: {stages}")
    if launches <= 0:
        fail("intpt launched the scaled_syrk kernel 0 times")
    if any(not key.endswith("/transposed") for key in routes):
        fail(f"intpt launched the kernel off the transposed layout: {routes}")
    rel = abs(obj - ref) / max(1.0, abs(ref))
    print(f"intpt on the ranged smoke LP on {device}: OPTIMAL obj {obj!r} vs HiGHS "
          f"{ref!r} rel {rel:.3e}; {iters} iterations [{stage_text(stages)}];"
          f" kernel launches {launches} {routes}; cli {secs:.2f} s",
          flush=True)
    if not rel <= INTPT_RTOL:
        fail(f"intpt objective {obj!r} is {rel:.3e} from HiGHS {ref!r}")
    return launches


def max_violation(lp, x):
    """Largest violation of b <= Ax <= b + r and l <= x <= u, each relative
    to 1 + |its bound|."""
    import numpy as np
    from scipy.sparse import csc_matrix
    act = csc_matrix((lp.A, lp.iA, lp.kA), shape=(lp.m, lp.n)) @ x

    def worst(over, bound):
        fin = np.isfinite(bound)
        return np.max(over[fin] / (1.0 + np.abs(bound[fin])), initial=0.0)

    hi = lp.b + lp.r
    return max(worst(lp.b - act, lp.b), worst(act - hi, hi),
               worst(lp.l - x, lp.l), worst(x - lp.u, lp.u))


def check_qp(syrk, work, device="cuda", m=500, n=1000):
    """Phase 6: returns the kernel's launch count in the card's CLI solve.

    The CLI prints no point, so the card's x comes from the same solve run
    in process after it.  Stopping at intpt's 1e-6 gap fixes x only to
    about 1e-4 relative (|dx| / (1 + |x|)): on the CPU, mixed solves of
    this file with 1 to 8 torch threads part by up to 6.5e-6 and from the
    f64 solve by 5.7e-5; before its MPS round trip the QP's mixed solves
    part by 1.0e-4, each up to 4.6e-4 from a solve to a 1e-10 gap.  Two
    points within 5e-4 of the optimum lie within X_RTOL = 1e-3 of each
    other."""
    import numpy as np
    import vanderbei_tpu_torch as vtt
    from vanderbei_tpu_torch.utils.randlp import random_bounded_qp
    mps = os.path.join(work, f"randq{m}.mps")
    vtt.write_lp(random_bounded_qp(m, n, seed=0), mps)
    lp = vtt.read_mps(mps)
    syrk.reset_counts()
    text, secs, status, obj, iters, stages = run_cli(
        [mps, "--method", "hsd", "--device", device, "--no-out"])
    launches = syrk.launch_count()
    route_line = "QUADS present: routing method 'hsd' -> 'intpt' (QP-capable)"
    if route_line not in text.splitlines():
        fail(f"the QP was not routed to intpt:\n{text}")
    if status != "optimal solution":
        fail(f"QP not optimal on {device}:\n{text}")
    if launches <= 0:
        fail("the QP solve launched the scaled_syrk kernel 0 times")
    card = vtt.solve(lp, method="hsd", device=device)
    t0 = time.perf_counter()
    cpu = vtt.solve(lp, method="hsd", device="cpu")
    t_cpu = time.perf_counter() - t0
    rel = abs(obj - cpu.primal_obj) / max(1.0, abs(cpu.primal_obj))
    viol_card, viol_cpu = max_violation(lp, card.x), max_violation(lp, cpu.x)
    dx = float(np.max(np.abs(card.x - cpu.x) / (1.0 + np.abs(cpu.x))))
    print(f"qp {m}x{n} (QUADS, routed to intpt) on {device}: OPTIMAL obj "
          f"{obj!r}, {iters} iterations [{stage_text(stages)}], kernel "
          f"launches {launches}, cli {secs:.2f} s; cpu (plain versions): "
          f"status {cpu.status} obj {cpu.primal_obj!r}, {cpu.iterations} "
          f"iterations, {t_cpu:.2f} s; rel {rel:.3e}; max row/bound "
          f"violation: card's point {viol_card:.3e}, cpu's {viol_cpu:.3e}; "
          f"max |x_card - x_cpu| / (1 + |x_cpu|) {dx:.3e}", flush=True)
    if card.status != 0:
        fail(f"the in-process QP solve on {device} ended with status "
             f"{card.status}")
    if cpu.status != 0:
        fail(f"the CPU QP solve ended with status {cpu.status}")
    if abs(iters - cpu.iterations) > 3:
        fail(f"QP iterations {iters} on {device} vs {cpu.iterations} on cpu")
    if not rel <= OBJ_RTOL:
        fail(f"QP objective {obj!r} is {rel:.3e} from the CPU's")
    if not max(viol_card, viol_cpu) <= FEAS_RTOL:
        fail(f"a QP primal point violates the file by "
             f"{max(viol_card, viol_cpu):.3e}")
    if not dx <= X_RTOL:
        fail(f"the card's and the CPU's QP points part by {dx:.3e}")
    return launches


def lane_objective(canon, c, x):
    """One lane's objective in its LP's own sense, as evaluate.py forms
    it from the canonical c and x."""
    n = canon.n
    sign = 1.0 if canon.maximize else -1.0
    return sign * (canon.obj_scale * float(c[:n] @ x[:n]) + canon.f)


def seeded_lps(work, tag, dims, ranged=False):
    """The seeded random_bounded_lp of each (m, n, seed), written to MPS
    and read back; ranged widens each equality row to a range of width 1
    (phase 5's twin)."""
    import numpy as np
    from vanderbei_tpu_torch import read_mps, write_lp
    from vanderbei_tpu_torch.utils.randlp import random_bounded_lp
    lps = []
    for j, (m, n, seed) in enumerate(dims):
        lp = random_bounded_lp(m, n, density=0.02, seed=seed)
        if ranged:
            lp.r = np.where(lp.r == 0.0, 1.0, lp.r)
        mps = os.path.join(work, f"{tag}{j}.mps")
        write_lp(lp, mps)
        lps.append(read_mps(mps))
    return lps


def check_batch(syrk, torch, card, work, method, dims, granularity=512,
                want_key=None, rtol=OBJ_RTOL, ranged=False, device="cuda"):
    """Phases 10-12: one size class of seeded LPs through the batched
    solver of `method`, as evaluate.run_sweep_batched groups and stacks
    them; every lane must be OPTIMAL from the batched solve itself (no
    per-problem rescue) and within rtol of HiGHS on its read-back LP.
    Returns the kernel's launch count in the solve, each lane's
    iterations (pivots) and the HiGHS objectives."""
    import numpy as np
    from vanderbei_tpu_torch import SolverConfig
    from vanderbei_tpu_torch.parallel import batch as pb
    cfg = SolverConfig()
    lps = seeded_lps(work, f"b{method}", dims, ranged)
    classes, aborted = pb.group_by_class(
        lps, granularity=granularity, use_ub_structure=(method == "hsd"),
        scale=cfg.scale, free_vars=cfg.free_vars)
    if aborted or len(classes) != 1:
        fail(f"batch-{method}: {len(classes)} classes, aborted {aborted}")
    (key, entries), = classes.items()
    if want_key is not None and key != want_key:
        fail(f"batch-{method}: class {key}, not {want_key}")
    if key[0] == "s":
        A, b, c, ub = pb.stack_class_structured(entries, *key[1:])
    else:
        A, b, c = pb.stack_class(entries, *key)
        ub = None
    t0 = time.perf_counter()
    refs = [highs_objective(lp) for lp in lps]
    t_ref = time.perf_counter() - t0
    stages = []
    syrk.reset_counts()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if method == "hsd":
        out = pb.solve_batch_hsd(A, b, c, ub=ub, corrector=cfg.hsd_corrector,
                                 device=device, stages=stages)
    elif method == "intpt":
        out = pb.solve_batch_intpt(
            A, b, c, max_iter=cfg.max_iter or 200, eps=cfg.ipm_eps,
            gap_floor=1.0e-2 if cfg.scale != "none" else 1.0,
            div_detect=cfg.div_detect, device=device, stages=stages)
    else:
        out = pb.solve_batch_pd(A, b, c, max_iter=cfg.max_iter or 20_000,
                                refresh_every=cfg.refresh_every,
                                seed=cfg.seed, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, routes = syrk.launch_count(), dict(syrk.route_launches)
    st, x, iters = (t.cpu().numpy() for t in (out[0], out[1], out[5]))
    objs = [lane_objective(canon, c[j], x[j])
            for j, (_, canon) in enumerate(entries)]
    rels = [abs(o - refs[idx]) / max(1.0, abs(refs[idx]))
            for o, (idx, _) in zip(objs, entries)]
    B = len(entries)
    stage_txt = "; ".join(
        f"{s['precision']} iterations max {int(s['iterations'].max())} sum "
        f"{int(s['iterations'].sum())}, {s['seconds']:.3f} s"
        for s in stages) or (f"pivots per lane {iters.tolist()}, "
                             f"{iters.sum() / secs:.0f} lane pivots/s, "
                             f"{iters.max() / secs:.0f} pivots/s of the "
                             f"batch")
    print(f"batch-{method} on {device} ({card}): class {key}, {B} lanes, "
          f"A {tuple(A.shape)}; statuses {st.tolist()}; {stage_txt}; wall "
          f"{secs:.3f} s, {B / secs:.2f} lanes/s; max rel vs HiGHS "
          f"{max(rels):.3e}; kernel launches {launches} {routes}; HiGHS "
          f"{t_ref:.2f} s", flush=True)
    if not np.all(st == 0):
        fail(f"batch-{method}: lanes not OPTIMAL: {st.tolist()}")
    if not max(rels) <= rtol:
        fail(f"batch-{method}: objectives {max(rels):.3e} from HiGHS")
    if method in ("hsd", "intpt"):
        f32 = [s for s in stages if s["precision"] == "f32"]
        if not f32 or int(f32[0]["iterations"].max()) <= 0:
            fail(f"batch-{method}: no f32 stage ran")
        if device == "cuda" and launches != int(f32[0]["iterations"].max()):
            fail(f"batch-{method}: {launches} kernel launches for "
                 f"{int(f32[0]['iterations'].max())} f32 iterations")
        layout = "k-contiguous" if method == "hsd" else "transposed"
        if any(not k.endswith("/" + layout) for k in routes):
            fail(f"batch-{method}: kernel off the {layout} layout: {routes}")
    return launches, iters, refs


def hsd_class(work, lanes=16):
    """Phase 10's class, rebuilt from its MPS files as check_batch builds
    it: (key, entries, (A, b, c, ub))."""
    from vanderbei_tpu_torch import SolverConfig, read_mps
    from vanderbei_tpu_torch.parallel import batch as pb
    cfg = SolverConfig()
    lps = [read_mps(os.path.join(work, f"bhsd{j}.mps")) for j in range(lanes)]
    classes, _ = pb.group_by_class(lps, granularity=512, use_ub_structure=True,
                                   scale=cfg.scale, free_vars=cfg.free_vars)
    (key, entries), = classes.items()
    return key, entries, pb.stack_class_structured(entries, *key[1:])


def rank_runs(torch, device, run, summarize):
    """On one rank of a mesh phase: run() three times, cold (the checked
    run), warm, and warm under torch.profiler.  Returns one record per
    run: summarize(run()), its seconds, its kernel launches by (shape,
    layout), and for the profiled run the device-busy share."""
    from vanderbei_tpu_torch.ops import syrk
    from vanderbei_tpu_torch.utils.profiling import busy_share, device_trace
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    runs = []
    for label in ("cold", "warm", "profiled"):
        syrk.reset_counts()
        sync()
        prof = (device_trace(cuda) if label == "profiled"
                else contextlib.nullcontext())
        with prof:
            t0 = time.perf_counter()
            out = run()
            sync()
            secs = time.perf_counter() - t0
        rec = summarize(out)
        rec.update(label=label, seconds=secs,
                   launch_shapes=dict(syrk.launch_shapes))
        if label == "profiled":
            rec["busy"] = busy_share(prof, secs)
        runs.append(rec)
    return runs


def mesh_tp_rank(rank, world, device, mps):
    """Phase 13 on one rank: the smoke LP tensor-parallel over `world`
    model ranks."""
    import torch
    import vanderbei_tpu_torch as vtt
    from vanderbei_tpu_torch.parallel.mesh import make_mesh
    lp = vtt.read_mps(mps)
    mesh = make_mesh(world, model_parallel=world, device_type=device.type)
    return rank_runs(
        torch, device, lambda: vtt.solve(lp, device=device, mesh=mesh),
        lambda sol: dict(status=sol.status, iterations=sol.iterations,
                         obj=sol.primal_obj, stages=sol.stages))


def pair_rank(rank, world, device, mps, work):
    """Phases 13, 16 and 17 on one of the ranks that share the card, in one
    spawn: mesh-tp's runs, mesh-dd's, and tools/multichip_scaling's on
    phase 10's class."""
    from vanderbei_tpu_torch.tools import multichip_scaling as mcs
    return dict(tp=mesh_tp_rank(rank, world, device, mps),
                dd=mesh_dd_rank(rank, world, device, mps),
                dp=mcs.scaling_rank(rank, world, device, dp_class, (work,)))


def run_pair(mps, work, world=2, device="cuda:0"):
    """pair_rank on `world` ranks on `device` under gloo: each phase's
    records ("tp", "dd", "dp") in rank order, and the seconds from the
    spawn to the end."""
    from vanderbei_tpu_torch.parallel.distributed import run_ranks
    t0 = time.perf_counter()
    results = run_ranks(pair_rank, world, "gloo", device,
                        timeout_s=RANK_TIMEOUT_S, args=(mps, work))
    return ({k: [r[k] for r in results] for k in ("tp", "dd", "dp")},
            time.perf_counter() - t0)


def mesh_batch_rank(rank, world, device, work):
    """Phase 15 on one rank of a (world / 2, 2) mesh: its block of phase
    10's class, solved and gathered."""
    import torch
    from vanderbei_tpu_torch import SolverConfig
    from vanderbei_tpu_torch.parallel import batch as pb
    from vanderbei_tpu_torch.parallel.mesh import make_mesh
    _, _, (A, b, c, ub) = hsd_class(work)
    mesh = make_mesh(world, model_parallel=2, device_type=device.type)
    A_k, b_k, c_k, i_k, w_k = pb.shard_batch([A, b, c, ub.idx2, ub.w2], mesh,
                                             model_axis_dims=(2, None, 1))
    corrector = SolverConfig().hsd_corrector

    def run():
        stages = []
        out = pb.solve_batch_hsd(A_k, b_k, c_k, ub=pb.UbTail(i_k, w_k),
                                 corrector=corrector, device=device,
                                 stages=stages, mesh=mesh)
        return pb.gather_lanes(out, mesh), stages

    def summarize(res):
        (st, x, _, _, _, it), stages = res
        return dict(status=st.cpu().numpy(), x=x.cpu().numpy(),
                    iters=it.cpu().numpy(), stages=stages)
    return rank_runs(torch, device, run, summarize)


def collectives(stages, iterations):
    """A solve's all-reduces and bytes per iteration, and the share of its
    stages' wall spent in all-reduce calls (ColumnShards.counts)."""
    calls = sum(s["all_reduces"] for s in stages)
    nbytes = sum(s["all_reduce_bytes"] for s in stages)
    share = (sum(s["all_reduce_seconds"] for s in stages)
             / sum(s["seconds"] for s in stages))
    return (f"{calls / iterations:.1f} all-reduces and "
            f"{nbytes / iterations / 1e6:.3f} MB per iteration, "
            f"{100 * share:.1f} % of the stages' wall in all-reduce calls")


def check_mesh_tp(card, runs, t_all, mps, ref, obj4, it4, seen, world=2,
                  device="cuda:0", shard=((2560, 2048), "k-contiguous")):
    """Phase 13 on the ranks' mesh_tp_rank records (run_pair): returns the
    kernel's launches, summed over the ranks, in the checked (cold)
    solve."""
    for rank_runs_ in runs:
        for rec in rank_runs_:
            seen.update(rec["launch_shapes"])
    # the same solve() call on the card alone, cold then warm, for its wall
    import torch
    import vanderbei_tpu_torch as vtt
    lp = vtt.read_mps(mps)
    single = []
    for _ in range(2):
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        vtt.solve(lp, device=device)
        single.append(time.perf_counter() - t1)
    cold = [r[0] for r in runs]
    if len({(c["status"], c["iterations"], c["obj"]) for c in cold}) != 1:
        fail(f"mesh-tp: the ranks disagree: "
             f"{[(c['status'], c['iterations'], c['obj']) for c in cold]}")
    sol = cold[0]
    obj, iters = sol["obj"], sol["iterations"]
    rel4 = abs(obj - obj4) / max(1.0, abs(obj4))
    rel = abs(obj - ref) / max(1.0, abs(ref))
    f32 = sum(s["iterations"] for s in sol["stages"]
              if s["precision"] == "f32")
    traffic = collectives(sol["stages"], iters)
    stage_rows = [(s["precision"], s["iterations"], s["seconds"])
                  for s in sol["stages"]]
    walls = ", ".join(f"{r['label']} {r['seconds']:.3f} s" for r in runs[0])
    busy = ", ".join(f"rank {k} {100 * r[2]['busy']:.1f} %"
                     for k, r in enumerate(runs))
    print(f"mesh-tp on {card}: {world} ranks on {device} (gloo), status "
          f"{sol['status']} on every rank, obj {obj!r} vs phase 4 "
          f"{obj4!r} rel {rel4:.3e}, vs HiGHS rel {rel:.3e}; {iters} "
          f"iterations (phase 4: {it4}) [{stage_text(stage_rows)}]; "
          f"kernel launches by rank {[c['launch_shapes'] for c in cold]}; "
          f"wall of rank 0: {walls} (one solve() on the card alone: cold "
          f"{single[0]:.3f} s, warm {single[1]:.3f} s); device busy in the "
          f"profiled solve: {busy}; {traffic}; spawn to end of phases 13, "
          f"16 and 17 {t_all:.2f} s", flush=True)
    if sol["status"] != 0:
        fail(f"mesh-tp: status {sol['status']}")
    if not (rel4 <= MESH_RTOL and rel <= OBJ_RTOL):
        fail(f"mesh-tp: objective {obj!r} is {rel4:.3e} from phase 4's and "
             f"{rel:.3e} from HiGHS")
    if abs(iters - it4) > MESH_ITERS:
        fail(f"mesh-tp: {iters} iterations against phase 4's {it4}")
    if f32 <= 0 or any(c["launch_shapes"] != {shard: f32} for c in cold):
        fail(f"mesh-tp: not one launch at {shard} per f32 iteration ({f32})"
             f" on each rank: {[c['launch_shapes'] for c in cold]}")
    return sum(c["launch_shapes"][shard] for c in cold)


def check_mesh_nccl(syrk, torch, mps, obj4, it4, device="cuda:0",
                    backend="nccl"):
    """Phase 14: returns the kernel's launch count in the solve."""
    import torch.distributed as dist
    import vanderbei_tpu_torch as vtt
    from vanderbei_tpu_torch.parallel.mesh import make_mesh
    lp = vtt.read_mps(mps)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(tmp, "store"),
            rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        try:
            mesh = make_mesh(1, model_parallel=1,
                             device_type=torch.device(device).type)
            syrk.reset_counts()
            t0 = time.perf_counter()
            sol = vtt.solve(lp, device=device, mesh=mesh)
            secs = time.perf_counter() - t0
            launches = syrk.launch_count()
            backend = dist.get_backend(mesh.get_group("model"))
        finally:
            dist.destroy_process_group()
    rel = abs(sol.primal_obj - obj4) / max(1.0, abs(obj4))
    print(f"mesh-nccl: world 1 ({backend}), status {sol.status}, obj "
          f"{sol.primal_obj!r} vs phase 4 rel {rel:.3e}; {sol.iterations} "
          f"iterations (phase 4: {it4}); kernel launches {launches}; "
          f"{secs:.3f} s; {collectives(sol.stages, sol.iterations)}",
          flush=True)
    if sol.status != 0 or sol.iterations != it4 or not rel <= NCCL_RTOL:
        fail("mesh-nccl: not phase 4's solve")
    if launches <= 0:
        fail("mesh-nccl launched the scaled_syrk kernel 0 times")
    return launches


def check_mesh_batch(card, work, refs, lane_iters, seen, world=4,
                     device="cuda:0",
                     shard=((8, 1024, 768), "k-contiguous")):
    """Phase 15: returns the kernel's launches, summed over the ranks, in
    the checked (cold) solve."""
    import numpy as np
    from vanderbei_tpu_torch.parallel.distributed import run_ranks
    t0 = time.perf_counter()
    results = run_ranks(mesh_batch_rank, world, "gloo", device,
                        timeout_s=RANK_TIMEOUT_S, args=(work,))
    t_all = time.perf_counter() - t0
    runs = results
    for rank_runs_ in runs:
        for rec in rank_runs_:
            seen.update(rec["launch_shapes"])
    cold = [r[0] for r in runs]
    for other in cold[1:]:
        if not all(np.array_equal(cold[0][k], other[k])
                   for k in ("status", "iters", "x")):
            fail("mesh-batch: the ranks assembled different classes")
    key, entries, (_, _, c, _) = hsd_class(work)
    st, x, iters = cold[0]["status"], cold[0]["x"], cold[0]["iters"]
    rels = [abs(lane_objective(canon, c[j], x[j]) - refs[idx])
            / max(1.0, abs(refs[idx])) for j, (idx, canon) in
            enumerate(entries)]
    d_it = np.abs(iters - np.asarray(lane_iters))
    f32 = [int(s["iterations"].max()) for r in cold for s in r["stages"]
           if s["precision"] == "f32"]
    traffic = collectives(cold[0]["stages"],
                          sum(int(s["iterations"].max())
                              for s in cold[0]["stages"]))
    walls = ", ".join(f"{r['label']} {r['seconds']:.3f} s" for r in runs[0])
    busy = ", ".join(f"rank {k} {100 * r[2]['busy']:.1f} %"
                     for k, r in enumerate(runs))
    print(f"mesh-batch on {card}: class {key} on a (2, 2) mesh, {world} "
          f"ranks on {device} (gloo), a rank's block {shard[0]}; statuses "
          f"{st.tolist()}; iterations {iters.tolist()} (phase 10 "
          f"{np.asarray(lane_iters).tolist()}, max diff {int(d_it.max())}); "
          f"max rel vs "
          f"HiGHS {max(rels):.3e}; f32 iterations by rank {f32}, kernel "
          f"launches by rank {[r['launch_shapes'] for r in cold]}; wall of "
          f"rank 0: {walls}; device busy in the profiled solve: {busy}; "
          f"rank 0: {traffic}; spawn to end {t_all:.2f} s", flush=True)
    if not np.all(st == 0):
        fail(f"mesh-batch: lanes not OPTIMAL: {st.tolist()}")
    if not max(rels) <= OBJ_RTOL:
        fail(f"mesh-batch: objectives {max(rels):.3e} from HiGHS")
    if int(d_it.max()) > MESH_ITERS:
        fail(f"mesh-batch: iterations {iters.tolist()} against phase 10's "
             f"{np.asarray(lane_iters).tolist()}")
    if min(f32) <= 0 or any(r["launch_shapes"] != {shard: k}
                            for r, k in zip(cold, f32)):
        fail(f"mesh-batch: not one launch at {shard} per f32 iteration on "
             f"each rank: {f32}, {[r['launch_shapes'] for r in cold]}")
    return sum(r["launch_shapes"][shard] for r in cold)


def mesh_dd_rank(rank, world, device, mps):
    """Phase 16 on one rank: the LP of `mps` tensor-parallel over `world`
    model ranks in precision "dd", cold then warm, then in "f64" (the
    collectives' twin).  Each record: the solution, its seconds, the
    kernel's launches by (shape, layout)."""
    import torch
    import vanderbei_tpu_torch as vtt
    from vanderbei_tpu_torch.ops import syrk
    from vanderbei_tpu_torch.parallel.mesh import make_mesh
    lp = vtt.read_mps(mps)
    mesh = make_mesh(world, model_parallel=world, device_type=device.type)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: 0)
    runs = []
    for label, precision in (("cold", "dd"), ("warm", "dd"), ("f64", "f64")):
        syrk.reset_counts()
        sync()
        t0 = time.perf_counter()
        sol = vtt.solve(lp, config=vtt.SolverConfig(precision=precision),
                        device=device, mesh=mesh)
        sync()
        runs.append(dict(label=label, seconds=time.perf_counter() - t0,
                         status=sol.status, iterations=sol.iterations,
                         obj=sol.primal_obj, x=sol.x, stages=sol.stages,
                         launch_shapes=dict(syrk.launch_shapes)))
    return runs


def collective_ops(stage):
    """A stage's all-reduces by method (ColumnShards.counts), and its
    all-reduces less 5 a refinement pass (4 sums and the residual's MAX)
    and 1 a factor retry (an ANY): with the same iterations, the same
    number for every precision whose collectives pair one for one."""
    ops = {k[len("all_reduces_"):]: v for k, v in stage.items()
           if k.startswith("all_reduces_") and v}
    core = (stage["all_reduces"] - 5 * stage["all_reduces_max"]
            - stage["all_reduces_any"])
    return ops, core


def check_mesh_dd(card, runs, tp_stages, mps, ref, world=2,
                  device="cuda:0"):
    """Phase 16 on the ranks' mesh_dd_rank records (run_pair): precision
    "dd" tensor-parallel against the single-card "dd" solve of the same
    LP, its traffic beside the f64 mesh solve's and mesh-tp's f64 stage
    (tp_stages: phase 13's stage records); returns the kernel's launches,
    summed over the ranks (none: "dd" has no f32 stage)."""
    import numpy as np
    import torch
    import vanderbei_tpu_torch as vtt
    lp = vtt.read_mps(mps)
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    single = vtt.solve(lp, config=vtt.SolverConfig(precision="dd"),
                       device=device)
    t_single = time.perf_counter() - t1
    cold, warm, f64 = runs[0]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            if not ((a["status"], a["iterations"], a["obj"])
                    == (b["status"], b["iterations"], b["obj"])
                    and np.array_equal(a["x"], b["x"])):
                fail(f"mesh-dd: the ranks disagree in the {a['label']} "
                     f"solve")
    rel1 = abs(cold["obj"] - single.primal_obj) / max(1.0,
                                                      abs(single.primal_obj))
    rel = abs(cold["obj"] - ref) / max(1.0, abs(ref))
    (dd_stage,), (f64_stage,) = cold["stages"], f64["stages"]
    dd_ops, dd_core = collective_ops(dd_stage)
    f64_ops, f64_core = collective_ops(f64_stage)
    launches = [r[0]["launch_shapes"] for r in runs]
    tp_f64 = [s for s in tp_stages if s["precision"] == "f64"]
    print(f"mesh-dd on {card}: {world} ranks on {device} (gloo), status "
          f"{cold['status']} on every rank (the same bits), obj "
          f"{cold['obj']!r} vs the single-card dd solve "
          f"{single.primal_obj!r} rel {rel1:.3e}, vs HiGHS rel {rel:.3e}; "
          f"{cold['iterations']} iterations (single dd: "
          f"{single.iterations}, f64 mesh: {f64['iterations']}); "
          f"all-reduces per iteration: dd "
          f"{collectives([dd_stage], cold['iterations'])}, {dd_ops}; f64 "
          f"{collectives([f64_stage], f64['iterations'])}, {f64_ops}; "
          f"mesh-tp's f64 stage "
          f"{collectives(tp_f64, sum(s['iterations'] for s in tp_f64))}; less "
          f"refinement passes and retries: dd {dd_core}, f64 {f64_core}; "
          f"wall: cold {cold['seconds']:.3f} s, warm {warm['seconds']:.3f} "
          f"s, f64 mesh {f64['seconds']:.3f} s; single-card dd solve "
          f"{t_single:.3f} s; kernel launches by rank {launches}",
          flush=True)
    if cold["status"] != 0 or warm["status"] != 0:
        fail(f"mesh-dd: status {cold['status']}, {warm['status']}")
    if abs(cold["iterations"] - single.iterations) > 1:
        fail(f"mesh-dd: {cold['iterations']} iterations against the single "
             f"dd solve's {single.iterations}")
    if not (rel1 <= MESH_DD_RTOL and rel <= OBJ_RTOL):
        fail(f"mesh-dd: objective {rel1:.3e} from the single dd solve's, "
             f"{rel:.3e} from HiGHS")
    if dd_ops.get("sum2", 0) <= 0 or "sum2" in f64_ops:
        fail(f"mesh-dd: compensated sums dd {dd_ops}, f64 {f64_ops}")
    if (cold["iterations"] == f64["iterations"] and dd_core != f64_core):
        fail(f"mesh-dd: dd issued other collectives than f64: {dd_ops} "
             f"against {f64_ops}")
    if any(launches):
        fail(f"mesh-dd launched the kernel: {launches}")
    return sum(sum(n.values()) for n in launches)


def dp_class(work):
    """Phase 10's class for tools/multichip_scaling: (key, arrays)."""
    key, _, arrays = hsd_class(work)
    return key, arrays


def check_dp_scaling(card, results, lane_iters, seen, world=2,
                     device="cuda:0",
                     shard=((8, 1024, 1536), "k-contiguous")):
    """Phase 17 on the ranks' tools/multichip_scaling records (run_pair),
    2 ranks sharing the card (gloo); returns the kernel's launches, summed
    over the ranks, in the first sharded solve."""
    import numpy as np
    from vanderbei_tpu_torch.tools import multichip_scaling as mcs
    line, faults = mcs.summary(results, "gloo", card)
    for r in results:
        for rec in r["single"] + r["sharded"]:
            seen.update(rec["launches"])
    first = [r["sharded"][0] for r in results]
    iters = first[0]["iters"]
    print(f"dp-scaling on {card}: {world} ranks on {device} (gloo), "
          f"batch mesh ({world}, 1); statuses {first[0]['status'].tolist()}; "
          f"iterations {iters.tolist()} (phase 10 "
          f"{np.asarray(lane_iters).tolist()}); t_single_s "
          f"{line['t_single_s']:.4f}, t_sharded_s {line['t_sharded_s']:.4f},"
          f" overhead_frac {line['overhead_frac']:.4f}; device busy by rank "
          f"{[round(100 * b, 1) for b in line['busy']]} %; f32 iterations "
          f"by rank {[r['f32_iters'] for r in first]}, kernel launches by "
          f"rank {[r['launches'] for r in first]}", flush=True)
    print(f"dp-scaling: {json.dumps(line)}", flush=True)
    if faults:
        fail(f"dp-scaling: {faults}")
    if not np.array_equal(iters, np.asarray(lane_iters)):
        fail(f"dp-scaling: iterations {iters.tolist()} against phase 10's "
             f"{np.asarray(lane_iters).tolist()}")
    if any(r["f32_iters"] <= 0 or r["launches"] != {shard: r["f32_iters"]}
           for r in first):
        fail(f"dp-scaling: not one launch at {shard} per f32 iteration on "
             f"each rank: {[(r['f32_iters'], r['launches']) for r in first]}")
    return sum(r["launches"][shard] for r in first)


def graph_counts(rec):
    """(captures, replays, redos, the f32 stages' replays that launched
    the kernel: every replay there, live or not, and every redo) a
    recording counted."""
    precision = {s[0]: s[6].get("precision") for s in rec.spans
                 if s[3] == "stage"}
    tot = dict.fromkeys(("captures", "replays", "redos"), 0)
    f32 = 0
    for sid, counts in rec.counts.items():
        for k in tot:
            tot[k] += counts.get(f"hsd.graph.{k}", 0)
        if precision.get(sid) == "f32":
            f32 += (counts.get("host_reads.hsd.graph", 0)
                    + counts.get("hsd.graph.redos", 0))
    return tot["captures"], tot["replays"], tot["redos"], f32


def check_hsd_graph(syrk, torch, device="cuda"):
    """Phase 19: returns the graph solves' kernel launches (warm)."""
    from vanderbei_tpu_torch import solve
    from vanderbei_tpu_torch.models import hsd
    from vanderbei_tpu_torch.utils import profiling
    from vanderbei_tpu_torch.utils.randlp import random_bounded_lp
    lps = {"smoke 2000x4000": random_bounded_lp(2000, 4000, density=0.02,
                                                seed=0),
           "pilot87 2030x4883": random_bounded_lp(2030, 4883, density=0.02,
                                                  seed=1)}
    real = hsd._graph_engages
    hsd._GRAPHS.clear()       # phase 4 captured the smoke LP's graphs
    total = 0
    for name, lp in lps.items():
        runs = {}
        for mode in ("eager", "graph"):
            if mode == "eager":
                hsd._graph_engages = lambda *args: False
            try:
                with profiling.recording() as cold:
                    solve(lp, device=device)
                syrk.reset_counts()
                with profiling.recording() as warm:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    sol = solve(lp, device=device)
                    secs = time.perf_counter() - t0
                runs[mode] = (sol, secs, dict(syrk.route_launches),
                              graph_counts(cold), graph_counts(warm))
            finally:
                hsd._graph_engages = real
        (se, te, le, _, ce), (sg, tg, lg, cg_cold, cg) = (runs["eager"],
                                                          runs["graph"])
        rel = abs(sg.primal_obj - se.primal_obj) / max(1.0, abs(se.primal_obj))
        share = cg[2] / cg[1] if cg[1] else float("nan")
        print(f"hsd-graph {name} on {device}: status {sg.status} / eager "
              f"{se.status}, iterations {sg.iterations} / {se.iterations}, "
              f"objective rel {rel:.3e}; kernel launches {lg} / eager {le} "
              f"({cg[3]} f32 replays and redos); captures cold "
              f"{cg_cold[0]} warm {cg[0]}, replays {cg[1]}, redos "
              f"{cg[2]} (share {share:.3f}); warm {tg:.3f} s / eager "
              f"{te:.3f} s ({te / tg:.2f}x)", flush=True)
        if ce[:3] != (0, 0, 0):
            fail(f"the forced-eager solve of {name} used the graph: {ce}")
        if (sg.status, sg.iterations) != (se.status, se.iterations):
            fail(f"{name}: graph {sg.status}/{sg.iterations} against eager "
                 f"{se.status}/{se.iterations}")
        if not rel <= GRAPH_RTOL:
            fail(f"{name}: objectives {rel:.3e} apart")
        # the same paths; a replay launches the kernel whether or not its
        # step is kept, and a redo launches it once more
        if set(lg) != set(le) or sum(lg.values()) != cg[3]:
            fail(f"{name}: launches {lg}, eager {le}, f32 replays and redos "
                 f"{cg[3]}")
        if cg_cold[0] == 0 or cg[0] != 0 or cg[1] == 0:
            fail(f"{name}: captures {cg_cold[0]} cold, {cg[0]} warm, "
                 f"replays {cg[1]}")
        total += sum(lg.values())
    return total


def check_dd_metrics(work, device="cuda", m=500, n=1000):
    """Phase 7."""
    import numpy as np
    import vanderbei_tpu_torch as vtt
    from vanderbei_tpu_torch.utils.randlp import random_bounded_lp
    mps = os.path.join(work, f"rand{m}.mps")
    csv = os.path.join(work, f"rand{m}.metrics.csv")
    if os.path.exists(csv):
        os.remove(csv)
    vtt.write_lp(random_bounded_lp(m, n, seed=1), mps)
    text, secs, status, obj, iters, stages = run_cli(
        [mps, "--precision", "dd", "--metrics", csv, "--device", device,
         "--no-out"])
    if status != "optimal solution":
        fail(f"dd not optimal:\n{text}")
    ref = highs_objective(vtt.read_mps(mps))
    rel = abs(obj - ref) / max(1.0, abs(ref))
    rows = np.genfromtxt(csv, delimiter=",", names=True)
    mu = rows["mu"]
    drop = mu[0] / mu[-1]
    print(f"dd {m}x{n} on {device}: OPTIMAL obj {obj!r} vs HiGHS {ref!r} rel "
          f"{rel:.3e}; {iters} iterations [{stage_text(stages)}]; cli "
          f"{secs:.2f} s (solve + metrics run); metrics: {len(rows)} rows, "
          f"mu {mu[0]:.3e} -> {mu[-1]:.3e} (x{drop:.2e})", flush=True)
    if not rel <= OBJ_RTOL:
        fail(f"dd objective {obj!r} is {rel:.3e} from HiGHS {ref!r}")
    if not all(np.isfinite(rows[k]).all() for k in rows.dtype.names):
        fail("the metrics CSV holds a non-finite value")
    if not (len(rows) > 1
            and np.array_equal(rows["iter"], np.arange(len(rows)))):
        fail("the metrics CSV is not one row per iteration")
    if not drop >= 1e8:
        fail(f"mu fell only x{drop:.2e} over the metrics run")


def check_simplex(work, device="cuda", m=300, n=600):
    """Phase 8."""
    import vanderbei_tpu_torch as vtt
    from vanderbei_tpu_torch.utils.randlp import random_bounded_lp
    mps = os.path.join(work, f"rand{m}.mps")
    vtt.write_lp(random_bounded_lp(m, n, seed=0), mps)
    ref = highs_objective(vtt.read_mps(mps))
    for method in ("pd", "twophase"):
        text, secs, status, obj, pivots, stages = run_cli(
            [mps, "--method", method, "--device", device, "--no-out"])
        if status != "optimal solution":
            fail(f"{method} not optimal:\n{text}")
        rel = abs(obj - ref) / max(1.0, abs(ref))
        loop_s = stages[0][2]
        print(f"{method} {m}x{n} on {device}: OPTIMAL obj {obj!r} vs HiGHS "
              f"{ref!r} rel {rel:.3e}; {pivots} pivots in {loop_s:.3f} s "
              f"({pivots / loop_s:.0f} pivots/s), cli {secs:.2f} s",
              flush=True)
        if not rel <= OBJ_RTOL:
            fail(f"{method} objective {obj!r} is {rel:.3e} from HiGHS")


def check_native(mps):
    """Phase 9."""
    import dataclasses
    import numpy as np
    from vanderbei_tpu_torch import native
    from vanderbei_tpu_torch.io.mps import read_mps
    t0 = time.perf_counter()
    got = read_mps(mps, engine="native")
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = read_mps(mps, engine="python")
    t_python = time.perf_counter() - t0
    # the native reader leaves the RHS/RANGES/BOUNDS set names empty
    skip = ("rhs_name", "ranges_name", "bounds_name")
    for f in dataclasses.fields(want):
        if f.name in skip:
            continue
        a, b = getattr(want, f.name), getattr(got, f.name)
        same = (np.array_equal(a, b) and np.asarray(a).dtype
                == np.asarray(b).dtype) if isinstance(a, np.ndarray) else a == b
        if not same:
            fail(f"native reader differs from the python reader in {f.name}")
    print(f"native reader ({native.library_path()}): {want.m} x {want.n}, "
          f"{want.nz} nonzeros, equal to the python reader's LP; "
          f"{t_native:.3f} s vs {t_python:.3f} s", flush=True)


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from vanderbei_tpu_torch.ops import syrk

    card = card_line()
    print(f"device: {card}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    library = syrk.build()
    ptxas = " ".join(l.split("info    :")[-1].strip()
                     for l in syrk.build_log.splitlines() if "Used" in l)
    print(f"build: {library} in {time.perf_counter() - t0:.2f} s "
          f"({ptxas or 'cached build'})", flush=True)
    for line in syrk.build_log.splitlines():
        if "warning" in line.lower() or "Performance Loss" in line:
            print(f"build: {line.strip()}", flush=True)
    hgmma = hgmma_count(library, syrk._nvcc())
    print(f"build: {hgmma} HGMMA instructions in the library's SASS",
          flush=True)
    if hgmma == 0:
        fail("the built kernel has no wgmma (HGMMA) instruction")

    # each phase's end, in seconds from the start, for the total's split
    ends = {}
    end = lambda name: ends.setdefault(
        name, round(time.perf_counter() - t_start, 1))
    err, times, checked = check_kernel(syrk, torch)
    end("kernel")
    seen = record_kernel_shapes(syrk)
    by_path = {}
    by_path["hsd"], ref4, mps, obj4, it4 = solve_end_to_end(syrk, torch)
    end("solve")
    by_path["intpt"] = check_intpt(syrk, mps)
    end("intpt")
    work = os.path.dirname(mps)
    by_path["qp"] = check_qp(syrk, work)
    end("qp")
    by_path["batch-hsd"], lane_iters, lane_refs = check_batch(
        syrk, torch, card, work, "hsd",
        [(560 + 4 * j, 1100 + 9 * j, j) for j in range(16)],
        want_key=("s", 1024, 1536, 1536))
    end("batch-hsd")
    by_path["batch-intpt"], _, _ = check_batch(
        syrk, torch, card, work, "intpt",
        [(400 + 10 * j, 800 + 20 * j, j) for j in range(8)],
        want_key=(1536, 1024), rtol=INTPT_RTOL, ranged=True)
    end("batch-intpt")
    check_batch(syrk, torch, card, work, "pd",
                [(300 + 10 * j, 600 + 20 * j, j) for j in range(4)],
                want_key=(1024, 1024))
    end("batch-pd")
    pair, t_pair = run_pair(mps, work)
    by_path["mesh-tp"] = check_mesh_tp(card, pair["tp"], t_pair, mps, ref4,
                                       obj4, it4, seen)
    end("mesh-tp")
    by_path["mesh-nccl"] = check_mesh_nccl(syrk, torch, mps, obj4, it4)
    end("mesh-nccl")
    by_path["mesh-batch"] = check_mesh_batch(card, work, lane_refs,
                                             lane_iters, seen)
    end("mesh-batch")
    by_path["mesh-dd"] = check_mesh_dd(card, pair["dd"],
                                       pair["tp"][0][0]["stages"], mps, ref4)
    end("mesh-dd")
    by_path["dp-scaling"] = check_dp_scaling(card, pair["dp"], lane_iters,
                                             seen)
    end("dp-scaling")
    by_path["hsd-graph"] = check_hsd_graph(syrk, torch)
    end("hsd-graph")
    unchecked = seen - checked
    print(f"kernel shapes of the solves: {sorted(seen)}; each held against "
          f"the plain version in phase 3: {not unchecked}", flush=True)
    if unchecked:
        fail(f"the solves gave the kernel shapes phase 3 did not check: "
             f"{sorted(unchecked)}")
    check_dd_metrics(work)
    end("dd")
    check_simplex(work)
    end("simplex")
    check_native(mps)
    end("native")
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s; phases ended at (s): "
          f"{ends}", flush=True)

    # the kernel's line: its times at the hsd head, the other timed
    # layouts beside them; no one PyTorch call computes X diag(s) X' +
    # diag(e), so library_ms is null (plain_ms is the cuBLAS product)
    print(json.dumps({"kernels": [{
        "name": "scaled_syrk", "route": "cuda",
        "source": "vanderbei_tpu_torch/csrc/scaled_syrk.cu",
        "replaces": "vanderbei_tpu/ops/pallas_kernels.py:35",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": err, **times["head"], "library_ms": None,
        "layouts": times}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
