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
   transposed views); kernel and plain times, and the kernel's
   TFLOP/s of lower-tile work, at (2560, 4096) (TMA copies), its transposed
   view (TMA) and (1000, 1537) (cp.async copies).
4. solve: a seeded 2000 x 4000 bounded LP (200 equality rows, 2% dense),
   written to MPS and solved through the CLI on the card; it must be
   OPTIMAL within 1e-8 of scipy's HiGHS on the LP read back from the file,
   run an f32 stage, and launch the kernel.
5. the kernels' JSON line, then {"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

# tolerances: |M - M_f64| <= BOUND * (|X| diag|s| |X|' + diag|e|) entrywise
# (f32 accumulation over n terms); RTOL/ATOL as tests/test_pallas.py holds
# the TPU kernel, applied at its shapes, where n <= 1024
BOUND = 1e-4
RTOL, ATOL = 2e-5, 2e-4
OBJ_RTOL = 1e-8


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
    plain ms)."""
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
             ("batch-transposed", (2, 300, 200), {"transposed": True})]
    head_err = None
    for label, shape, kw in cases:
        X, s, e = inputs(shape, **kw)
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
            ("ragged", (1000, 1537), {}, "cp.async")):
        X, s, e = inputs(shape, **kw)
        if syrk.route(X) != want:
            fail(f"{label} {tuple(X.shape)} took {syrk.route(X)}, not {want}")
        plain = lambda: syrk.scaled_syrk_reference(X, s, e)
        kern = lambda: syrk.scaled_syrk_cuda(X, s, e)
        p1, k1, k2, p2 = ms(plain), ms(kern), ms(kern), ms(plain)
        t_k, t_p = (k1 + k2) / 2, (p1 + p2) / 2
        times[label] = (t_k, t_p)
        rate = lower_tile_flops(*shape) / t_k / 1e9
        print(f"kernel time {label} {tuple(X.shape)} [{want}]: kernel "
              f"{t_k:.4f} ms ({k1:.4f}, {k2:.4f})  plain torch {t_p:.4f} ms "
              f"({p1:.4f}, {p2:.4f})  [{rate:.1f} TFLOP/s of lower-tile "
              f"work]", flush=True)
    t_k, t_p = times["head"]
    return head_err, t_k, t_p


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
    """Phase 4: returns the kernel's launch count in the solve."""
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

    syrk.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([mps, "--device", device, "--out", out])
    t_cli = time.perf_counter() - t0
    launches = syrk.launches
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
    return launches


def main() -> int:
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

    err, t_k, t_p = check_kernel(syrk, torch)
    launches = solve_end_to_end(syrk, torch)

    print(json.dumps({"kernels": [{
        "name": "scaled_syrk", "route": "cuda",
        "source": "vanderbei_tpu_torch/csrc/scaled_syrk.cu",
        "replaces": "vanderbei_tpu/ops/pallas_kernels.py:35",
        "launches": launches, "max_abs_err": err, "ms": t_k,
        "plain_ms": t_p}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
