"""Netlib sweep harness: the evaluate/ results tree, the port of
vanderbei_tpu/evaluate.py.

    python -m vanderbei_tpu_torch.evaluate --method hsd --out evaluate/t1
    python -m vanderbei_tpu_torch.evaluate --batch --device cpu --out DIR

Each problem of the corpus (io/netlib.py: VANDERBEI_TPU_NETLIB) gets
NAME.mps.sol with the status line and final objectives; README.md
tabulates (rows, cols, nonzeros, objective-or-status) like the reference's
per-solver README tables, with a column diffing against the reference's
own outcome when VANDERBEI_TPU_REFERENCE_EVAL names the reference's
evaluate/.../netlib tree, and the canonical netlib optima
(io/netlib_golden.py).

--batch solves the small and mid problems through the batched path
(parallel/batch.py): one stacked solve per size class.  --device is cuda
by default and raises without a CUDA device; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import fcntl
import json
import os
import re
import time

import torch

from .core.canonicalize import canon_dims, canonicalize
from .core.config import SolverConfig
from .core.status import Status, status_message
from .io import netlib
from .models.registry import (resolve_device, size_class as reg_size_class,
                              solve)
from .parallel import batch as pbatch

# the reference's method -> results-directory mapping (link-time binaries)
REF_DIR_FOR_METHOD = {"hsd": "ipo", "hsdls": "ipo", "intpt": "ipo",
                      "pd": "simpo", "twophase": "simpo"}


def reference_eval_dir() -> str | None:
    """The reference's evaluate/<version>/netlib tree, if one is named."""
    return os.environ.get("VANDERBEI_TPU_REFERENCE_EVAL")


def reference_outcomes(method: str) -> dict:
    """Parse the reference's README table: NAME -> objective | status text.

    The tables record the solver-view objective (the negated original-sense
    objective for min problems, matching its iteration logs).
    """
    d, root = REF_DIR_FOR_METHOD.get(method), reference_eval_dir()
    if d is None or root is None:
        return {}
    path = os.path.join(root, d, "README.md")
    if not os.path.exists(path):
        return {}
    out = {}
    pat = re.compile(r"^\|\s*\[([A-Z0-9.\-]+)\]\([^)]*\)\s*\|[^|]*\|[^|]*\|"
                     r"[^|]*\|\s*([^|]+?)\s*\|\s*$")
    with open(path) as fp:
        for line in fp:
            mm = pat.match(line.strip())
            if mm:
                out[mm.group(1)] = mm.group(2)
    return out


def reference_iterations(method: str) -> dict:
    """NAME -> the reference solver's iteration/pivot count, parsed from the
    last trace row of each captured .sol log of the reference tree."""
    d, root = REF_DIR_FOR_METHOD.get(method), reference_eval_dir()
    if d is None or root is None:
        return {}
    root = os.path.join(root, d)
    if not os.path.isdir(root):
        return {}
    out = {}
    for fn in os.listdir(root):
        if not fn.endswith(".mps.sol"):
            continue
        name = fn[:-len(".mps.sol")].upper()
        last = None
        try:
            with open(os.path.join(root, fn), errors="replace") as fp:
                for line in fp:
                    toks = line.split()
                    if toks and toks[0].isdigit():
                        last = int(toks[0])
        except OSError:
            continue
        if last is not None:
            out[name] = last
    return out


def _client_alive(device) -> bool:
    """Health-check the device after an exception: a sticky CUDA error
    (an illegal address, a launch failure) poisons the process, and every
    later solve would fail in milliseconds.  A tiny op with fresh content
    and a synchronize tells the truth whatever the exception said; the CPU
    is always alive."""
    device = torch.device(device)
    if device.type != "cuda":
        return True
    try:
        v = torch.full((2,), time.monotonic(), device=device)
        float(v.sum())
        torch.cuda.synchronize(device)
        return True
    except Exception:
        return False


def _make_record(name: str, lp, status, obj, iters, elapsed: float,
                 ref: dict) -> dict:
    """Assemble one results-tree row (golden/relative-error bookkeeping)."""
    fname, rows, cols, nz, _flags, _tbl = netlib.NETLIB_GOLDEN[name]
    golden = netlib.ondisk_objective(name)
    status = int(status)
    rel = (abs(obj - golden) / max(1.0, abs(golden))
           if status == int(Status.OPTIMAL) else float("inf"))
    sense = 1.0 if lp.maximize else -1.0
    rel_ref = float("inf")
    if status == int(Status.OPTIMAL) and name in ref:
        try:
            ref_obj = float(ref[name])
            rel_ref = abs(ref_obj - sense * obj) / max(1.0, abs(ref_obj))
        except ValueError:
            pass
    return dict(name=name, rows=rows, cols=cols, nonzeros=nz,
                status=status, objective=float(obj), golden=golden,
                solver_view=sense * float(obj),
                relerr=rel, relerr_ref=rel_ref, iterations=int(iters),
                seconds=round(elapsed, 3))


def run_sweep(method: str = "hsd", out_dir: str | None = None,
              max_rows: int | None = None, max_cols: int | None = None,
              names: list[str] | None = None, config: SolverConfig | None = None,
              progress: bool = True, time_limit: float | None = None,
              device="cuda"):
    """Solve the netlib corpus one problem at a time; returns a list of
    per-problem records.  Problems run smallest-first; time_limit
    (seconds, per problem) bounds stragglers (TIMLIM)."""
    device = resolve_device(device)
    if names is None:
        names = netlib.available_problems(max_rows=max_rows,
                                          max_cols=max_cols)
    cfg = config or SolverConfig()
    if time_limit:
        cfg = cfg.with_(time_limit=float(time_limit))
    ref = reference_outcomes(method)
    records = []
    for name in names:
        lp = netlib.load(name)
        t0 = time.perf_counter()
        try:
            sol = solve(lp, method=method, config=cfg, device=device)
            status, obj, iters = sol.status, sol.primal_obj, sol.iterations
        except Exception as e:      # record, don't abort the sweep
            status, obj, iters = -2, float("nan"), 0
            if progress:
                print(f"{name}: ERROR {e}")
            if not _client_alive(device):
                # the device is poisoned: record this row, then signal the
                # sweep driver (nonzero exit) so it re-runs the chunk's
                # remaining problems one per process
                rec = _make_record(name, lp, status, obj, 0,
                                   time.perf_counter() - t0, ref)
                records.append(rec)
                if out_dir:
                    write_record(out_dir, method, rec)
                    write_readme(out_dir, method, records)
                raise SystemExit(9)
        rec = _make_record(name, lp, status, obj, iters,
                           time.perf_counter() - t0, ref)
        records.append(rec)
        if progress:
            _print_rec(rec, method)
        if out_dir:
            write_record(out_dir, method, rec)
            write_readme(out_dir, method, records)   # incremental: a crash
            # mid-sweep leaves a valid partial results tree
    return records


def _print_rec(rec: dict, method: str) -> None:
    tag = ("ok" if rec["relerr"] < 1e-6 else
           "ok(ref)" if rec["relerr_ref"] < 1e-6 else
           ("OBJ-MISMATCH" if rec["status"] == int(Status.OPTIMAL)
            else status_message(rec["status"]) if rec["status"] >= 0
            else "error"))
    print(f"{rec['name']:10s} {method:8s} {tag:14s} "
          f"obj={rec['objective']:.7e} iters={rec['iterations']} "
          f"{rec['seconds']:.2f}s", flush=True)


def run_sweep_batched(method: str = "hsd", out_dir: str | None = None,
                      names: list[str] | None = None,
                      config: SolverConfig | None = None,
                      progress: bool = True,
                      max_batch: int = 2048, granularity: int = 512,
                      time_limit: float | None = None, device="cuda"):
    """Corpus sweep through the batched path.

    Small and mid problems (size class <= max_batch in both dims) stack
    into padded classes and solve as ONE batched two-stage solve per
    class.  Lanes whose batched verdict is not OPTIMAL re-solve through
    registry.solve (quality-gate retries included).  Problems beyond
    max_batch run one at a time via run_sweep.  time_limit bounds every
    solve the sweep makes."""
    device = resolve_device(device)
    if names is None:
        names = netlib.available_problems()
    cfg = config or SolverConfig()
    if time_limit:
        cfg = cfg.with_(time_limit=float(time_limit))
    ref = reference_outcomes(method)
    records = []

    def emit(rec):
        records.append(rec)
        if progress:
            _print_rec(rec, method)
        if out_dir:
            write_record(out_dir, method, rec)
            write_readme(out_dir, method, records)

    # partition into batchable classes vs the per-problem tail, with ONE
    # canonicalization per problem
    use_ub = method in ("hsd", "hsdls") and cfg.use_ub_structure
    small_names, small_lps, big_names = [], [], []
    classes: dict = {}
    for name in names:
        lp = netlib.load(name)
        # dims-only probe first: large instances route to the per-problem
        # path without materializing their dense canonical form here
        mc, nc, st_probe = canon_dims(lp, free_vars=cfg.free_vars)
        if st_probe != int(Status.RUNNING):
            emit(_make_record(name, lp, st_probe, 0.0, 0, 0.0, ref))
            continue
        if not (reg_size_class(mc) <= max_batch
                and reg_size_class(nc) <= max_batch):
            big_names.append(name)
            continue
        canon = canonicalize(lp, pad_to=1, dtype=cfg.dtype,
                             free_vars=cfg.free_vars, scale=cfg.scale)
        assert canon.status == int(Status.RUNNING)
        idx = len(small_names)
        small_names.append(name)
        small_lps.append(lp)
        key = pbatch.class_key(canon, granularity, use_ub)
        classes.setdefault(key, []).append((idx, canon))

    for key, entries in sorted(classes.items(),
                               key=lambda kv: max(kv[0][1:])):
        t0 = time.perf_counter()
        try:
            recs = _solve_batched_class(method, key, entries, small_names,
                                        small_lps, cfg, ref, device)
        except Exception as e:
            if progress:
                print(f"class {key}: ERROR {e}", flush=True)
            if not _client_alive(device):
                for idx, _ in entries:
                    emit(_make_record(small_names[idx], small_lps[idx], -2,
                                      float("nan"), 0,
                                      time.perf_counter() - t0, ref))
                if out_dir:
                    write_readme(out_dir, method, records)
                raise SystemExit(9)
            # device alive: fall back to per-problem for this class
            recs = None
        if recs is None:
            sub = run_sweep(method=method, out_dir=out_dir,
                            names=[small_names[i] for i, _ in entries],
                            config=cfg, progress=progress,
                            time_limit=time_limit, device=device)
            records.extend(sub)
            continue
        per_lane_s = (time.perf_counter() - t0) / max(1, len(entries))
        for (idx, _), (st, obj, iters, extra_s) in zip(entries, recs):
            emit(_make_record(small_names[idx], small_lps[idx], st, obj,
                              iters, per_lane_s + extra_s, ref))

    # the big tail runs per-problem (two-stage ladder)
    if big_names:
        sub = run_sweep(method=method, out_dir=out_dir, names=big_names,
                        config=cfg, progress=progress,
                        time_limit=time_limit, device=device)
        records.extend(sub)
    return records


def _solve_batched_class(method, key, entries, small_names, small_lps, cfg,
                         ref=None, device="cuda"):
    """Solve one stacked class; returns [(status, obj, iters, extra_s)]
    aligned with entries.  Non-OPTIMAL lanes re-solve per-problem through
    registry.solve inside this helper (their wall time lands in extra_s),
    EXCEPT lanes whose non-optimal verdict matches the reference's own
    recorded outcome for that problem (the infeasible/unbounded netlib
    instances)."""
    canons = [(None, canon) for _, canon in entries]
    M, N = key[-2], key[-1]
    if method in ("hsd", "hsdls"):
        if key[0] == "s":
            _, M1, N, K = key
            A, b, c, ub = pbatch.stack_class_structured(canons, M1, N, K)
        else:
            A, b, c = pbatch.stack_class(canons, M, N)
            ub = None
        st, x, y, w, z, iters = pbatch.solve_batch_hsd(
            A, b, c, ub=ub, long_step=(method == "hsdls"),
            corrector=cfg.hsd_corrector, device=device)
    elif method == "intpt":
        A, b, c = pbatch.stack_class(canons, M, N)
        st, x, y, w, z, iters = pbatch.solve_batch_intpt(
            A, b, c, max_iter=cfg.max_iter or 200, eps=cfg.ipm_eps,
            gap_floor=1.0e-2 if cfg.scale != "none" else 1.0,
            div_detect=cfg.div_detect, device=device)
    elif method == "pd":
        A, b, c = pbatch.stack_class(canons, M, N)
        st, x, y, w, z, iters = pbatch.solve_batch_pd(
            A, b, c, max_iter=cfg.max_iter or 20_000,
            refresh_every=cfg.refresh_every, seed=cfg.seed, device=device)
    else:
        raise ValueError(f"no batched path for method {method!r}")
    st, x, iters = (t.cpu().numpy() for t in (st, x, iters))

    def ref_expects_failure(name) -> bool:
        """True when the reference's own table records a NON-objective
        outcome for this problem (e.g. "dual unbounded")."""
        if not ref or name not in ref:
            return False
        try:
            float(ref[name])
            return False
        except ValueError:
            return True

    out = []
    for j, (idx, canon) in enumerate(entries):
        n = canon.n
        sign = 1.0 if canon.maximize else -1.0
        obj = sign * (canon.obj_scale * float(c[j][:n] @ x[j][:n]) + canon.f)
        if (int(st[j]) in (int(Status.PRIMAL_UNBOUNDED),
                           int(Status.PRIMAL_INFEASIBLE),
                           int(Status.DUAL_UNBOUNDED),
                           int(Status.DUAL_INFEASIBLE))
                and ref_expects_failure(small_names[idx])):
            out.append((int(st[j]), obj, int(iters[j]), 0.0))
        elif int(st[j]) != int(Status.OPTIMAL):
            # per-problem rescue: full registry path (quality-gate
            # retries, precision ladder, intpt fallback)
            t0 = time.perf_counter()
            sol = solve(small_lps[idx], method=method, config=cfg,
                        device=device)
            out.append((sol.status, sol.primal_obj,
                        int(iters[j]) + sol.iterations,
                        time.perf_counter() - t0))
        else:
            out.append((int(st[j]), obj, int(iters[j]), 0.0))
    return out


def write_record(out_dir: str, method: str, rec: dict) -> None:
    d = os.path.join(out_dir, "netlib", method)
    os.makedirs(d, exist_ok=True)
    fname = netlib.NETLIB_GOLDEN[rec["name"]][0]
    with open(os.path.join(d, fname + ".sol"), "w") as fp:
        fp.write(f"m = {rec['rows']},n = {rec['cols']},nz = {rec['nonzeros']}\n")
        fp.write(f"iterations = {rec['iterations']}\n")
        fp.write(f"objective  = {rec['objective']:.7e}\n")
        fp.write(f"golden     = {rec['golden']:.7e}\n")
        fp.write(f"seconds    = {rec['seconds']}\n")
        if rec["status"] >= 0:
            fp.write(status_message(rec["status"]) + " \n")
        else:
            fp.write("error \n")


def _ref_agrees(rec: dict, ref_text: str | None) -> str:
    """Compare our outcome with the reference table's cell for the README."""
    if ref_text is None:
        return "—"
    ref_text = ref_text.strip()
    ours_optimal = rec["status"] == int(Status.OPTIMAL)
    try:
        ref_obj = float(ref_text)
        if not ours_optimal:
            return f"ref optimal ({ref_text})"
        # the reference table records the solver-view (canonical max-form)
        # objective; compare against our signed solver-view value
        close = (abs(ref_obj - rec["solver_view"])
                 / max(1.0, abs(ref_obj)) < 1e-4)
        return "agree" if close else f"ref {ref_text}"
    except ValueError:
        if ours_optimal:
            return f"ref: {ref_text}"
        ours = status_message(rec["status"]) if rec["status"] >= 0 else "error"
        return "agree" if ours.startswith(ref_text.split()[0]) else f"ref: {ref_text}"


def write_readme(out_dir: str, method: str, records: list) -> None:
    d = os.path.join(out_dir, "netlib", method)
    os.makedirs(d, exist_ok=True)
    # concurrent sweep chunks (sweep.py --parallel) merge into one
    # records.json; serialize the read-modify-write under a file lock
    with open(os.path.join(d, ".lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        _write_readme_locked(d, method, records)


def _write_readme_locked(d: str, method: str, records: list) -> None:
    # merge with any previously recorded sweep (partial re-runs update
    # their rows in place rather than clobbering the tree)
    prev_path = os.path.join(d, "records.json")
    if os.path.exists(prev_path):
        with open(prev_path) as fp:
            prev = {r["name"]: r for r in json.load(fp)}
        for r in records:
            prev[r["name"]] = r
        order = {n: i for i, n in
                 enumerate(netlib.NETLIB_GOLDEN)}  # corpus order
        records = sorted(prev.values(),
                         key=lambda r: (r["nonzeros"], order.get(r["name"], 0)))
    ref = reference_outcomes(method)
    ref_it = reference_iterations(method)
    n_opt = sum(1 for r in records if r["status"] == int(Status.OPTIMAL))
    n_match = sum(1 for r in records if r["relerr"] < 1e-6)
    n_ref = sum(1 for r in records
                if r["relerr"] < 1e-6 or r.get("relerr_ref", 1) < 1e-6)
    total_s = sum(r["seconds"] for r in records)
    ref_root = reference_eval_dir() or "(no reference tree named)"
    lines = [
        f"# netlib results — method `{method}`",
        "",
        f"{len(records)} problems; {n_opt} optimal; "
        f"{n_match} matching the canonical netlib optimum to 1e-6 relative "
        f"({n_ref} matching it or the reference binary's achieved "
        f"objective on the same file); "
        f"{total_s:.1f}s total wall.",
        "",
        "Reference comparison: the `vs reference` column diffs against the "
        f"corresponding row of `{ref_root}/"
        f"{REF_DIR_FOR_METHOD.get(method, '?')}/README.md`.",
        "",
        "| Name | Rows | Cols | Nonzeros | Objective | Status | Iters | Ref iters | Seconds | vs reference |",
        "|------|-----:|-----:|---------:|----------:|--------|------:|----------:|--------:|--------------|",
    ]
    for r in records:
        obj = (f"{r['objective']:.7e}"
               if r["status"] == int(Status.OPTIMAL) else "—")
        st = (status_message(r["status"]) if r["status"] >= 0 else "error")
        ri = ref_it.get(r["name"], "—")
        lines.append(
            f"| {r['name']} | {r['rows']} | {r['cols']} | {r['nonzeros']} "
            f"| {obj} | {st} | {r['iterations']} | {ri} | {r['seconds']} "
            f"| {_ref_agrees(r, ref.get(r['name']))} |")
    with open(os.path.join(d, "README.md"), "w") as fp:
        fp.write("\n".join(lines) + "\n")
    with open(os.path.join(d, "records.json"), "w") as fp:
        json.dump(records, fp, indent=1, default=float)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vanderbei_tpu_torch.evaluate")
    p.add_argument("--method", default="hsd")
    p.add_argument("--out", default=None)
    p.add_argument("--max-rows", type=int, default=None)
    p.add_argument("--max-cols", type=int, default=None)
    p.add_argument("--names", nargs="*", default=None)
    p.add_argument("--time-limit", type=float, default=None,
                   help="per-problem wall budget in seconds")
    p.add_argument("--batch", action="store_true",
                   help="solve small/mid problems through the batched "
                        "path (one stacked solve per size class)")
    p.add_argument("--max-batch", type=int, default=2048,
                   help="largest size class (both dims) to batch")
    p.add_argument("--granularity", type=int, default=512,
                   help="batched size-class rounding")
    p.add_argument("--max-iter", type=int, default=None,
                   help="iteration/pivot budget override")
    p.add_argument("--ipm-eps", type=float, default=None,
                   help="intpt residual/gap stop (reference 1e-6, "
                        "intpt.c:30)")
    p.add_argument("--precision", default=None,
                   choices=("auto", "mixed", "f32factor", "f64", "dd"))
    p.add_argument("--free-vars", default="split",
                   choices=("split", "reject"),
                   help="'split' solves the free-variable instances the "
                        "reference rejects; 'reject' is reference parity")
    p.add_argument("--no-div-detect", action="store_true",
                   help="disable intpt's divergence-based infeasibility "
                        "certificate (intpt.c:175-182, reference-marked "
                        "'(unreliable)')")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without a "
                        "CUDA device) or cpu")
    args = p.parse_args(argv)
    cfg = SolverConfig(free_vars=args.free_vars)
    if args.no_div_detect:
        cfg = cfg.with_(div_detect=False)
    if args.precision:
        cfg = cfg.with_(precision=args.precision)
    if args.ipm_eps:
        cfg = cfg.with_(ipm_eps=args.ipm_eps)
    if args.max_iter:
        cfg = cfg.with_(max_iter=args.max_iter)
    if args.batch:
        names = args.names or netlib.available_problems(
            max_rows=args.max_rows, max_cols=args.max_cols)
        run_sweep_batched(method=args.method, out_dir=args.out, names=names,
                          config=cfg, max_batch=args.max_batch,
                          granularity=args.granularity,
                          time_limit=args.time_limit, device=args.device)
    else:
        run_sweep(method=args.method, out_dir=args.out,
                  max_rows=args.max_rows, max_cols=args.max_cols,
                  names=args.names, config=cfg,
                  time_limit=args.time_limit, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
