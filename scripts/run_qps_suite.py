#!/usr/bin/env python
"""QPS-suite benchmark harness (the Maros-Meszaros driver).

Equivalent of the reference's MATLAB sweep
(reference: simulations/maros_meszaros/test_maros_meszaros.m:43-106): parse
every .qps/.QPS file in a directory, solve at the reference protocol
(eps_abs = eps_rel = 1e-6 by default), and report per-problem status /
iterations / runtime / objective plus a summary line.

Usage:
  python scripts/run_qps_suite.py DIR [--eps 1e-6] [--platform cpu|gpu]
      [--max-n 2000] [--f32] [--route dense|sparse|auto] [--json out.json]

Problems are bucketed by padded shape so each bucket compiles once; within a
bucket they are solved as one vmapped batch.  `--f32` uses the float32 pass
with f64 escalation of stragglers (see qpalm_jax.batch.solve_batch_escalate).

`--route auto` sends problems with n > --sparse-above to the host
sparse-direct path (qpalm_jax.solve_sparse_auto) one at a time with exact
per-problem wall times — the route for the n ~ 1e3-1e4 Maros-Meszaros bulk
(benchmarks/qps_mm).  Every solved instance is additionally KKT-certified
in f64 on the unscaled problem (primal/dual residuals + complementarity),
independent of the solver's own status flag.
"""

import argparse
import glob
import json
import os
import sys
import time


import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from qpalm_jax.io.cli import PLATFORMS, use_platform  # noqa: E402


def kkt_certify(Q, A, q, bmin, bmax, x, y, eps):
    """Independent f64 KKT check on the unscaled problem (the criteria of
    termination.c:44-129 with identity scaling, plus complementarity).
    Returns (ok, pri_norm, dua_norm)."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    if not (np.all(np.isfinite(x)) and np.all(np.isfinite(y))):
        return False, np.inf, np.inf
    Ax = A @ x
    z = np.clip(Ax, bmin, bmax)
    pri = float(np.max(np.abs(Ax - z))) if Ax.size else 0.0
    Qx = Q @ x
    Aty = A.T @ y
    dua = float(np.max(np.abs(Qx + q + Aty)))
    eps_pri = eps + eps * max(np.max(np.abs(Ax), initial=0.0),
                              np.max(np.abs(z), initial=0.0))
    eps_dua = eps + eps * max(np.max(np.abs(Qx), initial=0.0),
                              np.max(np.abs(q), initial=0.0),
                              np.max(np.abs(Aty), initial=0.0))
    comp = 0.0
    if Ax.size:
        comp = float(np.max(
            np.where(y > eps, np.abs(Ax - bmax), 0.0)
            + np.where(y < -eps, np.abs(Ax - bmin), 0.0), initial=0.0))
    ok = pri <= eps_pri and dua <= eps_dua and comp <= eps_pri + eps
    return ok, pri, dua


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dir")
    ap.add_argument("--eps", type=float, default=1e-6)
    ap.add_argument("--platform", choices=PLATFORMS, default=None,
                    help="JAX backend (default: JAX's default backend)")
    ap.add_argument("--max-n", type=int, default=2000,
                    help="skip problems with more variables (dense memory)")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--route", choices=["dense", "sparse", "auto"],
                    default="dense")
    ap.add_argument("--sparse-above", type=int, default=400,
                    help="auto route: n above this goes to the sparse path")
    ap.add_argument("--json", default=None)
    ap.add_argument("--markdown", default=None,
                    help="write the per-problem results table to this file")
    ap.add_argument("--baseline", action="store_true",
                    help="also run the native single-threaded sparse "
                         "baseline (reference C-QPALM semantics, "
                         "native/qpalm_sparse_baseline.cpp) on every "
                         "sparse-routed problem and report a wall-clock "
                         "comparison column")
    ap.add_argument("--baseline-time-limit", type=float, default=1200.0,
                    help="per-problem wall-clock cap for the baseline (s)")
    args = ap.parse_args(argv)

    use_platform(args.platform)

    from qpalm_jax import Settings
    from qpalm_jax.batch import bucket_indices, solve_batch, solve_batch_escalate
    from qpalm_jax.io import load_qps

    files = sorted(
        glob.glob(os.path.join(args.dir, "*.qps"))
        + glob.glob(os.path.join(args.dir, "*.QPS"))
        + glob.glob(os.path.join(args.dir, "*.SIF"))
    )
    if not files:
        print(f"no QPS files in {args.dir}", file=sys.stderr)
        return 1

    def sparse_routed(p):
        if args.route == "sparse":
            return True
        return args.route == "auto" and p.n > args.sparse_above

    problems, names, skipped, sparse_probs = [], [], [], []
    for f in files:
        try:
            p = load_qps(f)
        except Exception as e:
            skipped.append((os.path.basename(f), f"parse error: {e}"))
            continue
        if sparse_routed(p):
            sparse_probs.append(p)
            continue
        if p.n > args.max_n:
            skipped.append((os.path.basename(f), f"n={p.n} > --max-n"))
            continue
        problems.append((p.Q, p.A, p.q, p.bmin, p.bmax, p.c))
        names.append(p.name or os.path.basename(f))

    if args.f32:
        settings = Settings(
            dtype="float32", eps_abs=max(args.eps, 1e-4),
            eps_rel=max(args.eps, 1e-4), max_iter=500, scaling=10,
            max_refine=2, verbose=False,
        )
        solver = lambda probs: solve_batch_escalate(probs, settings)
    else:
        settings = Settings(
            eps_abs=args.eps, eps_rel=args.eps, max_iter=50000,
            scaling=10, verbose=False,
        )
        solver = lambda probs: solve_batch(probs, settings)

    sizes = [(q.shape[0], bl.shape[0]) for _, _, q, bl, _, _ in problems]
    buckets = bucket_indices(sizes)
    results = [None] * len(problems)
    t_total = 0.0
    for key, idxs in sorted(buckets.items()):
        sub = [problems[i] for i in idxs]
        t0 = time.perf_counter()
        res = solver(sub)
        dt = time.perf_counter() - t0
        t_total += dt
        for j, i in enumerate(idxs):
            Qd, Ad, qv, bl, bu, cc = problems[i]
            ok, pri, dua = kkt_certify(
                Qd, Ad, qv, bl, bu, np.asarray(res.x)[j][: sizes[i][0]],
                np.asarray(res.y)[j][: sizes[i][1]], args.eps)
            results[i] = {
                "name": names[i],
                "n": sizes[i][0],
                "m": sizes[i][1],
                "status": int(np.asarray(res.status)[j]),
                "iter": int(np.asarray(res.iterations)[j]),
                "objective": float(np.asarray(res.objective)[j]),
                "time_s": dt / len(idxs),
                "kkt": bool(ok),
            }
        print(f"bucket {key}: {len(idxs)} problems in {dt:.2f}s")

    # host sparse-direct route (the MM n >= 1e3 bulk)
    if sparse_probs:
        from qpalm_jax import solve_sparse_auto

        sset = Settings(eps_abs=args.eps, eps_rel=args.eps, max_iter=50000,
                        scaling=10, verbose=False)
        for p in sorted(sparse_probs, key=lambda p: p.n):
            t0 = time.perf_counter()
            r = solve_sparse_auto(p.Q, p.A, p.q, p.bmin, p.bmax,
                                  settings=sset, c=p.c)
            dt = time.perf_counter() - t0
            t_total += dt
            ok, pri, dua = kkt_certify(p.Q, p.A, p.q, p.bmin, p.bmax,
                                       r.x, r.y, args.eps)
            row = {
                "name": p.name, "n": p.n, "m": p.m, "status": int(r.status),
                "iter": int(r.iterations), "objective": float(r.objective),
                "time_s": dt, "kkt": bool(ok), "route": "sparse",
            }
            if args.baseline:
                from qpalm_jax import baseline_c
                t0 = time.perf_counter()
                try:
                    rb = baseline_c.solve_sparse(
                        p.Q, p.A, p.q, p.bmin, p.bmax, eps_abs=args.eps,
                        eps_rel=args.eps, max_iter=10 ** 9,
                        scaling=10, rescue=False,
                        time_limit=args.baseline_time_limit)
                    row["baseline_time_s"] = time.perf_counter() - t0
                    row["baseline_iter"] = rb["iter"]
                    row["baseline_status"] = rb["status"]
                    if rb["status"] == 1:
                        okb, _, _ = kkt_certify(
                            p.Q, p.A, p.q, p.bmin, p.bmax, rb["x"],
                            rb["y"], args.eps)
                        row["baseline_kkt"] = bool(okb)
                except Exception as e:  # missing lib / native error
                    row["baseline_status"] = 0
                    row["baseline_error"] = str(e)
            results.append(row)
            base = ""
            if "baseline_time_s" in row:
                base = (f" | base {row['baseline_time_s']:.2f}s "
                        f"it={row['baseline_iter']} "
                        f"st={row['baseline_status']}")
            print(f"sparse {p.name}: n={p.n} m={p.m} "
                  f"status={r.status_str} iter={r.iterations} "
                  f"obj={r.objective:.6e} kkt={'y' if ok else 'N'} "
                  f"{dt:.2f}s{base}", flush=True)

    def expected_status(name):
        """Infeasible instances encode their expected certificate status in
        the name; for everything else 'correct' means solved."""
        if name.startswith("PINF"):
            return -3
        if name.startswith("DINF"):
            return -4
        return 1

    for r in results:
        r["expected"] = expected_status(r["name"])
        r["correct"] = r["status"] == r["expected"] and (
            r["expected"] != 1 or r.get("kkt", True))
    n_correct = sum(1 for r in results if r["correct"])
    n_solved = sum(1 for r in results if r["status"] == 1)
    print(f"\n{'name':<16} {'n':>6} {'m':>7} {'status':>7} {'iter':>7} "
          f"{'kkt':>4} {'time':>8} {'ok':>3} objective")
    for r in results:
        print(f"{r['name']:<16} {r['n']:>6} {r['m']:>7} {r['status']:>7} "
              f"{r['iter']:>7} {'y' if r.get('kkt') else '-':>4} "
              f"{r.get('time_s', 0.0):>7.2f}s "
              f"{'y' if r['correct'] else 'N':>3} "
              f"{r['objective']: .6e}")
    for name, why in skipped:
        print(f"{name:<16} SKIPPED ({why})")
    print(f"\ncorrect {n_correct}/{len(results)} (solved {n_solved}, "
          f"+{len(skipped)} skipped) in {t_total:.2f}s solve time")

    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write("# QPS suite results\n\n")
            f.write(f"Protocol: eps_abs = eps_rel = {args.eps}, scaling 10, "
                    f"max_iter 50000 (reference "
                    f"test_maros_meszaros.m:43-47 / sample_settings.txt).\n"
                    f"`expected` encodes the certificate status infeasible "
                    f"instances must return.\n\n")
            has_base = any("baseline_time_s" in r or
                           "baseline_status" in r for r in results)
            bh = ("| base iter | base time (s) | speedup "
                  if has_base else "")
            bsep = "|---|---|---|" if has_base else ""
            f.write("| name | n | m | status | expected | iter | objective "
                    f"| kkt | time (s) {bh}| ok |\n"
                    f"|---|---|---|---|---|---|---|---|---{bsep}|\n")
            for r in results:
                bcols = ""
                if has_base:
                    if "baseline_time_s" in r:
                        sp = r["baseline_time_s"] / max(r.get("time_s",
                                                              1e-9), 1e-9)
                        st = r.get("baseline_status")
                        mark = "" if st == 1 else f" (status {st})"
                        bcols = (f"| {r.get('baseline_iter', '-')} "
                                 f"| {r['baseline_time_s']:.2f}{mark} "
                                 f"| {sp:.1f}x ")
                    else:
                        bcols = "| - | - | - "
                f.write(
                    f"| {r['name']} | {r['n']} | {r['m']} | {r['status']} "
                    f"| {r['expected']} | {r['iter']} "
                    f"| {r['objective']:.6e} "
                    f"| {'yes' if r.get('kkt') else '-'} "
                    f"| {r.get('time_s', 0.0):.2f} "
                    f"{bcols}| {'yes' if r['correct'] else 'NO'} |\n"
                )
            f.write(f"\n**correct {n_correct}/{len(results)}** in "
                    f"{t_total:.2f}s total solve time.\n")

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"results": results, "skipped": skipped,
                       "solve_time_s": t_total}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
