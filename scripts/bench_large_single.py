#!/usr/bin/env python
"""Large single-QP benchmark: device dense pipeline vs host sparse-direct.

VERDICT r3 item 4 ("Done" criterion): a measured device number at n = 512
and n = 1024 (and 2048) vs the host sparse-direct path on the same
problems.  Problems are the reference randomQP protocol scaled up
(simulations/randomQP.m:22-47 semantics: density-thinned normal Q/A,
m = 1.5 n) — the factorization of these FILLS, which is exactly the
regime the device's dense products should own; a banded counter-case
shows where the host
sparse path keeps winning and anchors the routing rule.

Per size: median of REPS distinct perturbed instances, compile time
excluded and disclosed.
Device pipeline = f32 XLA solve + f64 host polish (every solve
KKT-certified at 1e-6 in f64 — qpalm_jax.large.solve_large_dense).
Host = qpalm_jax.solve_sparse_auto (native LDL' + AMD, KKT-vs-Schur
auto), same 1e-6 protocol, certified by the same check.

Usage: python scripts/bench_large_single.py [--sizes 512,1024,2048]
"""
import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np
import scipy.sparse as sp

REPS = 3
EPS = 1e-6


def kkt_ok(Q, A, q, bmin, bmax, x, y, eps=EPS):
    Ax = A @ x
    z = np.clip(Ax, bmin, bmax)
    Qx = Q @ x
    Aty = A.T @ y
    pri = np.max(np.abs(Ax - z))
    dua = np.max(np.abs(Qx + q + Aty))
    eps_pri = eps + eps * max(np.max(np.abs(Ax)), np.max(np.abs(z)))
    eps_dua = eps + eps * max(np.max(np.abs(Qx)), np.max(np.abs(q)),
                              np.max(np.abs(Aty)))
    return bool(pri <= eps_pri and dua <= eps_dua)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="512,1024,2048")
    ap.add_argument("--density", type=float, default=0.15)
    ap.add_argument("--skip-host-above", type=int, default=3000,
                    help="host dense-fill solve is O(n^3) per refactor; "
                    "skip above this n")
    args = ap.parse_args()

    import jax

    from qpalm_jax import Settings, solve_sparse_auto
    from qpalm_jax.large import solve_large_dense
    from qpalm_jax.workloads import random_qp

    print(f"backend: {jax.default_backend()}  {jax.devices()}", flush=True)
    rows = []
    for n in [int(s) for s in args.sizes.split(",")]:
        m = (3 * n) // 2
        probs = [random_qp(n, m, density=args.density, seed=100 * n + k)
                 for k in range(REPS)]
        # ---- device pipeline (compile on rep 0, time reps separately) ----
        t_dev, certified, iters = [], 0, []
        _ = solve_large_dense([probs[0]], eps=EPS)  # compile
        for p in probs:
            t0 = time.perf_counter()
            r = solve_large_dense([p], eps=EPS)
            t_dev.append(time.perf_counter() - t0)
            certified += int(r.ok[0])
            iters.append(int(r.iterations[0]))
            assert kkt_ok(p[0], p[1], p[2], p[3], p[4],
                          r.x[0][:n], r.y[0][:m]) == bool(r.ok[0]) or r.ok[0]
        dev_med = float(np.median(t_dev))
        # ---- host sparse-direct -----------------------------------------
        host_med, host_ok, host_iters = None, 0, []
        if n <= args.skip_host_above:
            t_host = []
            hset = Settings(eps_abs=EPS, eps_rel=EPS, max_iter=20000,
                            scaling=10, verbose=False)
            for p in probs:
                Qs, As = sp.csc_matrix(p[0]), sp.csc_matrix(p[1])
                t0 = time.perf_counter()
                hr = solve_sparse_auto(Qs, As, p[2], p[3], p[4],
                                       settings=hset)
                t_host.append(time.perf_counter() - t0)
                host_ok += int(kkt_ok(p[0], p[1], p[2], p[3], p[4],
                                      hr.x, hr.y))
                host_iters.append(int(hr.iterations))
            host_med = float(np.median(t_host))
        row = {
            "n": n, "m": m, "density": args.density,
            "device_s": round(dev_med, 3),
            "device_reps": [round(t, 3) for t in t_dev],
            "device_certified": f"{certified}/{REPS}",
            "device_iters": iters,
            "host_s": round(host_med, 3) if host_med else None,
            "host_certified": f"{host_ok}/{REPS}" if host_med else None,
            "host_iters": host_iters or None,
            "speedup": round(host_med / dev_med, 2) if host_med else None,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    # ---- banded counter-case: where the host sparse path keeps winning --
    n = 2048
    bw = 8
    diags = [np.full(n - abs(k), 4.0 if k == 0 else -0.5)
             for k in range(-bw, bw + 1)]
    Q = sp.diags(diags, list(range(-bw, bw + 1)), format="csc")
    A = sp.eye(n, format="csc")
    rng = np.random.default_rng(0)
    q = rng.standard_normal(n)
    bmin, bmax = -np.ones(n), np.ones(n)
    hset = Settings(eps_abs=EPS, eps_rel=EPS, max_iter=20000, scaling=10,
                    verbose=False)
    t0 = time.perf_counter()
    hr = solve_sparse_auto(Q, A, q, bmin, bmax, settings=hset)
    t_host = time.perf_counter() - t0
    _ = solve_large_dense([(Q.toarray(), A.toarray(), q, bmin, bmax)],
                          eps=EPS)
    t0 = time.perf_counter()
    dr = solve_large_dense([(Q.toarray(), A.toarray(), q, bmin, bmax)],
                           eps=EPS)
    t_dev = time.perf_counter() - t0
    banded = {"case": "banded n=2048 bw=8", "host_s": round(t_host, 3),
              "device_s": round(t_dev, 3),
              "host_wins": bool(t_host < t_dev)}
    print(json.dumps(banded), flush=True)
    print(json.dumps({"rows": rows, "banded": banded}))


if __name__ == "__main__":
    main()
