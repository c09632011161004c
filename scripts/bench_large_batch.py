#!/usr/bin/env python
"""Batched dense QPs at n_pad 320 -> 512.

Batched shapes between the small-problem fleets and the single large
problems of `large.py` run the same two-phase pipeline (f32 XLA
while_loop with a masked Schur refactorization + batched Cholesky per
Newton step, then f64 host polish); this bench measures the throughput
curve across those sizes.

Workload: reference randomQP protocol scaled up
(simulations/randomQP.m:22-47 semantics, 50% density, m = 1.5n), each
config solved as one batch, every solve f64-KKT-certified at eps 1e-6
(`solve_large_dense` contract).  Median of `--reps` distinct perturbed
batches; all rep times disclosed.

Run on the GPU: `python scripts/bench_large_batch.py`
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_problems(B, n, m, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        M = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.5)
        Q = M @ M.T / n + 0.1 * np.eye(n)
        A = rng.standard_normal((m, n))
        q = rng.standard_normal(n)
        u = 2 * rng.random(m)
        out.append((Q, A, q, -u, u))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--configs", default="320:64,352:64,384:64,448:64,512:64",
                    help="comma-separated n:B pairs")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    from qpalm_jax.large import solve_large_dense

    rows = []
    for cfg in args.configs.split(","):
        n, B = (int(v) for v in cfg.split(":"))
        m = (3 * n) // 2
        # warm-up/compile on a distinct batch (untimed)
        warm = make_problems(B, n, m, seed=123456 + n)
        solve_large_dense(warm, eps=1e-6)
        times, oks, dev_ts, pol_ts = [], [], [], []
        for r in range(args.reps):
            probs = make_problems(B, n, m, seed=1000 * r + n)
            t0 = time.perf_counter()
            res = solve_large_dense(probs, eps=1e-6)
            times.append(time.perf_counter() - t0)
            oks.append(int(res.ok.sum()))
            dev_ts.append(res.t_device_s)
            pol_ts.append(res.t_polish_s)
        med = statistics.median(times)
        row = {
            "n": n, "m": m, "B": B,
            "solves_per_s": round(B / med, 2),
            "certified": f"{min(oks)}-{max(oks)}/{B}",
            "t_total_reps": [round(t, 3) for t in times],
            "t_device_reps": [round(t, 3) for t in dev_ts],
            "t_polish_reps": [round(t, 3) for t in pol_ts],
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    print("\n| n | m | B | solves/s | certified | device s (med) | "
          "polish s (med) |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['n']} | {r['m']} | {r['B']} | {r['solves_per_s']} "
              f"| {r['certified']} "
              f"| {statistics.median(r['t_device_reps']):.2f} "
              f"| {statistics.median(r['t_polish_reps']):.2f} |")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
