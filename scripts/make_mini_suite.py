#!/usr/bin/env python
"""Generate the committed mini QPS suite (benchmarks/qps_mini/).

The real Maros-Meszaros corpus is not redistributable here; this writes a
deterministic 12-problem stand-in spanning the reference's benchmark
families (random QPs of several sizes/densities, lasso, portfolio, an MPC
ladder — simulations/randomQP.m, lasso.m, portfolio.m, chain80w) in QPS
format, so `scripts/run_qps_suite.py` exercises the full
parse -> bucket -> batch-solve pipeline offline.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from qpalm_jax.io.qps import save_qps
from qpalm_jax.workloads import lasso, mpc_chain, portfolio, random_qp

OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "benchmarks", "qps_mini",
)


def main():
    os.makedirs(OUT, exist_ok=True)
    problems = {}
    for i, (n, dens) in enumerate([(20, 0.5), (40, 0.3), (40, 0.8),
                                   (80, 0.2), (120, 0.15)]):
        problems[f"RAND{i}"] = random_qp(n, n + n // 2, density=dens, seed=i)
    for i, n in enumerate([8, 14]):
        problems[f"LASSO{i}"] = lasso(n, gamma=1.0 + i, seed=10 + i)
    for i, n in enumerate([30, 60]):
        problems[f"PORTF{i}"] = portfolio(n, gamma=1.0, seed=20 + i)
    for i, (masses, horizon) in enumerate([(3, 6), (4, 8), (5, 10)]):
        H, A, q, bmin, bmax, _ = mpc_chain(masses, horizon, seed=30 + i)
        problems[f"MPC{i}"] = (H, A, q, bmin, bmax)

    for name, (Q, A, q, bmin, bmax) in problems.items():
        path = os.path.join(OUT, f"{name}.qps")
        save_qps(path, Q, A, q, bmin, bmax, name=name)
        print("wrote", path)


if __name__ == "__main__":
    main()
