"""Batched solves demo: thousands of QPs per chip with one vmapped program.

The accelerator workload the single-threaded reference cannot express
(SURVEY.md §2.4); on a GPU use Settings(dtype="float32") for speed.
Run: python examples/batch_demo.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from qpalm_jax import Settings
from qpalm_jax.batch import solve_batch_escalate

rng = np.random.default_rng(0)
problems = []
for _ in range(256):
    n, m = 16, 24
    M = rng.standard_normal((n, n))
    Q = M @ M.T / n + 0.1 * np.eye(n)
    A = rng.standard_normal((m, n))
    problems.append((Q, A, rng.standard_normal(n),
                     -2 * rng.random(m), 2 * rng.random(m)))

settings = Settings(dtype="float32", eps_abs=1e-4, eps_rel=1e-4,
                    max_iter=200, delta=10.0, verbose=False)
t0 = time.perf_counter()
res = solve_batch_escalate(problems, settings)
dt = time.perf_counter() - t0
solved = int(np.sum(np.asarray(res.status) == 1))
print(f"{solved}/{len(problems)} solved in {dt:.2f}s "
      f"({len(problems)/dt:.0f} solves/s, includes compile on first run)")
print("iterations p50/p95:",
      np.percentile(np.asarray(res.iterations), [50, 95]))
