"""Nonconvex QP demo: indefinite Hessian regularized by LOBPCG gamma pinning.

Port of the reference's canonical nonconvex workload
(examples/qpalm_mex_nonconvex_demo.m:16-19: settings.nonconvex = true).
Run: python examples/nonconvex_demo.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from qpalm_jax import Settings, solve

rng = np.random.default_rng(42)
n = 10
Q = rng.standard_normal((n, n))
Q = 0.5 * (Q + Q.T)  # symmetric indefinite
lam = np.linalg.eigvalsh(Q)
print(f"eigenvalue range of Q: [{lam[0]:.3f}, {lam[-1]:.3f}]")

A = np.eye(n)
q = rng.standard_normal(n)
res = solve(Q, A, q, -np.ones(n), np.ones(n),
            settings=Settings(nonconvex=True, eps_abs=1e-6, eps_rel=1e-6,
                              verbose=True))
print("status:", res.info.status)
x = res.solution.x
print("x =", x)

# stationarity on the box: interior coordinates have zero gradient,
# boundary coordinates have the right gradient sign
g = Q @ x + q
for j in range(n):
    if abs(x[j]) < 1 - 1e-6:
        assert abs(g[j]) < 1e-4, (j, g[j])
    elif x[j] >= 1 - 1e-6:
        assert g[j] <= 1e-4
    else:
        assert g[j] >= -1e-4
print("stationary point verified")
