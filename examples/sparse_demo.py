"""Large sparse QP demo: the direct / matrix-free backends side by side.

The large-sparse front door (`solve_sparse_auto`) routes by estimated
factor cost: native LDL' backends (simplicial or supernodal, AMD/RCM
ordering, Schur or quasi-definite KKT form) when a factorization stays
cheap, matrix-free preconditioned CG past the budget.  This demo runs
three problem classes through the auto-router and one through the CG-only
class, at the reference tolerance 1e-6.

Run: python examples/sparse_demo.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import scipy.sparse as sp

from qpalm_jax import QPALM, Settings, solve_sparse_auto

rng = np.random.default_rng(0)


def kkt_report(Q, A, q, u, r, label, t):
    x, y = np.asarray(r.x), np.asarray(r.y)
    g = Q @ x + q + A.T @ y
    Ax = A @ x
    pv = max(0.0, float((Ax - u).max()), float((-u - Ax).max()))
    print(f"{label:>28}: {r.status_str}, {r.iterations} iters, "
          f"{t:.2f}s, stationarity {np.abs(g).max():.1e}, "
          f"primal viol {pv:.1e}")


# 1) banded, ill-conditioned: direct LDL' (simplicial + AMD) territory
n, m = 5000, 2000
L = sp.diags([2.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
             [0, 1, -1])
Q = (L @ L + 1e-6 * sp.eye(n)).tocsc()
A = sp.diags([np.ones(m), 0.5 * np.ones(m)], [0, 1], shape=(m, n)).tocsc()
q = rng.standard_normal(n)
u = 1 + rng.random(m)
t0 = time.perf_counter()
r = solve_sparse_auto(Q, A, q, -u, u, eps_abs=1e-6, eps_rel=1e-6,
                      verbose=False)
kkt_report(Q, A, q, u, r, "banded ill-cond (LDL')", time.perf_counter() - t0)

# 2) banded Q + a few dense rows in A: the quasi-definite KKT form keeps
#    the factor sparse where the Schur form would densify
A2 = sp.vstack([sp.diags(np.ones(m - 5), 0, shape=(m - 5, n)),
                sp.csc_matrix(rng.standard_normal((5, n)) / np.sqrt(n))
                ]).tocsc()
t0 = time.perf_counter()
r = solve_sparse_auto(Q, A2, q, -u, u, eps_abs=1e-6, eps_rel=1e-6,
                      verbose=False)
kkt_report(Q, A2, q, u, r, "dense rows (KKT form)", time.perf_counter() - t0)

# 3) irregular random sparsity with heavy fill: supernodal BLAS panels
n3, m3 = 2000, 1500
Qr = sp.random(n3, n3, density=0.003, random_state=rng)
Q3 = (Qr @ Qr.T + sp.eye(n3)).tocsc()
A3 = (sp.random(m3, n3, density=0.003, random_state=rng)
      + 0.5 * sp.eye(m3, n3)).tocsc()
q3 = rng.standard_normal(n3)
u3 = 1 + rng.random(m3)
t0 = time.perf_counter()
r = solve_sparse_auto(Q3, A3, q3, -u3, u3, eps_abs=1e-6, eps_rel=1e-6,
                      verbose=False)
kkt_report(Q3, A3, q3, u3, r, "heavy fill (supernodal)",
           time.perf_counter() - t0)

# 4) the matrix-free CG path (no n x n memory anywhere): its home turf is
#    WELL-conditioned operators — ill-conditioned ones belong to the
#    direct backends above (that split is the auto-router's whole job)
Q4 = sp.diags([2.0 * np.ones(n), -0.5 * np.ones(n - 1),
               -0.5 * np.ones(n - 1)], [0, 1, -1]).tocsc()
m4 = 7000
A4 = sp.random(m4, n, density=5e-4, random_state=1,
               data_rvs=rng.standard_normal).tocsc()
u4 = 2 * rng.random(m4) + 0.5
t0 = time.perf_counter()
solver = QPALM(Q4, A4, q, -u4, u4,
               settings=Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False,
                                 delta=10.0))
res = solver.solve()
print(f"{'matrix-free CG (class)':>28}: {res.info.status}, "
      f"{int(res.info.iter)} iters, {time.perf_counter()-t0:.2f}s")
