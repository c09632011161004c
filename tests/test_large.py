"""Large dense-QP device pipeline (qpalm_jax/large.py) — CPU-sized checks.

The pipeline contract: every returned solution is f64-KKT-certified at
eps on the unscaled problem or flagged ok=False.  On a GPU the f32 pass
runs on the card (chip_smoke.py's `large` phase at n=1024); here the same
code path runs on CPU at small n.
"""

import numpy as np
import pytest

from qpalm_jax.large import solve_large_dense
from qpalm_jax.workloads import random_qp

from helpers import kkt_check


def test_pipeline_certifies_batch():
    n, m = 96, 144
    probs = [random_qp(n, m, density=0.5, seed=s) for s in range(4)]
    r = solve_large_dense(probs, eps=1e-6)
    assert r.ok.all(), r.ok
    assert (r.status == 1).all()
    for i, p in enumerate(probs):
        kkt_check(p[0], p[1], p[2], p[3], p[4], r.x[i][:n], r.y[i][:m],
                  tol=1e-5)


def test_pipeline_objective_matches_f64_solve():
    import qpalm_jax
    from qpalm_jax import Settings

    n, m = 64, 96
    p = random_qp(n, m, density=0.3, seed=11)
    r = solve_large_dense([p], eps=1e-6)
    assert r.ok[0]
    ref = qpalm_jax.solve(*p, settings=Settings(eps_abs=1e-9, eps_rel=1e-9,
                                                verbose=False))
    assert abs(r.objective[0] - float(ref.info.objective)) <= 1e-5 * max(
        1.0, abs(float(ref.info.objective)))


def test_failed_lane_is_flagged_not_lied_about():
    # an infeasible problem cannot certify: ok must be False, not a fake
    # "solved" claim (status from the f32 pass reports the certificate)
    n = 8
    Q = np.eye(n)
    A = np.zeros((2, n)); A[0, 0] = 1.0; A[1, 0] = 1.0
    bmin = np.array([1.0, -np.inf]); bmax = np.array([np.inf, 0.0])
    r = solve_large_dense([(Q, A, np.ones(n), bmin, bmax)], eps=1e-6)
    assert not r.ok[0]
    assert r.status[0] == -3  # primal infeasible certificate from the pass
