"""Differential test: the native C/LAPACK baseline solver vs the JAX solver.

The baseline (native/qpalm_baseline.cpp) is bench.py's stand-in for the
reference C solver, so its solutions must agree with the JAX implementation
and satisfy the KKT conditions independently.
"""

import numpy as np
import pytest

from qpalm_jax import QPALM, Settings, baseline_c

from helpers import kkt_check, random_convex_qp

pytestmark = pytest.mark.skipif(
    baseline_c.load_library() is None,
    reason="native baseline library unavailable",
)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_baseline_matches_jax_solver(seed):
    Q, A, q, bl, bu = random_convex_qp(24, 36, seed=seed, density=0.5)
    r = baseline_c.solve(Q, A, q, bl, bu, eps_abs=1e-6, eps_rel=1e-6,
                         scaling=2, delta=10.0)
    assert r["status"] == 1
    kkt_check(Q, A, q, bl, bu, r["x"], r["y"], tol=1e-4)

    s = Settings(eps_abs=1e-9, eps_rel=1e-9, verbose=False)
    ref = QPALM(Q=Q, A=A, q=q, bmin=bl, bmax=bu, settings=s).solve()
    assert np.max(np.abs(r["x"] - np.asarray(ref.solution.x))) < 1e-5
    assert abs(r["objective"] - ref.info.objective) < 1e-6


def test_differential_sweep_vs_baseline():
    """Randomized differential sweep: the JAX solver (batched, f64, eps
    1e-8) against the independent C/LAPACK implementation on 36 problems
    across shapes and bound structures (boxes, equalities, free rows,
    one-sided).  Two genuinely independent implementations agreeing at
    1e-5 on x and 1e-6 on the objective is the strongest cheap semantic
    check available."""
    from qpalm_jax.batch import solve_batch
    from qpalm_jax import constants as C

    def variants(n, m, seed):
        rng = np.random.default_rng(seed)
        Q, A, q, bl, bu = random_convex_qp(n, m, seed=seed, density=0.6)
        yield (Q, A, q, bl, bu)
        # equalities anchored at an interior point (the C baseline has no
        # infeasibility detection, so every variant must stay feasible)
        k = max(1, m // 6)
        x_feas = 0.1 * rng.standard_normal(n)
        Ax = A @ x_feas
        bl2 = np.minimum(bl, Ax - 0.5)
        bu2 = np.maximum(bu, Ax + 0.5)
        bl2[:k] = bu2[:k] = Ax[:k]
        yield (Q, A, q, bl2, bu2)
        # free rows + one-sided rows
        bl3, bu3 = bl.copy(), bu.copy()
        bl3[k:2 * k] = -np.inf
        bu3[2 * k:3 * k] = np.inf
        bl3[3 * k:4 * k] = -np.inf
        bu3[3 * k:4 * k] = np.inf
        yield (Q, A, q, bl3, bu3)

    for n, m in [(24, 36), (32, 16), (12, 48)]:
        probs = [p for s in range(4) for p in variants(n, m, 1000 + s)]
        res = solve_batch(
            probs, Settings(eps_abs=1e-8, eps_rel=1e-8, verbose=False)
        )
        st = np.asarray(res.status)
        assert (st == C.QPALM_SOLVED).all(), (n, m, st)
        for i, (Q, A, q, bl, bu) in enumerate(probs):
            rb = baseline_c.solve(Q, A, q, bl, bu, eps_abs=1e-8,
                                  eps_rel=1e-8, scaling=2, delta=10.0)
            assert rb["status"] == 1, (n, m, i)
            xj = np.asarray(res.x)[i][:n]
            assert np.max(np.abs(rb["x"] - xj)) < 1e-5, (n, m, i)
            assert abs(rb["objective"]
                       - float(np.asarray(res.objective)[i])) < 1e-6


def test_baseline_unscaled_and_default_delta():
    Q, A, q, bl, bu = random_convex_qp(16, 24, seed=9)
    r = baseline_c.solve(Q, A, q, bl, bu, eps_abs=1e-8, eps_rel=1e-8,
                         scaling=0, delta=100.0)
    assert r["status"] == 1
    kkt_check(Q, A, q, bl, bu, r["x"], r["y"], tol=1e-6)


def test_baseline_max_iter_status():
    Q, A, q, bl, bu = random_convex_qp(16, 24, seed=10)
    r = baseline_c.solve(Q, A, q, bl, bu, eps_abs=1e-12, eps_rel=0.0,
                         max_iter=3)
    assert r["status"] == -2
    assert r["iter"] == 3
