"""Medium random QPs verified against an independent KKT oracle
(reference analogue: tests/src/test_medium_qp.c — n=m=15 QP checked against a
stored solution; here the oracle is direct KKT verification, which is
stronger than value comparison)."""

import numpy as np
import pytest

import qpalm_jax
from qpalm_jax import QPALM, Settings

from helpers import kkt_check, random_convex_qp


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("proximal", [True, False])
def test_medium_qp(seed, proximal):
    Q, A, q, bmin, bmax = random_convex_qp(15, 15, seed=seed)
    s = Settings(eps_abs=1e-6, eps_rel=1e-6, proximal=proximal, verbose=False)
    solver = QPALM(Q, A, q, bmin, bmax, settings=s)
    res = solver.solve()
    assert int(res.info.status_val) == qpalm_jax.QPALM_SOLVED
    kkt_check(Q, A, q, bmin, bmax, res.solution.x, res.solution.y, tol=1e-4)


def test_larger_qp():
    Q, A, q, bmin, bmax = random_convex_qp(60, 90, seed=7)
    s = Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False)
    res = QPALM(Q, A, q, bmin, bmax, settings=s).solve()
    assert int(res.info.status_val) == qpalm_jax.QPALM_SOLVED
    kkt_check(Q, A, q, bmin, bmax, res.solution.x, res.solution.y, tol=1e-4)


def test_degenerate_hessian():
    """Rank-deficient Q (reference: tests/src/test_degen_hess.c)."""
    rng = np.random.default_rng(11)
    n, m = 10, 12
    Mhalf = rng.standard_normal((3, n))
    Q = Mhalf.T @ Mhalf  # rank 3
    A = rng.standard_normal((m, n))
    q = rng.standard_normal(n)
    u = rng.random(m) + 0.5
    s = Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False)
    res = QPALM(Q, A, q, -u, u, settings=s).solve()
    assert int(res.info.status_val) == qpalm_jax.QPALM_SOLVED
    kkt_check(Q, A, q, -u, u, res.solution.x, res.solution.y, tol=1e-4)


def test_equality_constraints():
    """bmin == bmax rows (equalities) are handled."""
    rng = np.random.default_rng(5)
    n, m = 8, 4
    M = rng.standard_normal((n, n))
    Q = M @ M.T + 0.5 * np.eye(n)
    A = rng.standard_normal((m, n))
    q = rng.standard_normal(n)
    b = rng.standard_normal(m) * 0.1
    s = Settings(eps_abs=1e-7, eps_rel=1e-7, verbose=False)
    res = QPALM(Q, A, q, b, b, settings=s).solve()
    assert int(res.info.status_val) == qpalm_jax.QPALM_SOLVED
    np.testing.assert_allclose(A @ res.solution.x, b, atol=1e-5)
    # stationarity
    g = Q @ res.solution.x + q + A.T @ res.solution.y
    assert np.max(np.abs(g)) < 1e-4
