"""Time-limit paths and the honesty of the float32 speed mode."""

import numpy as np

import qpalm_jax
from qpalm_jax import QPALM, Settings
from qpalm_jax.batch import solve_batch

from helpers import random_convex_qp


def test_time_limit_status():
    """A vanishing wall-clock budget exits with the reference's
    QPALM_TIME_LIMIT_REACHED status (qpalm.c:680-708 semantics via host
    chunking)."""
    Q, A, q, bmin, bmax = random_convex_qp(30, 45, seed=8)
    s = Settings(eps_abs=1e-12, eps_rel=0.0, time_limit=1e-4,
                 max_iter=1000000, verbose=False)
    res = QPALM(Q, A, q, bmin, bmax, settings=s).solve()
    assert res.info.status == "time limit exceeded"
    assert res.info.solve_time >= 1e-4


def test_max_iter_status():
    Q, A, q, bmin, bmax = random_convex_qp(10, 15, seed=9)
    res = QPALM(Q, A, q, bmin, bmax,
                settings=Settings(eps_abs=1e-14, eps_rel=0.0, max_iter=3,
                                  verbose=False)).solve()
    assert res.info.status == "maximum iterations reached"
    assert int(res.info.iter) >= 3


def test_f32_results_honest_in_f64():
    """Regression guard for the float32 speed mode: every f32 'solved'
    verdict must hold up under an independent float64 KKT audit at the
    claimed tolerance scale (this is the audit behind the bench's accuracy
    claim — see STATUS.md)."""
    eps = 1e-4
    probs = [random_convex_qp(24, 36, seed=100 + i) for i in range(12)]
    res = solve_batch(
        probs,
        Settings(dtype="float32", eps_abs=eps, eps_rel=eps, delta=10.0,
                 max_iter=200, verbose=False),
    )
    status = np.asarray(res.status)
    assert np.all(status == qpalm_jax.QPALM_SOLVED)
    for i, (Q, A, q, bmin, bmax) in enumerate(probs):
        x = np.asarray(res.x)[i][:24].astype(np.float64)
        y = np.asarray(res.y)[i][:36].astype(np.float64)
        Ax = A @ x
        pri = max(0.0, float((Ax - bmax).max()), float((bmin - Ax).max()))
        dua = np.abs(Q @ x + q + A.T @ y).max()
        scale_p = max(1.0, np.abs(Ax).max())
        scale_d = max(1.0, np.abs(Q @ x).max(), np.abs(q).max(),
                      np.abs(A.T @ y).max())
        assert pri <= 5 * eps * scale_p, (i, pri)
        assert dua <= 5 * eps * scale_d, (i, dua)


def test_unconstrained_qp():
    """m = 0: the padded free rows are neutral and the unconstrained
    minimizer -Q^{-1} q is recovered exactly."""
    Q = np.array([[2.0, 0.3], [0.3, 1.0]])
    q = np.array([1.0, -2.0])
    r = QPALM(Q, np.zeros((0, 2)), q, np.zeros(0), np.zeros(0),
              settings=Settings(eps_abs=1e-8, eps_rel=1e-8,
                                verbose=False)).solve()
    assert r.info.status == "solved"
    np.testing.assert_allclose(
        r.solution.x, -np.linalg.solve(Q, q), atol=1e-7
    )


def test_single_variable_qp():
    r = QPALM(np.array([[2.0]]), np.array([[1.0]]), np.array([-10.0]),
              np.array([-1.0]), np.array([1.0]),
              settings=Settings(eps_abs=1e-8, eps_rel=1e-8,
                                verbose=False)).solve()
    assert r.info.status == "solved"
    assert abs(r.solution.x[0] - 1.0) < 1e-6
