"""Basic QP integration tests.

Mirrors the reference suite tests/src/test_basic_qp.c: the same 4-variable /
5-constraint QP with its stored solution (reference test_basic_qp.c:14,35-88),
swept over proximal x scaling x factorization configurations
(test_basic_qp.c:144-273,410-427).
"""

import numpy as np
import pytest

import qpalm_jax
from qpalm_jax import QPALM, Settings
from qpalm_jax.constants import (
    FACTORIZE_KKT,
    FACTORIZE_KKT_OR_SCHUR,
    FACTORIZE_SCHUR,
)

from helpers import kkt_check

# problem data (reference: tests/src/test_basic_qp.c:35-88)
N, M = 4, 5
Q = np.diag([1.0, 0.046415888, 0.0021544347, 0.0001])
A = np.zeros((M, N))
A[3, 0] = -1.0
A[4, 1] = 0.025431136
A[0, 2] = -0.0001
A[2, 3] = 0.33066985
q = np.array([-2.0146781, 2.9613971, 7.286537, 7.8925204])
bmin = np.full(M, -2.0)
bmax = np.full(M, 2.0)
SOLUTION = np.array([2.0000000e00, -6.3801365e01, -3.3821109e03, -6.0483288e00])


def base_settings(**kw):
    defaults = dict(eps_abs=1e-6, eps_rel=1e-6, gamma_init=1e1, verbose=False)
    defaults.update(kw)
    return Settings(**defaults)


def assert_solution(res):
    assert int(res.info.status_val) == qpalm_jax.QPALM_SOLVED
    for i in range(N):
        tol = abs(1e-5 * SOLUTION[i])
        assert abs(res.solution.x[i] - SOLUTION[i]) <= tol, (
            f"x[{i}]={res.solution.x[i]} vs {SOLUTION[i]}"
        )
    kkt_check(Q, A, q, bmin, bmax, res.solution.x, res.solution.y, tol=1e-4)


@pytest.mark.parametrize("proximal", [True, False])
@pytest.mark.parametrize("scaling", [0, 10])
@pytest.mark.parametrize(
    "method", [FACTORIZE_SCHUR, FACTORIZE_KKT, FACTORIZE_KKT_OR_SCHUR]
)
def test_basic_qp_sweep(proximal, scaling, method):
    s = base_settings(
        proximal=proximal, scaling=scaling, factorization_method=method
    )
    solver = QPALM(Q, A, q, bmin, bmax, settings=s)
    assert_solution(solver.solve())


def test_basic_qp_warm_start():
    """Warm-started solve converges in < 12 iterations
    (reference: test_basic_qp.c:202)."""
    s = base_settings()
    solver = QPALM(Q, A, q, bmin, bmax, settings=s)
    res = solver.solve()
    assert_solution(res)
    solver.warm_start(res.solution.x, res.solution.y)
    res2 = solver.solve()
    assert_solution(res2)
    assert int(res2.info.iter) < 12


def test_basic_qp_warm_start_resolve_identical():
    """Warm-starting twice from the same point gives identical iterates
    (reference: test_basic_qp.c:275-307)."""
    s = base_settings()
    solver = QPALM(Q, A, q, bmin, bmax, settings=s)
    x0 = np.ones(N)
    y0 = np.ones(M)
    solver.warm_start(x0, y0)
    res1 = solver.solve()
    solver.warm_start(x0, y0)
    res2 = solver.solve()
    assert int(res1.info.iter) == int(res2.info.iter)
    np.testing.assert_array_equal(res1.solution.x, res2.solution.x)


def test_basic_qp_maxiter():
    s = base_settings(max_iter=3)
    solver = QPALM(Q, A, q, bmin, bmax, settings=s)
    res = solver.solve()
    assert int(res.info.status_val) == qpalm_jax.QPALM_MAX_ITER_REACHED
    assert int(res.info.iter) == 3


def test_basic_qp_inner_maxiter():
    """Tiny inner budget still converges (reference: test_basic_qp.c:309+)."""
    s = base_settings(inner_max_iter=2)
    solver = QPALM(Q, A, q, bmin, bmax, settings=s)
    assert_solution(solver.solve())


def test_basic_qp_sigma_max():
    s = base_settings(sigma_max=1e3)
    solver = QPALM(Q, A, q, bmin, bmax, settings=s)
    assert_solution(solver.solve())


def test_basic_qp_dual_objective():
    """Dual objective equals primal objective at the solution
    (reference: test_basic_qp.c:334-364). Needs Q PD: use gamma-regularized
    Q which this problem has (diagonal positive)."""
    s = base_settings(enable_dual_termination=True, dual_objective_limit=1e20)
    solver = QPALM(Q, A, q, bmin, bmax, settings=s)
    res = solver.solve()
    assert_solution(res)
    assert abs(float(res.info.dual_objective) - float(res.info.objective)) <= (
        1e-4 * max(1.0, abs(float(res.info.objective)))
    )


def test_dual_termination_psd_singular_q():
    """A PSD-singular Q NaNs the dual-objective Q-Cholesky; the NaN guard
    must keep the dual check from firing so the solve degrades gracefully
    to normal termination (reference caveat: qpalm.c:456-469 assumes PD)."""
    Qs = np.diag([1.0, 1.0, 0.0, 0.0])  # rank-deficient PSD
    s = base_settings(enable_dual_termination=True, dual_objective_limit=-1e20)
    solver = QPALM(Qs, A, q, bmin, bmax, settings=s)
    res = solver.solve()
    # with a -1e20 limit ANY finite dual objective would terminate
    # immediately as QPALM_DUAL_TERMINATED; a singular Q must instead ride
    # the guard and solve to optimality
    assert int(res.info.status_val) == qpalm_jax.QPALM_SOLVED
    kkt_check(Qs, A, q, bmin, bmax,
              np.asarray(res.solution.x), np.asarray(res.solution.y),
              tol=1e-5)


def test_basic_qp_float32():
    """The f32 speed mode solves to loose tolerance."""
    s = base_settings(eps_abs=1e-3, eps_rel=1e-3, dtype="float32")
    solver = QPALM(Q, A, q, bmin, bmax, settings=s)
    res = solver.solve()
    assert int(res.info.status_val) == qpalm_jax.QPALM_SOLVED
    np.testing.assert_allclose(res.solution.x, SOLUTION, rtol=2e-2)
