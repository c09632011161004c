"""Tests for the native sparse baseline solver
(native/qpalm_sparse_baseline.cpp) — the wall-clock comparator of the
Maros-Meszaros-at-scale table.

Strategy (SURVEY.md section 4): differential testing against the dense
native baseline (identical algorithm semantics, independent linear-algebra
path: dense LAPACK potrf vs sparse LDL'+AMD) plus KKT certification on
structured instances, and the framework-mode rescue flag against the
Python host solver's behavior.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from qpalm_jax import baseline_c


def _have_sparse():
    lib = baseline_c.load_library()
    return lib is not None and hasattr(lib, "qpalm_sparse_baseline_solve")


pytestmark = pytest.mark.skipif(
    not _have_sparse(), reason="native sparse baseline not built")


def _kkt_ok(Q, A, q, bmin, bmax, x, y, eps=1e-6):
    Q = np.asarray(Q.todense() if sp.issparse(Q) else Q)
    A = np.asarray(A.todense() if sp.issparse(A) else A)
    Ax = A @ x
    z = np.clip(Ax, bmin, bmax)
    pri = np.max(np.abs(Ax - z), initial=0.0)
    Qx = Q @ x
    dua = np.max(np.abs(Qx + q + A.T @ y))
    eps_pri = eps + eps * max(np.max(np.abs(Ax), initial=0.0),
                              np.max(np.abs(z), initial=0.0))
    eps_dua = eps + eps * max(np.max(np.abs(Qx)), np.max(np.abs(q)),
                              np.max(np.abs(A.T @ y)))
    return pri <= eps_pri and dua <= eps_dua


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_matches_dense_baseline(seed):
    """Sparse and dense baselines share iteration semantics exactly: same
    iterate path (same iteration count) and matching solutions on random
    sparse QPs."""
    rng = np.random.default_rng(seed)
    n, m = 40 + 10 * seed, 60 + 12 * seed
    M = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.3)
    Q = M @ M.T / n + 0.1 * np.eye(n)
    A = rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.3)
    q = rng.standard_normal(n)
    u = 2 * rng.random(m)
    rd = baseline_c.solve(Q, A, q, -u, u, eps_abs=1e-8, eps_rel=1e-8)
    rs = baseline_c.solve_sparse(
        sp.csc_matrix(np.triu(Q)), sp.csc_matrix(A), q, -u, u,
        eps_abs=1e-8, eps_rel=1e-8)
    assert rd["status"] == 1 and rs["status"] == 1
    # independent factorization backends -> tiny rounding divergence is
    # possible, but the semantics twin keeps the path identical in practice
    assert abs(rd["iter"] - rs["iter"]) <= 2
    assert np.allclose(rd["x"], rs["x"], atol=1e-6)
    assert abs(rd["objective"] - rs["objective"]) <= 1e-6 * max(
        1.0, abs(rd["objective"]))


def test_powell20_rescue_matches_host_solver():
    """Framework-mode rescue reproduces the Python host solver's improved
    iteration count on the degenerate POWELL20 chain (host_sparse.py twin),
    and the reference-mode baseline reproduces the pre-rescue behavior."""
    n = 300
    i = np.arange(1, n + 1, dtype=float)
    rhs = -0.5 + ((-1.0) ** i) * i
    rows = np.concatenate([np.arange(n), np.arange(n)])
    cols = np.concatenate([(np.arange(n) + 1) % n, np.arange(n)])
    vals = np.concatenate([np.ones(n), -np.ones(n)])
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsc()
    Q = sp.eye(n, format="csc")
    q = np.zeros(n)
    bmax = np.full(n, np.inf)

    r_ref = baseline_c.solve_sparse(Q, A, q, rhs, bmax, rescue=False)
    r_fw = baseline_c.solve_sparse(Q, A, q, rhs, bmax, rescue=True)
    assert r_ref["status"] == 1 and r_fw["status"] == 1
    # the rescue must cut the degenerate-chain iteration count hard
    assert r_fw["iter"] < r_ref["iter"] / 2
    assert _kkt_ok(Q, A, q, rhs, bmax, r_fw["x"], r_fw["y"], eps=1e-5)

    from qpalm_jax.host_sparse import solve_sparse_auto
    from qpalm_jax.types import Settings
    s = Settings(eps_abs=1e-6, eps_rel=1e-6, scaling=10, max_iter=50000)
    r_py = solve_sparse_auto(Q, A, q, rhs, bmax, settings=s)
    assert r_py.status == 1
    # native rescue and python rescue follow the same schedule
    assert abs(r_py.iterations - r_fw["iter"]) <= max(
        5, int(0.1 * r_py.iterations))


def test_infinite_bounds_no_nan():
    """Regression: a zero linesearch delta against an infinite bound used
    to produce 0 * inf = NaN in the breakpoint accumulators."""
    n = 30
    A = sp.eye(n, format="csc")
    Q = sp.eye(n, format="csc")
    q = -np.ones(n)
    r = baseline_c.solve_sparse(Q, A, q, np.zeros(n), np.full(n, np.inf))
    assert r["status"] == 1
    assert np.isfinite(r["x"]).all()
    assert np.allclose(r["x"], 1.0, atol=1e-5)


def test_time_limit():
    n = 500
    i = np.arange(1, n + 1, dtype=float)
    rhs = -0.5 + ((-1.0) ** i) * i
    rows = np.concatenate([np.arange(n), np.arange(n)])
    cols = np.concatenate([(np.arange(n) + 1) % n, np.arange(n)])
    vals = np.concatenate([np.ones(n), -np.ones(n)])
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsc()
    r = baseline_c.solve_sparse(sp.eye(n, format="csc"), A, np.zeros(n),
                                rhs, np.full(n, np.inf), time_limit=1e-4)
    assert r["status"] == -5  # QPALM_TIME_LIMIT_REACHED


def test_infeasibility_certificates():
    # primal infeasible: x >= 1 and x <= 0
    r = baseline_c.solve_sparse(
        sp.csc_matrix(np.array([[1.0]])),
        sp.csc_matrix(np.array([[1.0], [1.0]])), np.zeros(1),
        np.array([1.0, -np.inf]), np.array([np.inf, 0.0]))
    assert r["status"] == -3
    # dual infeasible: min -x, x free
    r2 = baseline_c.solve_sparse(
        sp.csc_matrix(np.zeros((1, 1))), sp.csc_matrix(np.zeros((1, 1))),
        np.array([-1.0]), np.array([-np.inf]), np.array([np.inf]))
    assert r2["status"] == -4
