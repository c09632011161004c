"""Sparse (BCOO) data path + matrix-free CG Newton mode — the large-problem
capability the dense path cannot reach (SURVEY §2.2: LADEL/CHOLMOD sparse
replacements)."""

import numpy as np
import pytest
import scipy.sparse as sp

import qpalm_jax
from qpalm_jax import QPALM, Settings
from qpalm_jax.constants import FACTORIZE_CG
from qpalm_jax.linalg.sparse import (
    ata_diag,
    ata_gershgorin_upper,
    col_inf_norms,
    from_scipy,
    row_inf_norms,
    scale_rows_cols,
    sym_diag,
)

from helpers import kkt_check

S = Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False)


def _sparse_qp(n, m, seed=0, density=0.05):
    rng = np.random.default_rng(seed)
    Qh = sp.random(n, n, density=density, random_state=seed,
                   data_rvs=rng.standard_normal)
    Q = (Qh @ Qh.T + 0.5 * sp.eye(n)).tocsc()
    A = sp.random(m, n, density=density, random_state=seed + 1,
                  data_rvs=rng.standard_normal).tocsc()
    q = rng.standard_normal(n)
    u = 2 * rng.random(m) + 0.1
    return Q, A, q, -u, u


def test_sparse_helpers_match_dense():
    Q, A, q, bmin, bmax = _sparse_qp(12, 17, seed=2)
    Ab = from_scipy(A, np.float64)
    Qb = from_scipy(Q, np.float64)
    Ad = A.toarray()
    np.testing.assert_allclose(row_inf_norms(Ab), np.abs(Ad).max(axis=1))
    np.testing.assert_allclose(col_inf_norms(Ab), np.abs(Ad).max(axis=0))
    E = np.linspace(1, 2, 17)
    D = np.linspace(0.5, 1.5, 12)
    np.testing.assert_allclose(
        scale_rows_cols(Ab, E, D).todense(), E[:, None] * Ad * D[None, :]
    )
    np.testing.assert_allclose(sym_diag(Qb), np.diagonal(Q.toarray()))
    s = np.linspace(0.1, 3.0, 17)
    np.testing.assert_allclose(
        ata_diag(Ab, s), np.diagonal(Ad.T @ (s[:, None] * Ad)), atol=1e-12
    )
    # upper bound dominates the true gershgorin bound
    M = Ad.T @ (s[:, None] * Ad)
    gersh_true = np.max(np.abs(M).sum(axis=1))
    assert float(ata_gershgorin_upper(Ab, s)) >= gersh_true - 1e-9


def test_sparse_cg_matches_dense_path():
    Q, A, q, bmin, bmax = _sparse_qp(20, 30, seed=3, density=0.3)
    r_sparse = QPALM(Q, A, q, bmin, bmax, settings=S, sparse=True).solve()
    r_dense = QPALM(Q.toarray(), A.toarray(), q, bmin, bmax, settings=S).solve()
    assert r_sparse.info.status == "solved"
    # the CG path uses inexact-Newton forcing, so iterates differ from the
    # exact dense factorization; both land within the 1e-6 solve tolerance
    np.testing.assert_allclose(
        r_sparse.solution.x, r_dense.solution.x, atol=5e-6
    )


def test_sparse_medium_qp_kkt():
    Q, A, q, bmin, bmax = _sparse_qp(120, 180, seed=5, density=0.05)
    solver = QPALM(Q, A, q, bmin, bmax, settings=S, sparse=True)
    assert solver.settings.factorization_method == FACTORIZE_CG
    res = solver.solve()
    assert res.info.status == "solved"
    kkt_check(Q.toarray(), A.toarray(), q, bmin, bmax,
              res.solution.x, res.solution.y, tol=1e-5)


def test_sparse_warm_start_and_updates():
    Q, A, q, bmin, bmax = _sparse_qp(40, 60, seed=6, density=0.2)
    solver = QPALM(Q, A, q, bmin, bmax, settings=S, sparse=True)
    r1 = solver.solve()
    solver.warm_start(r1.solution.x, r1.solution.y)
    r2 = solver.solve()
    assert r2.info.status == "solved" and int(r2.info.iter) < 12
    solver.update_bounds(bmin - 0.5, bmax + 0.5)
    solver.update_q(-q)
    r3 = solver.solve()
    assert r3.info.status == "solved"
    kkt_check(Q.toarray(), A.toarray(), -q, bmin - 0.5, bmax + 0.5,
              r3.solution.x, r3.solution.y, tol=1e-4)


def test_sparse_primal_infeasible():
    A = sp.csc_matrix(np.array([[1.0], [1.0]]))
    Q = sp.csc_matrix(np.eye(1))
    res = QPALM(Q, A, np.zeros(1), np.array([1.0, -1e30]),
                np.array([1e30, 0.0]), settings=S, sparse=True).solve()
    assert res.info.status == "primal infeasible"


def test_sparse_dual_termination_rejected():
    Q, A, q, bmin, bmax = _sparse_qp(10, 12, seed=7, density=0.3)
    with pytest.raises(ValueError):
        QPALM(Q, A, q, bmin, bmax, sparse=True,
              settings=S.replace(enable_dual_termination=True))


def test_block_jacobi_preconditioner():
    """Block-Jacobi must (a) apply M_blk^-1 exactly on its blocks, and
    (b) reduce CG iterations vs diagonal Jacobi on coupling-dominated
    ill-conditioning (Laplacian^2 Hessian), where diag(M) is useless."""
    import scipy.sparse as sp
    import jax.numpy as jnp
    from qpalm_jax.linalg.cg import pcg
    from qpalm_jax.linalg.sparse import (
        ata_diag, block_diagonals, block_jacobi_apply, from_scipy, sym_diag,
    )

    rng = np.random.default_rng(0)
    n, m = 512, 64
    L = sp.diags([2 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
                 [0, 1, -1])
    Q = from_scipy((L @ L + 1e-4 * sp.eye(n)).tocoo())
    A = from_scipy(sp.random(m, n, density=0.02, random_state=3,
                             format="coo"))
    sig = jnp.asarray(1.0 + rng.random(m))
    ginv = jnp.asarray(1e-7)
    b = jnp.asarray(rng.standard_normal(n))

    def matvec(v):
        return Q @ v + A.T @ (sig * (A @ v)) + ginv * v

    blocks = block_diagonals(Q, A, sig, ginv, 64)
    # exactness: the stacked blocks must equal the dense M's block diagonal
    Md = np.asarray(Q.todense()) + np.asarray(A.todense()).T @ (
        np.asarray(sig)[:, None] * np.asarray(A.todense())
    ) + float(ginv) * np.eye(n)
    for k in range(0, n // 64, 3):
        np.testing.assert_allclose(
            np.asarray(blocks)[k], Md[k * 64:(k + 1) * 64, k * 64:(k + 1) * 64],
            atol=1e-10,
        )
    ch = jnp.linalg.cholesky(blocks)
    diagM = sym_diag(Q) + ginv + ata_diag(A, sig)
    _, r1, k1 = pcg(matvec, b, diagM, tol=jnp.asarray(1e-8), max_iter=5000)
    x2, r2, k2 = pcg(matvec, b, lambda r: block_jacobi_apply(ch, r),
                     tol=jnp.asarray(1e-8), max_iter=5000)
    assert int(k2) < int(k1), (int(k2), int(k1))
    # solution correctness against dense solve
    x_ref = np.linalg.solve(Md, np.asarray(b))
    assert np.max(np.abs(np.asarray(x2) - x_ref)) < 1e-4


def test_solver_block_jacobi_mode():
    """End-to-end FACTORIZE_CG solve with cg_precond='block_jacobi'."""
    import scipy.sparse as sp

    rng = np.random.default_rng(5)
    n, m = 200, 150
    L = sp.diags([2 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
                 [0, 1, -1])
    Q = (L @ L + 0.1 * sp.eye(n)).tocsc()
    A = (sp.random(m, n, density=0.05, random_state=1) + 0.5 * sp.eye(m, n)
         ).tocsc()
    q = rng.standard_normal(n)
    u = 1 + rng.random(m)
    s = qpalm_jax.Settings(
        eps_abs=1e-6, eps_rel=1e-6, verbose=False,
        factorization_method=qpalm_jax.constants.FACTORIZE_CG,
        cg_precond="block_jacobi", cg_block=50, cg_max_iter=2000,
    )
    r = qpalm_jax.QPALM(Q=Q, A=A, q=q, bmin=-u, bmax=u, settings=s).solve()
    assert r.info.status == "solved"
    kkt_check(Q.toarray(), A.toarray(), q, -u, u,
              np.asarray(r.solution.x), np.asarray(r.solution.y), tol=1e-4)
