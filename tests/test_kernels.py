"""Unit tests for the linesearch, scaling, LOBPCG and dense kernels against
numpy oracles (reference analogues: tests/src/test_lin_alg.c,
test_solver_interface.c, test_nonconvex_qp.c, test_ls_qp.c)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qpalm_jax.linalg.dense import (
    cho_solve,
    gershgorin_max,
    newton_solve_kkt,
    newton_solve_schur,
    norm_inf,
    schur_matrix,
    vec_mid,
)
from qpalm_jax.scaling import scale_data
from qpalm_jax.solver.linesearch import exact_linesearch
from qpalm_jax.solver.nonconvex import lobpcg_min_eig
from qpalm_jax.types import QPData


def test_norm_inf_and_mid():
    v = jnp.array([1.0, -5.0, 3.0])
    assert float(norm_inf(v)) == 5.0
    lo = jnp.array([-1.0, -1.0, -1.0])
    hi = jnp.array([2.0, 2.0, 2.0])
    np.testing.assert_array_equal(
        np.asarray(vec_mid(v, lo, hi)), [1.0, -1.0, 2.0]
    )


def _spd_batch(B, n, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n)).astype(dtype)
    return M @ np.transpose(M, (0, 2, 1)) + n * np.eye(n, dtype=dtype)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("n", [8, 16, 64])
def test_cholesky_and_solve_match_numpy(n, batched):
    """The solver's factor/solve pair (jnp.linalg.cholesky + cho_solve,
    the lower factor L with L L' = M) against numpy, jitted, on one system
    and under vmap over a batch of systems."""
    B = 6 if batched else 1
    M = _spd_batch(B, n, seed=n)
    b = np.random.default_rng(n + 1).standard_normal((B, n))

    def factor_solve(M, b):
        L = jnp.linalg.cholesky(M)
        return L, cho_solve(L, b)

    fn = jax.jit(jax.vmap(factor_solve) if batched else factor_solve)
    L, x = fn(jnp.asarray(M if batched else M[0]),
              jnp.asarray(b if batched else b[0]))
    L = np.asarray(L).reshape(B, n, n)
    x = np.asarray(x).reshape(B, n)
    np.testing.assert_allclose(L, np.linalg.cholesky(M), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(x, np.linalg.solve(M, b[..., None])[..., 0],
                               rtol=1e-9, atol=1e-12)


def test_gershgorin_upper_bounds_eigs():
    rng = np.random.default_rng(3)
    M = rng.standard_normal((20, 20))
    M = M + M.T
    ub = float(gershgorin_max(jnp.asarray(M)))
    assert ub >= np.max(np.linalg.eigvalsh(M)) - 1e-10


def test_schur_solve_matches_numpy():
    rng = np.random.default_rng(4)
    n, m = 12, 18
    Mh = rng.standard_normal((n, n))
    Q = Mh @ Mh.T + 0.1 * np.eye(n)
    A = rng.standard_normal((m, n))
    sigma = rng.random(m) + 0.5
    active = rng.random(m) < 0.5
    gamma = 50.0
    b = rng.standard_normal(n)
    M = Q + np.eye(n) / gamma + A.T @ np.diag(sigma * active) @ A
    d_np = np.linalg.solve(M, b)

    d, _ = newton_solve_schur(
        jnp.asarray(Q), jnp.asarray(A), jnp.sqrt(jnp.asarray(sigma)),
        jnp.asarray(active), jnp.asarray(gamma), jnp.asarray(b),
        proximal=True, max_refine=3,
    )
    np.testing.assert_allclose(np.asarray(d), d_np, rtol=1e-9, atol=1e-11)

    d_kkt = newton_solve_kkt(
        jnp.asarray(Q), jnp.asarray(A), jnp.asarray(sigma),
        jnp.asarray(active), jnp.asarray(gamma), jnp.asarray(b),
        proximal=True,
    )
    np.testing.assert_allclose(np.asarray(d_kkt), d_np, rtol=1e-8, atol=1e-10)


def test_ruiz_scaling_equilibrates():
    """After Ruiz iterations the row/col inf-norms of A approach 1
    (reference: src/scaling.c:49-80)."""
    rng = np.random.default_rng(5)
    n, m = 10, 14
    A = rng.standard_normal((m, n)) * np.exp(rng.standard_normal((m, n)) * 3)
    Q = np.eye(n)
    data = QPData(
        Q=jnp.asarray(Q), A=jnp.asarray(A), q=jnp.ones(n),
        bmin=-jnp.ones(m), bmax=jnp.ones(m), c=jnp.zeros(()),
    )
    sdata, scal = scale_data(data, 10)
    As = np.asarray(sdata.A)
    # Ruiz converges linearly: 10 iterations get within a few percent
    np.testing.assert_allclose(np.max(np.abs(As), axis=0), 1.0, rtol=5e-2)
    np.testing.assert_allclose(np.max(np.abs(As), axis=1), 1.0, rtol=5e-2)
    # scaled A == E A D
    np.testing.assert_allclose(
        As, np.asarray(scal.E)[:, None] * A * np.asarray(scal.D)[None, :],
        rtol=1e-12,
    )


def _phi_derivative(tau, d, Q, A, q, x, y, sigma, bmin, bmax, gamma, x0):
    """Directional derivative of the ALM merit at x + tau*d (oracle)."""
    xt = x + tau * d
    Axt = A @ xt
    yssig = Axt + y / sigma
    z = np.clip(yssig, bmin, bmax)
    yh = y + sigma * (Axt - z)
    grad = Q @ xt + q + (xt - x0) / gamma + A.T @ yh
    return grad @ d


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_exact_linesearch_zeroes_derivative(seed):
    rng = np.random.default_rng(seed)
    n, m = 6, 9
    Mh = rng.standard_normal((n, n))
    Q = Mh @ Mh.T + 0.2 * np.eye(n)
    A = rng.standard_normal((m, n))
    q = rng.standard_normal(n)
    x = rng.standard_normal(n)
    x0 = x.copy()
    y = rng.standard_normal(m)
    sigma = rng.random(m) + 0.5
    bmax = np.abs(A @ x) + rng.random(m) * 0.1
    bmin = -bmax
    gamma = 1e4
    dphi_dir = rng.standard_normal(n)
    # the solver only ever linesearches along descent directions (the root is
    # then at tau > 0, which is what the breakpoint walk assumes)
    if _phi_derivative(0.0, dphi_dir, Q, A, q, x, y, sigma, bmin, bmax,
                       gamma, x0) > 0:
        dphi_dir = -dphi_dir

    Qd = Q @ dphi_dir + dphi_dir / gamma
    Ad = A @ dphi_dir
    df = Q @ x + q + (x - x0) / gamma
    tau = float(
        exact_linesearch(
            jnp.asarray(dphi_dir), jnp.asarray(Qd), jnp.asarray(Ad),
            jnp.asarray(df), jnp.asarray(A @ x), jnp.asarray(y),
            jnp.asarray(sigma), jnp.sqrt(jnp.asarray(sigma)),
            jnp.asarray(bmin), jnp.asarray(bmax),
        )
    )
    dval = _phi_derivative(
        tau, dphi_dir, Q, A, q, x, y, sigma, bmin, bmax, gamma, x0
    )
    assert abs(dval) < 1e-8, f"phi'(tau)={dval} at tau={tau}"


def test_exact_linesearch_all_breakpoints():
    """A direction that traverses every breakpoint (reference analogue:
    tests/src/test_ls_qp.c)."""
    n, m = 1, 6
    Q = np.array([[1e-4]])
    A = np.ones((m, 1))
    q = np.array([-1e3])  # strong pull so tau passes all breakpoints
    x = np.zeros(1)
    y = np.zeros(m)
    sigma = np.full(m, 1.0)
    bmin = -np.arange(1.0, m + 1)
    bmax = np.arange(1.0, m + 1)
    gamma = 1e7
    d = np.ones(1)
    Qd = Q @ d + d / gamma
    Ad = A @ d
    df = Q @ x + q
    tau = float(
        exact_linesearch(
            jnp.asarray(d), jnp.asarray(Qd), jnp.asarray(Ad), jnp.asarray(df),
            jnp.asarray(A @ x), jnp.asarray(y), jnp.asarray(sigma),
            jnp.sqrt(jnp.asarray(sigma)), jnp.asarray(bmin), jnp.asarray(bmax),
        )
    )
    dval = _phi_derivative(tau, d, Q, A, q, x, y, sigma, bmin, bmax, gamma, x)
    assert tau > bmax[-1]  # traversed every breakpoint
    assert abs(dval) < 1e-6


def test_lobpcg_min_eig():
    rng = np.random.default_rng(9)
    n = 30
    M = rng.standard_normal((n, n))
    Q = (M + M.T) / 2
    true_min = np.min(np.linalg.eigvalsh(Q))
    x0 = rng.random(n)
    x0 /= np.linalg.norm(x0)
    lam = float(lobpcg_min_eig(jnp.asarray(Q), jnp.asarray(x0)))
    # reference subtracts a safety margin, so lam is a lower bound
    assert lam <= true_min + 1e-6
    assert lam >= true_min - 0.05 * abs(true_min) - 1e-3
