"""Differentiable-QP checks (implicit gradients vs finite differences).

Executed in a fresh subprocess by tests/test_diff.py: the custom-vjp solver
compilations, added on top of a full test session's accumulated XLA CPU
compilations, reliably crash the compiler (SIGSEGV/SIGABRT inside
backend_compile_and_load — an upstream XLA bug, reproducible only after
~hundreds of prior compiles in one process).  Runnable directly:
python tests/diff_checks.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax
import jax.numpy as jnp
import numpy as np

from qpalm_jax import Settings
from qpalm_jax.diff import solve_diff

S = Settings(eps_abs=1e-10, eps_rel=1e-10, verbose=False, scaling=0)


def _qp(seed=0, n=5, m=7):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    Q = M @ M.T + 1.0 * np.eye(n)
    A = rng.standard_normal((m, n))
    q = rng.standard_normal(n)
    u = 1.0 + rng.random(m)
    return (jnp.asarray(Q), jnp.asarray(A), jnp.asarray(q),
            jnp.asarray(-u), jnp.asarray(u))


def _loss(Q, A, q, bmin, bmax, w):
    x = solve_diff(Q, A, q, bmin, bmax, S)
    return jnp.vdot(w, x) + 0.5 * jnp.vdot(x, x)


def check_gradients_match_finite_differences(seed):
    Q, A, q, bmin, bmax = _qp(seed)
    n = Q.shape[0]
    w = jnp.asarray(np.random.default_rng(99).standard_normal(n))

    grads = jax.grad(_loss, argnums=(0, 1, 2, 3, 4))(Q, A, q, bmin, bmax, w)
    dQ, dA, dq, dbmin, dbmax = grads

    eps = 1e-6

    def fd(setter, shape, analytic, label, samples=4):
        rng = np.random.default_rng(7)
        for _ in range(samples):
            idx = tuple(rng.integers(0, s) for s in shape)
            args_p = setter(idx, +eps)
            args_m = setter(idx, -eps)
            num = (float(_loss(*args_p, w)) - float(_loss(*args_m, w))) / (2 * eps)
            ana = float(np.asarray(analytic)[idx])
            assert abs(num - ana) <= max(2e-3 * abs(ana), 2e-5), (label, idx, num, ana)

    fd(lambda i, e: (Q.at[i].add(e).at[i[::-1]].add(e if i[0] != i[1] else 0.0),
                     A, q, bmin, bmax),
       Q.shape,
       # symmetric perturbation: dL = (dQ[ij] + dQ[ji]) for off-diagonals
       np.asarray(dQ) + np.asarray(dQ).T - np.diag(np.diagonal(dQ)),
       "Q")
    fd(lambda i, e: (Q, A.at[i].add(e), q, bmin, bmax), A.shape, dA, "A")
    fd(lambda i, e: (Q, A, q.at[i].add(e), bmin, bmax), q.shape, dq, "q")
    fd(lambda i, e: (Q, A, q, bmin.at[i].add(e), bmax), bmin.shape, dbmin,
       "bmin")
    fd(lambda i, e: (Q, A, q, bmin, bmax.at[i].add(e)), bmax.shape, dbmax,
       "bmax")


def check_gradient_descent_on_embedded_qp():
    """End-to-end: recover a q whose QP solution hits a *realizable* target
    (the solution of a hidden q_true) — the learned-MPC usage pattern."""
    Q, A, q_true, bmin, bmax = _qp(3)
    n = Q.shape[0]
    target = solve_diff(Q, A, q_true, bmin, bmax, S)

    def objective(q):
        x = solve_diff(Q, A, q, bmin, bmax, S)
        return 0.5 * jnp.vdot(x - target, x - target)

    q = jnp.zeros(n)
    val0 = float(objective(q))
    g = jax.jit(jax.grad(objective))
    for _ in range(80):
        q = q - 0.5 * g(q)
    val1 = float(objective(q))
    # the landscape is piecewise smooth (active-set kinks), so plain
    # fixed-step GD plateaus near kinks — a ~50x+ reduction demonstrates
    # usable gradients (pointwise correctness is the FD test above)
    assert val1 < 0.02 * val0


def check_gradients_at_loose_solver_tolerance():
    """Regression (review finding): at the solver's DEFAULT eps_abs=1e-4,
    inactive constraints converge with residual duals ~eps; the activity
    threshold must not classify them active, or gradients silently break.
    Gradients at eps 1e-4 must match gradients at eps 1e-10."""
    S_loose = Settings(eps_abs=1e-4, eps_rel=1e-4, verbose=False, scaling=0)
    Q, A, q, bmin, bmax = _qp(5)
    w = jnp.asarray(np.random.default_rng(42).standard_normal(Q.shape[0]))

    def loss(settings, qv):
        x = solve_diff(Q, A, qv, bmin, bmax, settings)
        return jnp.vdot(w, x)

    g_tight = np.asarray(jax.grad(lambda v: loss(S, v))(q))
    g_loose = np.asarray(jax.grad(lambda v: loss(S_loose, v))(q))
    np.testing.assert_allclose(g_loose, g_tight, atol=5e-3, rtol=5e-3)


def check_vmapped_differentiable_solves():
    """Batched differentiable QPs: vmap(grad(loss)) over stacked problems
    matches the per-problem gradient (the batched-learning pattern)."""
    import sys

    probs = [_qp(seed=i) for i in range(4)]
    Qb = jnp.stack([p[0] for p in probs])
    Ab = jnp.stack([p[1] for p in probs])
    qb = jnp.stack([p[2] for p in probs])
    bl = jnp.stack([p[3] for p in probs])
    bu = jnp.stack([p[4] for p in probs])
    w = jnp.asarray(np.random.default_rng(0).standard_normal(Qb.shape[1]))

    def loss(Q, A, q, lo, hi):
        return jnp.vdot(w, solve_diff(Q, A, q, lo, hi, S))

    gq = jax.jit(jax.vmap(jax.grad(loss, argnums=2)))(Qb, Ab, qb, bl, bu)
    assert np.isfinite(np.asarray(gq)).all()
    g2 = jax.grad(loss, argnums=2)(Qb[2], Ab[2], qb[2], bl[2], bu[2])
    np.testing.assert_allclose(np.asarray(gq)[2], np.asarray(g2), atol=1e-10)


if __name__ == "__main__":
    check_gradients_match_finite_differences(0)
    check_gradients_match_finite_differences(1)
    check_gradients_at_loose_solver_tolerance()
    check_gradient_descent_on_embedded_qp()
    check_vmapped_differentiable_solves()
    print("ALL DIFF CHECKS PASSED")
