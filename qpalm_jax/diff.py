"""Differentiable QP solves: gradients through the optimizer.

No reference equivalent — the C solver is a black box.  Because this
framework's solve is a pure function of (Q, A, q, bmin, bmax), it composes
with `jax.grad`: the custom VJP below differentiates the *solution map*
x*(Q, A, q, bmin, bmax) by the implicit function theorem on the active-set
KKT conditions (the OptNet construction, adapted to two-sided constraints
and fixed shapes):

    Q x* + q + A' y* = 0
    A_act x*         = b_act        (rows active at the solution)

The backward pass solves one masked KKT system (the same quasi-definite
form as the solver's Newton step, with a hard penalty standing in for the
equality rows) — O(one factorization) per cotangent, entirely on device.

Enables end-to-end learning with embedded QPs (learned MPC costs,
projection layers, differentiable safety filters) on the device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .linalg.dense import cho_solve
from .scaling import identity_scaling
from .solver.core import init_state, solve_from_state
from .types import QPData, Settings

# active-set detection margins and the equality-row penalty of the backward
# KKT solve (sigma -> inf limit of the solver's own Schur form).  The slack
# margin is *relative* to the constraint scale and widened for float32
# forward solves (whose residuals sit near 1e-4, not 1e-7); rows with a
# clearly nonzero multiplier are classified active regardless of slack
# (the OptNet convention), so badly scaled slacks cannot silently flip a
# row's activity.
_ACT_TOL_F64 = 1e-7
_ACT_TOL_F32 = 3e-4
_Y_TOL_REL = 1e-6
# the equality-row penalty must stay within the working precision's
# conditioning headroom: 1e10 is fine for f64 Cholesky but obliterates the
# Q-scale curvature in float32 (eps ~ 1.2e-7), so f32 uses ~1e5
_HARD_SIGMA_F64 = 1e10
_HARD_SIGMA_F32 = 1e5


def _solve_primal(Q, A, q, bmin, bmax, settings: Settings):
    data = QPData(Q=Q, A=A, q=q, bmin=bmin, bmax=bmax,
                  c=jnp.zeros((), Q.dtype))
    scal = identity_scaling(data.n, data.m, Q.dtype)
    st = init_state(data, scal, settings)
    final = solve_from_state(st, data, scal, settings)
    return final.x, final.yh


@functools.partial(jax.custom_vjp, nondiff_argnums=(5,))
def solve_diff(Q, A, q, bmin, bmax, settings: Settings):
    """Solve the QP and return x*, differentiable w.r.t. all of
    (Q, A, q, bmin, bmax) — the standard OptNet contract (the multipliers
    y* are recoverable via an ordinary solve if needed).

    Scaling is disabled internally (the gradient formulas live in the
    original variables); pass well-scaled data or wrap externally.  The
    gradient is exact where the active set is locally stable (the generic
    case); at degenerate points it is a subgradient choice.
    """
    x, _ = _solve_primal(Q, A, q, bmin, bmax, settings)
    return x


def _fwd(Q, A, q, bmin, bmax, settings):
    x, y = _solve_primal(Q, A, q, bmin, bmax, settings)
    return x, (Q, A, q, bmin, bmax, x, y)


def _bwd(settings, res, gx):
    Q, A, q, bmin, bmax, x, y = res
    dtype = Q.dtype
    Ax = A @ x
    base = _ACT_TOL_F32 if dtype == jnp.float32 else _ACT_TOL_F64
    tol = base * jnp.maximum(1.0, jnp.max(jnp.abs(Ax)))
    # a multiplier only marks a row active when it clearly exceeds the
    # solver's own dual tolerance: at eps_abs=1e-4 inactive rows converge
    # with residual |y| ~ eps, and a fixed 1e-6 threshold would classify
    # them active, silently corrupting the gradients
    y_tol = jnp.maximum(
        _Y_TOL_REL * jnp.maximum(1.0, jnp.max(jnp.abs(y))),
        jnp.asarray(10.0 * float(settings.eps_abs), dtype),
    )
    at_upper = (Ax >= bmax - tol) | (y > y_tol)
    active = (Ax <= bmin + tol) | at_upper | (y < -y_tol)

    # masked KKT solve: K = Q + A_act' sigma A_act with sigma -> inf emulates
    # the equality rows; lam solves K lam = -gx up to the range-space split
    hard = _HARD_SIGMA_F32 if dtype == jnp.float32 else _HARD_SIGMA_F64
    sig = jnp.where(active, jnp.asarray(hard, dtype), 0.0)
    B = A * jnp.sqrt(sig)[:, None]
    K = Q + B.T @ B + jnp.asarray(1e-12, dtype) * jnp.eye(
        Q.shape[0], dtype=dtype
    )
    lam = cho_solve(jnp.linalg.cholesky(K), -gx)
    # dual component of the adjoint: nu = sigma * (A lam) on active rows
    # (exact as sigma -> inf: Q lam + A_act' nu = -gx, A_act lam -> 0)
    nu = sig * (A @ lam)

    # gradients by the OptNet formulas (two-sided bounds: the active side
    # receives the equality gradient)
    dq = lam
    dQ = 0.5 * (jnp.outer(lam, x) + jnp.outer(x, lam))
    # only active rows of A move the solution locally; inactive multipliers
    # are ~0 by complementarity but are masked for exactness
    y_act = jnp.where(active, y, 0.0)
    dA = jnp.outer(y_act, lam) + jnp.outer(nu, x)
    db = -nu
    dbmax = jnp.where(active & at_upper, db, 0.0)
    dbmin = jnp.where(active & ~at_upper, db, 0.0)
    return dQ, dA, dq, dbmin, dbmax


solve_diff.defvjp(_fwd, _bwd)
