"""Nonconvex handling: minimum-eigenvalue estimation and gamma pinning.

The reference (src/nonconvex.c) runs LOBPCG (block size 1) on Q, with
LAPACK dsyev/dsygv for the 2x2 / 3x3 compressed eigenproblems.  Here the
compressed solves are closed-form-sized `jnp.linalg.eigh` calls and the whole
iteration is a `lax.while_loop`, so it jits, vmaps and runs on device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from ..constants import LOBPCG_MAX_ITER, LOBPCG_TOL
from ..linalg.dense import norm_inf, norm_two
from ..precision import full_matmul_precision


def _eigh_gen_min(B: jnp.ndarray, Cm: jnp.ndarray):
    """Smallest eigenpair of the generalized problem B y = lambda C y
    (reference uses LAPACKE_dsygv, nonconvex.c:149-153).

    Solved via the Cholesky reduction C = L L', G = L^-1 B L^-T.
    """
    L = jnp.linalg.cholesky(Cm)
    G = solve_triangular(L, B, lower=True)
    G = solve_triangular(L, G.T, lower=True).T
    w, V = jnp.linalg.eigh(G)
    y = solve_triangular(L, V[:, 0], lower=True, trans=1)
    return w[0], y


@full_matmul_precision
def lobpcg_min_eig(Q: jnp.ndarray, x0: jnp.ndarray) -> jnp.ndarray:
    """Estimate the minimum eigenvalue of symmetric Q.

    Mirrors reference nonconvex.c:29-168: a 3-vector LOBPCG ([x, w, p]
    subspace) with the reference's exit adjustment lambda -= sqrt(2)*||w||_2
    + 1e-6 as a safe lower bound.  `x0` is the (already normalized) initial
    eigenvector guess.
    """
    dtype = Q.dtype
    n = Q.shape[-1]
    x = x0
    Ax = Q @ x
    lam = jnp.vdot(x, Ax)

    # first iteration: 2x2 standard eigenproblem (nonconvex.c:84-101)
    w = Ax - lam * x
    w = w - jnp.vdot(x, w) * x
    w = w / norm_two(w)
    Aw = Q @ w
    xAw = jnp.vdot(Aw, x)
    wAw = jnp.vdot(Aw, w)
    B2 = jnp.array([[0.0, 0.0], [0.0, 0.0]], dtype).at[0, 0].set(lam)
    B2 = B2.at[0, 1].set(xAw).at[1, 0].set(xAw).at[1, 1].set(wAw)
    w2, V2 = jnp.linalg.eigh(B2)
    lam = w2[0]
    y = V2[:, 0]

    p = y[1] * w
    Ap = y[1] * Aw
    x = y[0] * x + p
    Ax = y[0] * Ax + Ap

    def cond(carry):
        i, x, Ax, p, Ap, lam, converged = carry
        return (~converged) & (i < LOBPCG_MAX_ITER)

    def body(carry):
        i, x, Ax, p, Ap, lam, _ = carry
        w = Ax - lam * x
        converged = norm_inf(w) < LOBPCG_TOL

        def step(ops):
            x, Ax, p, Ap, lam, w = ops
            w = w - jnp.vdot(x, w) * x
            w = w / norm_two(w)
            Aw = Q @ w
            xAw = jnp.vdot(Ax, w)
            wAw = jnp.vdot(w, Aw)
            p_norm_inv = 1.0 / norm_two(p)
            p = p * p_norm_inv
            Ap = Ap * p_norm_inv
            xAp = jnp.vdot(Ax, p)
            wAp = jnp.vdot(Aw, p)
            pAp = jnp.vdot(Ap, p)
            xp = jnp.vdot(x, p)
            wp = jnp.vdot(w, p)
            B = jnp.array(
                [[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]], dtype
            )
            B = B.at[0, 0].set(lam).at[0, 1].set(xAw).at[0, 2].set(xAp)
            B = B.at[1, 0].set(xAw).at[1, 1].set(wAw).at[1, 2].set(wAp)
            B = B.at[2, 0].set(xAp).at[2, 1].set(wAp).at[2, 2].set(pAp)
            Cm = jnp.eye(3, dtype=dtype)
            Cm = Cm.at[0, 2].set(xp).at[2, 0].set(xp)
            Cm = Cm.at[1, 2].set(wp).at[2, 1].set(wp)
            lam_new, y = _eigh_gen_min(B, Cm)
            p_new = y[2] * p + y[1] * w
            Ap_new = y[2] * Ap + y[1] * Aw
            x_new = x * y[0] + p_new
            Ax_new = Ax * y[0] + Ap_new
            return x_new, Ax_new, p_new, Ap_new, lam_new

        x, Ax, p, Ap, lam = jax.lax.cond(
            converged,
            lambda ops: ops[:5],
            step,
            (x, Ax, p, Ap, lam, w),
        )
        return i + 1, x, Ax, p, Ap, lam, converged

    i0 = jnp.zeros((), jnp.int32)
    _, x, Ax, p, Ap, lam, converged = jax.lax.while_loop(
        cond, body, (i0, x, Ax, p, Ap, lam, jnp.zeros((), bool))
    )

    # theoretical bound on exit (nonconvex.c:117-121)
    w = Ax - lam * x
    norm_w = norm_two(w)
    lam_out = lam - (jnp.sqrt(jnp.asarray(2.0, dtype)) * norm_w + 1e-6)
    if n <= 3:
        lam_out = lam_out - 1e-6
    # if the loop hit max_iter without convergence, still apply the bound
    return jnp.where(converged, lam_out, lam_out)


def batch_gamma_pins(data, settings):
    """Per-problem nonconvex gamma pins for a stacked batch
    (reference: nonconvex.c:171-183 applied per problem).

    Runs the vmapped LOBPCG on each problem's *scaled* Q (the reference
    pins gamma after scaling, qpalm.c:294-296) and returns
    ``(gamma_init (B,), gamma_max (B,))``: problems with lambda_min < 0
    get gamma_init = gamma_max = 1/|lambda_min| (every subproblem convex);
    genuinely convex members keep the settings defaults.  Host-side
    (uses a numpy RNG for the eigenvector seed); used by the vmapped
    batch path (`batch.solve_batch`).
    """
    import numpy as np

    B, n_pad = data.q.shape
    dtype = data.q.dtype
    if settings.scaling:
        from ..scaling import scale_data

        sQ = jax.jit(
            jax.vmap(lambda d: scale_data(d, settings.scaling)[0].Q)
        )(data)
    else:
        sQ = data.Q
    rng = np.random.default_rng(0)
    v0 = rng.random((B, n_pad)).astype(dtype)
    v0 /= np.linalg.norm(v0, axis=1, keepdims=True)
    lams = np.asarray(jax.jit(jax.vmap(lobpcg_min_eig))(sQ, jnp.asarray(v0)))
    pins = np.where(lams < 0, 1.0 / np.abs(lams), settings.gamma_init)
    gamma_max = jnp.asarray(
        np.where(lams < 0, pins, settings.gamma_max).astype(dtype)
    )
    gamma_init = jnp.asarray(
        np.where(lams < 0, pins, settings.gamma_init).astype(dtype)
    )
    return gamma_init, gamma_max


def min_eig_settings(lam: float, settings):
    """Adjust settings for a nonconvex QP (reference: nonconvex.c:171-183).

    If lambda_min < 0 the proximal penalty is pinned to 1/|lambda_min| so
    every subproblem is convex; otherwise the problem is treated as convex.
    Host-side: returns a new Settings.
    """
    if lam < 0:
        return settings.replace(
            proximal=True,
            gamma_init=1.0 / abs(lam),
            gamma_max=1.0 / abs(lam),
        )
    return settings.replace(nonconvex=False)


def lobpcg_min_eig_np(matvec, n: int, seed: int = 0) -> float:
    """Matrix-free numpy twin of :func:`lobpcg_min_eig` for the host sparse
    path (reference nonconvex.c:29-168 run on scipy matrices).

    `matvec` maps a (n,) vector to Q @ v.  Returns the reference's safe
    lower bound lambda - (sqrt(2) ||w||_2 + 1e-6) on the minimum
    eigenvalue, so Q + (1/|lambda|) I stays strictly PD when pinned.
    """
    import numpy as _np

    rng = _np.random.default_rng(seed)
    if n <= 3:
        # LOBPCG's 3-vector subspace degenerates at n <= 3 (the reference
        # special-cases these too); the dense eigensolve is trivial here
        cols = [matvec(_np.eye(n)[:, j]) for j in range(n)]
        return float(_np.linalg.eigvalsh(_np.column_stack(cols))[0]) - 1e-6

    x = rng.random(n)
    x /= _np.linalg.norm(x)
    Ax = matvec(x)
    lam = float(x @ Ax)

    # first iteration: 2x2 standard eigenproblem (nonconvex.c:84-101)
    w = Ax - lam * x
    w = w - (x @ w) * x
    nw = _np.linalg.norm(w)
    if nw == 0.0:
        return lam - 1e-6
    w /= nw
    Aw = matvec(w)
    B2 = _np.array([[lam, Aw @ x], [Aw @ x, Aw @ w]])
    w2, V2 = _np.linalg.eigh(B2)
    lam = float(w2[0])
    y = V2[:, 0]
    p = y[1] * w
    Ap = y[1] * Aw
    x = y[0] * x + p
    Ax = y[0] * Ax + Ap

    for _ in range(LOBPCG_MAX_ITER):
        w = Ax - lam * x
        if _np.abs(w).max() < LOBPCG_TOL:
            break
        w = w - (x @ w) * x
        nw = _np.linalg.norm(w)
        if nw == 0.0:
            break
        w /= nw
        Aw = matvec(w)
        pn = _np.linalg.norm(p)
        if pn == 0.0:
            break
        p = p / pn
        Ap = Ap / pn
        B = _np.array([
            [lam, Ax @ w, Ax @ p],
            [Ax @ w, w @ Aw, Aw @ p],
            [Ax @ p, Aw @ p, Ap @ p],
        ])
        Cm = _np.eye(3)
        Cm[0, 2] = Cm[2, 0] = x @ p
        Cm[1, 2] = Cm[2, 1] = w @ p
        try:
            import scipy.linalg as _sla
            ww, VV = _sla.eigh(B, Cm)
        except Exception:
            # Cm ill-conditioned: restart the p direction
            p = _np.zeros(n)
            Ap = _np.zeros(n)
            continue
        lam = float(ww[0])
        y = VV[:, 0]
        p = y[2] * p + y[1] * w
        Ap = y[2] * Ap + y[1] * Aw
        x = y[0] * x + p
        Ax = y[0] * Ax + Ap

    w = Ax - lam * x
    return lam - (float(_np.sqrt(2.0) * _np.linalg.norm(w)) + 1e-6)
