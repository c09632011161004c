"""Dense linear-algebra kernels for the device QPALM.

The reference routes every linear system through a sparse LDL' with rank-1
up/downdates (reference: src/solver_interface.c:319-503).  Rank-1 surgery on a
sparse factor is the wrong primitive on an accelerator: it is sequential, scalar and
fill-dependent.  Instead we recompute a *dense blocked* factorization of the
Schur matrix

    M = Q + (1/gamma) I + A' diag(sigma * active) A

every Newton step where the active set / penalties changed: the assembly is a
single matmul B'B with B = (sqrt(sigma)*active)[:, None] * A, and the
factorization is a (batched) Cholesky.  That trades FLOPs (which are nearly
cheap on an accelerator) for the data-dependent control flow the reference needs
(which is poison under XLA).

`newton_solve_kkt` keeps the reference's quasi-definite KKT formulation
(reference: src/solver_interface.c:119-200) as an alternative linear-system
path, solved with dense LU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular


def norm_inf(v: jnp.ndarray) -> jnp.ndarray:
    """Infinity norm (reference: src/lin_alg.c:126-163)."""
    if v.size == 0:
        return jnp.zeros((), dtype=v.dtype)
    return jnp.max(jnp.abs(v))


def norm_two(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.sum(v * v))


def vec_mid(v: jnp.ndarray, lo: jnp.ndarray, hi: jnp.ndarray) -> jnp.ndarray:
    """Three-way clamp min(max(v, lo), hi) (reference: lin_alg.c:189-195
    vec_ew_mid_vec)."""
    return jnp.minimum(jnp.maximum(v, lo), hi)


def gershgorin_max(M: jnp.ndarray) -> jnp.ndarray:
    """Upper bound on the max eigenvalue of symmetric M by Gershgorin circles
    (reference: src/nonconvex.c:185-210)."""
    diag = jnp.diagonal(M)
    radius = jnp.sum(jnp.abs(M), axis=1) - jnp.abs(diag)
    return jnp.max(diag + radius)


def cholesky_shifted(M: jnp.ndarray, shift: jnp.ndarray) -> jnp.ndarray:
    """Cholesky of M + shift*I (reference ldlchol's beta-shift,
    solver_interface.c:319-370)."""
    n = M.shape[-1]
    return jnp.linalg.cholesky(M + shift * jnp.eye(n, dtype=M.dtype))


def cho_solve(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve (L L') x = b with two triangular solves."""
    y = solve_triangular(L, b, lower=True)
    return solve_triangular(L, y, lower=True, trans=1)


def schur_matrix(
    Q: jnp.ndarray,
    A: jnp.ndarray,
    sqrt_sigma: jnp.ndarray,
    active: jnp.ndarray,
    gamma_inv: jnp.ndarray,
    proximal: bool,
) -> jnp.ndarray:
    """Assemble M = Q [+ 1/gamma I] + A' diag(sigma*active) A.

    Semantics of ldlcholQAtsigmaA (reference: solver_interface.c:372-405),
    recomputed as one fused matmul instead of sparse rank updates.
    """
    w = jnp.where(active, sqrt_sigma, jnp.zeros_like(sqrt_sigma))
    B = A * w[:, None]
    M = Q + jnp.dot(B.T, B, preferred_element_type=Q.dtype)
    if proximal:
        n = Q.shape[-1]
        M = M + gamma_inv * jnp.eye(n, dtype=Q.dtype)
    return M


def _refine(matvec, L, b, x, max_refine: int, dtype):
    """Iterative refinement on M x = b reusing factor L
    (reference: src/newton.c:57-90, tolerances constants.h:101-103)."""
    if max_refine <= 0:
        return x

    rel_tol = jnp.asarray(1e-10, dtype)
    abs_tol = jnp.asarray(1e-12, dtype)
    ref_norm = jnp.maximum(norm_inf(b), 1.0)

    def cond(carry):
        x, res, k = carry
        return (k < max_refine) & (res > jnp.maximum(rel_tol * ref_norm, abs_tol))

    def body(carry):
        x, _, k = carry
        r = b - matvec(x)
        x = x + cho_solve(L, r)
        return x, norm_inf(b - matvec(x)), k + 1

    r0 = norm_inf(b - matvec(x))
    x, _, _ = jax.lax.while_loop(cond, body, (x, r0, jnp.zeros((), jnp.int32)))
    return x


def newton_solve_schur(
    Q: jnp.ndarray,
    A: jnp.ndarray,
    sqrt_sigma: jnp.ndarray,
    active: jnp.ndarray,
    gamma: jnp.ndarray,
    neg_dphi: jnp.ndarray,
    proximal: bool,
    max_refine: int = 0,
    L: jnp.ndarray | None = None,
    reuse: jnp.ndarray | None = None,
):
    """Solve M d = -dphi with M the Schur matrix; returns (d, L).

    When `reuse` is True the cached factor `L` is used unchanged — the dense
    analogue of the reference skipping re-factorization when the active set
    did not change (newton.c:96-113).
    """
    dtype = Q.dtype
    gamma_inv = jnp.where(jnp.asarray(proximal), 1.0 / gamma, jnp.zeros((), dtype))
    M = schur_matrix(Q, A, sqrt_sigma, active, gamma_inv, proximal)
    L_new = jnp.linalg.cholesky(M)
    if L is not None and reuse is not None:
        L_new = jnp.where(reuse, L, L_new)
    d = cho_solve(L_new, neg_dphi)
    if max_refine > 0:
        matvec = lambda v: M @ v
        d = _refine(matvec, L_new, neg_dphi, d, max_refine, dtype)
    return d, L_new


def select_factorization_method(Q, A, threshold: float = 2.0) -> int:
    """The reference's KKT-vs-Schur auto-selector
    (reference: qpalm_set_factorization_method, solver_interface.c:20-75):
    choose KKT iff (nnz_kkt / nnz_schur_est)^2 * n/(n+m) < threshold, where
    nnz_schur_est over-estimates the fill of Q + A'A per column.

    On the dense device path the distinction is moot — after block elimination
    the KKT system reduces to the Schur system, and dense Schur
    (O(n^2 m) assembly + O(n^3/3) factorization) never loses to dense KKT
    (O((n+m)^3/3)) — so `FACTORIZE_KKT_OR_SCHUR` resolves to Schur in the
    solver.  This function reproduces the reference's *sparse* cost model
    for API parity and for future sparse backends; inputs may be scipy
    sparse or dense arrays.
    """
    import numpy as np

    from .. import constants as C

    if hasattr(Q, "tocsc"):
        Q = Q.tocsc()
        Qnnz = Q.nnz
        n = Q.shape[0]
    else:
        Q = np.asarray(Q)
        Qnnz = int(np.count_nonzero(Q))
        n = Q.shape[0]
    if hasattr(A, "tocsc"):
        As = A.tocsc()
        m = As.shape[0]
        Annz = As.nnz
        col_counts = np.diff(As.indptr)
    else:
        As = np.asarray(A)
        m = As.shape[0]
        Annz = int(np.count_nonzero(As))
        col_counts = np.count_nonzero(As, axis=0)
    nnz_kkt = Qnnz + Annz + m + n  # KKT = [Q+g I, A'; A, -S^-1]
    # per-column A'A fill over-estimate (reference solver_interface.c:40-58)
    nnz_schur = Qnnz + int(np.sum(np.minimum(col_counts * Annz / max(m, 1), n)))
    ratio = (nnz_kkt / max(nnz_schur, 1)) ** 2 * n / max(n + m, 1)
    return C.FACTORIZE_KKT if ratio < threshold else C.FACTORIZE_SCHUR


def newton_solve_kkt(
    Q: jnp.ndarray,
    A: jnp.ndarray,
    sigma: jnp.ndarray,
    active: jnp.ndarray,
    gamma: jnp.ndarray,
    neg_dphi: jnp.ndarray,
    proximal: bool,
):
    """Solve the quasi-definite KKT system

        [ Q + 1/gamma I   Aact' ] [d]   [-dphi]
        [ Aact          -Sact^-1] [v] = [  0  ]

    with inactive constraint rows replaced by a unit diagonal (the reference's
    fixed-sparsity trick, solver_interface.c:145-174).  Returns the primal
    component d.

    The quasi-definite system is solved by block elimination of the (2,2)
    block (v = D^-1 B d), which is exact because D is diagonal positive
    definite, so no LU is needed; on a dense
    layout the KKT and Schur formulations coincide after elimination — the
    reference's KKT/Schur distinction is purely a sparse-fill concern
    (solver_interface.c:20-75).
    """
    n = Q.shape[-1]
    dtype = Q.dtype
    actf = active.astype(dtype)
    Am = A * actf[:, None]
    # (2,2) block is -D with D = 1/sigma on active rows, 1 (unit) on inactive
    d_inv = jnp.where(active, sigma, jnp.ones_like(sigma))
    gamma_inv = jnp.where(jnp.asarray(proximal), 1.0 / gamma, jnp.zeros((), dtype))
    P = Q + gamma_inv * jnp.eye(n, dtype=dtype)
    S = P + jnp.dot(Am.T * d_inv[None, :], Am, preferred_element_type=dtype)
    return cho_solve(jnp.linalg.cholesky(S), neg_dphi)
