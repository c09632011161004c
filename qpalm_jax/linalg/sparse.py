"""Sparse (BCOO) helpers for the large-problem path.

The reference's whole linear-system layer is sparse (LADEL/CHOLMOD CSC,
SURVEY §2.2); the dense device path covers small/medium problems, and
this module provides what the *large* sparse path needs without ever
materializing an n x n dense matrix:

  * scipy CSC -> jax.experimental.sparse.BCOO conversion
  * row/column inf-norms (Ruiz scaling, reference scaling.c:49-80 /
    mat_inf_norm_cols/rows, solver_interface.h:139-156)
  * row/column scaling E A D without densifying
  * diag(Q), diag(A' diag(s) A) — the Jacobi preconditioner of the CG
    Newton solver
  * a Gershgorin-style upper bound on lambda_max(A' diag(s) A) via
    |A|' s (|A| 1) (>= the dense Gershgorin bound of nonconvex.c:185-210;
    conservative is safe where it is used — gamma boosting)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import sparse as jsparse

BCOO = jsparse.BCOO


def is_sparse(M) -> bool:
    return isinstance(M, BCOO)


def from_scipy(M, dtype=None) -> BCOO:
    """scipy sparse -> BCOO (sorted indices)."""
    coo = M.tocoo()
    data = np.asarray(coo.data, dtype or coo.data.dtype)
    indices = np.stack([coo.row, coo.col], axis=1).astype(np.int32)
    return BCOO(
        (jnp.asarray(data), jnp.asarray(indices)), shape=M.shape
    ).sort_indices()


def row_inf_norms(A: BCOO) -> jnp.ndarray:
    m = A.shape[0]
    # segment_max yields -inf on empty rows; a zero row has inf-norm 0
    return jnp.maximum(
        jax.ops.segment_max(jnp.abs(A.data), A.indices[:, 0], num_segments=m),
        0.0,
    )


def col_inf_norms(A: BCOO) -> jnp.ndarray:
    n = A.shape[1]
    return jnp.maximum(
        jax.ops.segment_max(jnp.abs(A.data), A.indices[:, 1], num_segments=n),
        0.0,
    )


def scale_rows_cols(A: BCOO, E: jnp.ndarray, D: jnp.ndarray) -> BCOO:
    """E A D without densifying (reference scaling.c:66-74 semantics)."""
    data = A.data * E[A.indices[:, 0]] * D[A.indices[:, 1]]
    return BCOO((data, A.indices), shape=A.shape)


def scale_scalar(A: BCOO, c) -> BCOO:
    return BCOO((A.data * c, A.indices), shape=A.shape)


def sym_diag(Q: BCOO) -> jnp.ndarray:
    """diag of a symmetric BCOO matrix."""
    n = Q.shape[0]
    on_diag = Q.indices[:, 0] == Q.indices[:, 1]
    return jax.ops.segment_sum(
        jnp.where(on_diag, Q.data, 0.0), Q.indices[:, 0], num_segments=n
    )


def ata_diag(A: BCOO, s: jnp.ndarray) -> jnp.ndarray:
    """diag(A' diag(s) A) = sum_i s_i a_ij^2 per column j."""
    n = A.shape[1]
    return jax.ops.segment_sum(
        s[A.indices[:, 0]] * A.data * A.data,
        A.indices[:, 1],
        num_segments=n,
    )


def ata_gershgorin_upper(A: BCOO, s: jnp.ndarray) -> jnp.ndarray:
    """max_j (|A|' diag(s) |A| 1)_j >= gershgorin_max(A' diag(s) A).

    Two sparse matvecs; an upper bound by the triangle inequality, used for
    the gamma boost (reference iteration.c:158-205) where a conservative
    bound only makes the boosted gamma smaller (safe).
    """
    absA = BCOO((jnp.abs(A.data), A.indices), shape=A.shape)
    r = absA @ jnp.ones((A.shape[1],), A.data.dtype)  # |A| 1
    v = (absA.T @ (s * r))
    return jnp.max(v)


def block_diagonals(Q, A, sig_act, gamma_inv, block: int):
    """Stacked block diagonals of M = Q + A' diag(sig_act) A + gamma_inv I.

    The block-Jacobi preconditioner's setup (no reference equivalent — the
    reference factors the whole sparse matrix; this is the
    middle ground between diag(M) and a full factorization).  Works for
    BCOO or dense Q/A: each block's columns are materialized with one
    (sparse) matrix-times-selector product inside a `lax.scan` over blocks,
    so the full matrix is never densified.

    Returns (nblocks, block, block) with the tail block padded by identity
    rows/columns when block does not divide n.
    """
    n = Q.shape[0]
    nblocks = -(-n // block)
    dtype = sig_act.dtype

    def one(carry, b_idx):
        cols = b_idx * block + jnp.arange(block)
        valid = cols < n
        cols_c = jnp.minimum(cols, n - 1)
        Eb = (
            jax.nn.one_hot(cols_c, n, dtype=dtype).T
            * valid.astype(dtype)[None, :]
        )  # (n, block) selector
        AEb = A @ Eb                       # (m, block)
        QEb = Q @ Eb                       # (n, block)
        Qblk = Eb.T @ QEb                  # (block, block) rows of the block
        G = AEb.T @ (sig_act[:, None] * AEb)
        blk = Qblk + G + gamma_inv * jnp.eye(block, dtype=dtype)
        # padded tail columns: identity so the factor stays SPD
        pad = ~(valid[:, None] & valid[None, :])
        eye = jnp.eye(block, dtype=dtype)
        blk = jnp.where(pad, eye, blk)
        return carry, blk

    _, blocks = jax.lax.scan(one, 0, jnp.arange(nblocks))
    return blocks


def block_jacobi_apply(chol_blocks, r):
    """Apply the factored block-Jacobi preconditioner to a vector.

    chol_blocks: (nblocks, block, block) lower Cholesky factors of the
    block diagonals; r: (n,).  Pads r to nblocks*block, solves per block
    (batched triangular solves), and truncates back.
    """
    from jax.scipy.linalg import solve_triangular

    nblocks, block, _ = chol_blocks.shape
    n = r.shape[0]
    rp = jnp.zeros((nblocks * block,), r.dtype).at[:n].set(r)
    rb = rp.reshape(nblocks, block, 1)
    y = solve_triangular(chol_blocks, rb, lower=True)
    z = solve_triangular(
        jnp.swapaxes(chol_blocks, -1, -2), y, lower=False
    )
    return z.reshape(-1)[:n]
