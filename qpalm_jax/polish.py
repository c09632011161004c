"""Active-set solution polish: one float64 KKT solve that upgrades a float32
solution to reference (1e-6) accuracy.

The reference solver is all-double (reference: include/global_opts.h:21,61)
so it never needs this; this framework runs its bulk pass in float32,
which floors the achievable residuals near ~3e-5.  Rather than
re-running the whole P-ALM loop in f64,
this module takes the f32 solution's *active set* — which is correct long
before the last digits of x are — and solves the equality-constrained QP it
implies with one regularized KKT factorization per lane in f64 on the host:

    [ Q        A_act' ] [x]   [ -q     ]
    [ A_act   -delta*I ] [nu] = [ b_act  ]      (inactive rows: nu_k = 0)

followed by iterative refinement against the unregularized system, active-set
re-detection, and a full KKT check (primal feasibility, stationarity,
complementarity sign) at the target eps.  Lanes whose check fails are
reported unpolished, so callers fall back to a full f64 re-solve for them.

The per-lane cost is one (n+m)^3/3 LU + a few matvecs — roughly one Newton
iteration of the f64 solver, vs ~10 warm-started iterations for an iterative
finish.  Fixed shapes and a lane axis throughout, so the whole polish is one
jitted batched program.

This augments the reference's accuracy pipeline rather than mirroring a
component (the inactive-row identity embedding is the same trick as the
reference's KKT assembly, reference: src/solver_interface.c:145-169).
"""

from __future__ import annotations

import functools
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as C
from .precision import full_matmul_precision
from .types import QPData


class PolishResult(NamedTuple):
    x: jnp.ndarray  # (B, n) polished primal solutions
    y: jnp.ndarray  # (B, m) polished dual solutions
    ok: jnp.ndarray  # (B,) bool: full KKT check passed at (eps_abs, eps_rel)
    pri_res: jnp.ndarray  # (B,) achieved unscaled primal residual inf-norm
    dua_res: jnp.ndarray  # (B,) achieved unscaled dual residual inf-norm
    objective: jnp.ndarray  # (B,)


_DELTA_REG = 1e-9  # KKT regularization; removed by iterative refinement


# Per-thread reusable K-buffer cache: the bench pipeline calls the polish
# once per round with identical shapes, and np.zeros of a ~70 MB stack
# costs ~10 ms/round in page faults alone.  Keyed by (shape, dtype); only
# the previous buffer per thread is kept (shapes are stable within a run).
_kbuf_local = threading.local()


def _get_kbuf(shape, dtype):
    """Uninitialized per-thread buffer; the caller must write every
    element (build_K does).  Reused across calls of the same shape."""
    cached = getattr(_kbuf_local, "buf", None)
    if cached is not None and cached.shape == shape and cached.dtype == dtype:
        return cached
    buf = np.empty(shape, dtype)
    _kbuf_local.buf = buf
    return buf


def _get_kf_buf(shape):
    """Per-thread f32 factor workspace for the mixed-precision path (the
    native factor writes every element)."""
    cached = getattr(_kbuf_local, "fbuf", None)
    if cached is not None and cached.shape == shape:
        return cached
    buf = np.empty(shape, np.float32)
    _kbuf_local.fbuf = buf
    return buf


def _bkkt_lib():
    """The native batched symmetric-indefinite solver (Bunch-Kaufman
    dsytrf/dsytrs, native/batch_kkt.cpp): half the FLOPs of numpy's
    batched LU on the symmetric polish KKT systems, with factor reuse
    for the refinement re-solves.  None when the native lib is absent."""
    from .linalg.sparse_direct import load_library

    lib = load_library()
    return lib if lib is not None and hasattr(lib, "bkkt_factor_solve") \
        else None


def _polish_one(data: QPData, x0, y0, eps_abs, eps_rel, act_tol, rounds,
                refine_steps):
    """Polish a single lane (vmapped by `polish_batch`)."""
    n, m = data.n, data.m
    Q, A, q, bmin, bmax = data.Q, data.A, data.q, data.bmin, data.bmax

    has_lb = bmin > -C.QPALM_INFTY
    has_ub = bmax < C.QPALM_INFTY

    # y_strong: a multiplier this large marks the row active regardless of
    #   slack (must exceed the f32 dual noise, ~2e-5 at this tolerance).
    # y_zero:  |y| below this is numerically zero — a row at the bound stays
    #   active only while its multiplier is not wrong-signed beyond this.
    #   Aligned with the eps_abs used in the complementarity check, so a row
    #   the check would flag is always dropped at the next detection.
    y_strong = act_tol
    y_zero = eps_abs

    def detect(x, y):
        Ax = A @ x
        # a row is polished-active if it carries a clearly nonzero multiplier
        # of the matching sign, or sits at the bound WITHOUT a wrong-sign
        # multiplier.  The sign filter is what un-sticks rows a previous
        # round forced to the bound erroneously: their KKT multiplier comes
        # out with the wrong sign (pulling inward), so they are dropped on
        # the next detection instead of staying active forever at slack 0.
        act_lo = has_lb & (
            (y < -y_strong) | ((Ax - bmin < act_tol) & (y <= y_zero))
        )
        act_hi = has_ub & (
            (y > y_strong) | ((bmax - Ax < act_tol) & (y >= -y_zero))
        )
        # equalities are always active on their (identical) bound; the
        # threshold must be near-exact — a merely *narrow* range row
        # (bmax - bmin ~ act_tol) has a genuine side to be on
        eq = has_lb & has_ub & (
            bmax - bmin <= 1e-12 * jnp.maximum(1.0, jnp.abs(bmax))
        )
        act_lo = act_lo | eq
        act_hi = act_hi & ~act_lo  # lower wins ties; eq uses bmin side
        return act_lo, act_hi

    def kkt_solve(act_lo, act_hi):
        act = act_lo | act_hi
        w = act.astype(Q.dtype)
        Aact = A * w[:, None]
        K = jnp.zeros((n + m, n + m), Q.dtype)
        K = K.at[:n, :n].set(Q)
        K = K.at[:n, n:].set(Aact.T)
        K = K.at[n:, :n].set(Aact)
        K = K.at[n:, n:].set(jnp.diag(jnp.where(act, -_DELTA_REG, 1.0)))
        b_side = jnp.where(act_lo, bmin, bmax)
        rhs = jnp.concatenate([-q, jnp.where(act, b_side, 0.0)])
        lu, piv = jax.scipy.linalg.lu_factor(K)
        sol = jax.scipy.linalg.lu_solve((lu, piv), rhs)

        def unreg_mv(v):
            vx, vn = v[:n], v[n:]
            top = Q @ vx + Aact.T @ vn
            bot = Aact @ vx + jnp.where(act, 0.0, vn)
            return jnp.concatenate([top, bot])

        def refine(_, s):
            r = rhs - unreg_mv(s)
            return s + jax.scipy.linalg.lu_solve((lu, piv), r)

        sol = jax.lax.fori_loop(0, refine_steps, refine, sol)
        x = sol[:n]
        y = jnp.where(act, sol[n:], 0.0)
        return x, y

    def check(x, y):
        """Full unscaled KKT check (termination.c:44-129 semantics with the
        identity scaling, plus the complementarity sign condition).  Returns
        (violation score <= 1 means pass, pri_norm, dua_norm, objective)."""
        Ax = A @ x
        z = jnp.clip(Ax, jnp.maximum(bmin, -C.QPALM_INFTY),
                     jnp.minimum(bmax, C.QPALM_INFTY))
        pri = Ax - z
        pri_norm = jnp.max(jnp.abs(pri)) if m else jnp.zeros((), x.dtype)
        Qx = Q @ x
        dua = Qx + q + A.T @ y
        dua_norm = jnp.max(jnp.abs(dua))
        eps_pri = eps_abs + eps_rel * jnp.maximum(
            jnp.max(jnp.abs(Ax)), jnp.max(jnp.abs(z))
        )
        eps_dua = eps_abs + eps_rel * jnp.maximum(
            jnp.max(jnp.abs(Qx)),
            jnp.maximum(jnp.max(jnp.abs(q)), jnp.max(jnp.abs(A.T @ y))),
        )
        # complementarity: positive y demands Ax at bmax, negative at bmin
        # (|y| below eps_abs is numerically zero — no side demanded)
        comp_viol = jnp.max(
            jnp.where(y > eps_abs, jnp.abs(Ax - bmax), 0.0)
            + jnp.where(y < -eps_abs, jnp.abs(Ax - bmin), 0.0)
        ) if m else jnp.zeros((), x.dtype)
        viol = jnp.maximum(
            jnp.maximum(pri_norm / eps_pri, dua_norm / eps_dua),
            comp_viol / (eps_pri + eps_abs),
        )
        obj = 0.5 * jnp.vdot(x, Qx) + jnp.vdot(q, x) + data.c
        return viol, pri_norm, dua_norm, obj

    # best-point tracking: each round keeps the lowest KKT violation seen,
    # so a misdetected round can never degrade the reported solution
    best = (check(x0, y0), x0, y0)
    x, y = x0, y0
    for _ in range(rounds):
        act_lo, act_hi = detect(x, y)
        x, y = kkt_solve(act_lo, act_hi)
        cand = (check(x, y), x, y)
        better = cand[0][0] < best[0][0]
        best = jax.tree.map(
            lambda a, b: jnp.where(better, a, b), cand, best
        )
    (viol, pri_norm, dua_norm, obj), xb, yb = best
    return PolishResult(
        x=xb, y=yb, ok=viol <= 1.0,
        pri_res=pri_norm, dua_res=dua_norm, objective=obj,
    )


@functools.partial(
    jax.jit,
    static_argnames=("eps_abs", "eps_rel", "act_tol", "rounds",
                     "refine_steps"),
)
@full_matmul_precision
def polish_batch(
    data: QPData,
    x: jnp.ndarray,
    y: jnp.ndarray,
    eps_abs: float = 1e-6,
    eps_rel: float = 1e-6,
    act_tol: float = 1e-4,
    rounds: int = 2,
    refine_steps: int = 2,
) -> PolishResult:
    """Polish a stacked batch of solutions (leading axis on every arg).

    `data` must be float64 *unscaled* problem data (the same padded stack the
    batch solver consumed); `x`/`y` are the f32 pass's solutions, any dtype.
    It solves each lane's KKT system with LU.
    """
    data64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), data)
    x64 = jnp.asarray(x, jnp.float64)
    y64 = jnp.asarray(y, jnp.float64)
    axes = QPData(Q=0, A=0, q=0, bmin=0, bmax=0, c=0)
    return jax.vmap(
        _polish_one, in_axes=(axes, 0, 0, None, None, None, None, None)
    )(data64, x64, y64, eps_abs, eps_rel, act_tol, rounds, refine_steps)


# ---------------------------------------------------------------------------
# Threaded pure-numpy host path.  Semantics identical to `polish_batch`
# (asserted by tests/test_polish.py::test_np_matches_jax); exists because
# XLA:CPU runs the batched (n+m) LU one lane at a time on one core, while
# numpy's stacked `np.linalg.solve` + a thread pool over batch chunks uses
# every host core (LAPACK releases the GIL) — ~5x faster at the benchmark
# shape (B=512, n=64, m=96), which takes the polish off the bench pipeline's
# critical path.
# ---------------------------------------------------------------------------


def _np_solve_or_nan(K, rhs):
    """Batched np.linalg.solve that NaN-fills exactly-singular lanes
    instead of raising: a singular polish KKT (wrong f32 active set on a
    degenerate problem) must mark the lane failed — the KKT `check`
    gates every result and the finisher picks the lane up — not crash
    the whole batch (observed: LinAlgError in the workloads sweep's
    randomQP n=20 B=2048 run)."""
    try:
        return np.linalg.solve(K, rhs)
    except np.linalg.LinAlgError:
        # One singular lane poisons the whole stacked gesv call.  Find the
        # singular lanes cheaply (LU condition estimate per lane — one
        # batched getrf-equivalent, not B sequential solves), NaN-fill
        # only those, and solve the healthy lanes in one batched call.
        out = np.full(rhs.shape, np.nan, rhs.dtype)
        with np.errstate(all="ignore"):
            # rcond via SVD is overkill; a determinant-free singularity
            # probe: lanes whose condition number is effectively infinite.
            cond = np.linalg.cond(K)
        good = np.isfinite(cond) & (cond < 1.0 / np.finfo(K.dtype).eps)
        if good.any():
            try:
                out[good] = np.linalg.solve(K[good], rhs[good])
            except np.linalg.LinAlgError:
                # cond missed a numerically singular lane; last resort is
                # the per-lane sweep over the (rare) surviving subset.
                idx = np.flatnonzero(good)
                for i in idx:
                    try:
                        out[i] = np.linalg.solve(K[i], rhs[i])
                    except np.linalg.LinAlgError:
                        pass
        return out


def _np_polish_chunk(Q, A, q, bmin, bmax, c, x0, y0,
                     eps_abs, eps_rel, act_tol, rounds, refine_steps,
                     compress=True, precision="f64"):
    """Polish a (B, ...) chunk in numpy.  Mirrors `_polish_one` exactly —
    see that function for the rationale behind each rule.

    `compress=True` solves the KKT system with the inactive rows removed
    (a symmetric permutation that moves each lane's active rows first,
    truncated at the chunk's max active count): the inactive rows are
    decoupled `nu_k = 0` identity equations, so the compacted system has
    the identical solution while the LU shrinks from (n+m)^3 to
    (n+mact_max)^3 — typically ~2x fewer FLOPs at mact <= n < m."""
    B, m, n = A.shape
    nm = n + m
    has_lb = bmin > -C.QPALM_INFTY
    has_ub = bmax < C.QPALM_INFTY
    y_strong, y_zero = act_tol, eps_abs
    eq = has_lb & has_ub & (
        bmax - bmin <= 1e-12 * np.maximum(1.0, np.abs(bmax))
    )

    # batched matvec forms: np.matmul loops BLAS gemm over the batch —
    # measurably faster than numpy's c_einsum on these (B, m, n) stacks,
    # and the polish hot path is host data movement, not LAPACK
    def _mv(M, v):                       # (B, r, c) @ (B, c) -> (B, r)
        return np.matmul(M, v[:, :, None])[:, :, 0]

    def _vm(v, M):                       # (B, r) @ (B, r, c) -> (B, c)
        return np.matmul(v[:, None, :], M)[:, 0, :]

    def detect(x, y):
        Ax = _mv(A, x)
        act_lo = has_lb & (
            (y < -y_strong) | ((Ax - bmin < act_tol) & (y <= y_zero))
        )
        act_hi = has_ub & (
            (y > y_strong) | ((bmax - Ax < act_tol) & (y >= -y_zero))
        )
        act_lo = act_lo | eq
        act_hi = act_hi & ~act_lo
        return act_lo, act_hi

    def kkt_solve(act_lo, act_hi):
        act = act_lo | act_hi
        b_side = np.where(act_lo, bmin, bmax)
        if compress:
            # active rows first per lane, truncated at the chunk max
            order = np.argsort(~act, axis=1, kind="stable")
            cap = int(act.sum(axis=1).max()) if m else 0
            idx = order[:, :cap]                       # (B, cap)
            sel = np.take_along_axis(act, idx, 1)      # (B, cap)
            Asub = np.take_along_axis(A, idx[:, :, None], 1)
            bsub = np.take_along_axis(b_side, idx, 1)
            mc = cap
        else:
            idx = sel = None
            Asub, bsub, mc = A, b_side, m
        wc = sel if compress else act
        Aact = Asub * wc[:, :, None].astype(Q.dtype)
        nk = n + mc

        def build_K(fresh=False):
            # every element of K is written below, so the reusable buffer
            # can be handed out uninitialized.  `fresh=True` forces a new
            # allocation — used for the per-lane rebuild after the factor
            # destroyed the shared buffer in place (the healthy lanes'
            # factors must survive for the refinement re-solves).
            K = (np.empty((B, nk, nk), Q.dtype) if fresh
                 else _get_kbuf((B, nk, nk), Q.dtype))
            K[:, :n, :n] = Q
            K[:, :n, n:] = Aact.transpose(0, 2, 1)
            K[:, n:, :n] = Aact
            K22 = K[:, n:, n:]
            K22[...] = 0.0
            dix = np.arange(mc)
            K22[:, dix, dix] = np.where(wc, -_DELTA_REG, 1.0)
            return K

        K = build_K()
        rhs = np.concatenate([-q, np.where(wc, bsub, 0.0)], axis=1)
        # native Bunch-Kaufman path (compress only — the compress=False
        # path stays the exact operation-for-operation twin of the jitted
        # polish, numpy LU included)
        lib = _bkkt_lib() if compress else None
        sol = resolve = None
        if (lib is not None and precision == "mixed"
                and hasattr(lib, "bkkt_factor_solve_f32")):
            # mixed-precision fast path (bench polish hot leg): f32
            # Bunch-Kaufman factor (half the FLOPs and traffic) + f64
            # refinement against the unregularized structure — the caller
            # should pass refine_steps >= 2.  K is NOT destroyed (the
            # factor lives in the f32 workspace), so failed lanes reuse
            # it directly.  Accuracy is gated by the same KKT check; any
            # lane the f32 factor cannot serve lands in the f64 retry.
            Kf = _get_kf_buf((B, nk, nk))
            ipiv = np.empty((B, nk), np.int32)
            failv = np.empty(B, np.int32)
            sol_m = rhs.copy()
            nf = lib.bkkt_factor_solve_f32(B, nk, K, Kf, ipiv, sol_m,
                                           failv)
            if 0 <= nf < B:
                bad = np.where(failv.astype(bool))[0]
                if len(bad):
                    sol_m[bad] = _np_solve_or_nan(
                        K[bad], rhs[bad, :, None])[:, :, 0]
                sol = sol_m

                def resolve(r):
                    rc = np.ascontiguousarray(r)
                    ok = lib.bkkt_resolve_f32(B, nk, Kf, ipiv, rc, failv)
                    if ok != 0:
                        return np.zeros_like(rc)
                    if len(bad):
                        rc[bad] = _np_solve_or_nan(
                            K[bad], r[bad, :, None])[:, :, 0]
                    return rc
        if lib is not None and sol is None:
            ipiv = np.empty((B, nk), np.int32)
            failv = np.empty(B, np.int32)
            sol_n = rhs.copy()
            nf = lib.bkkt_factor_solve(B, nk, K, ipiv, sol_n, failv)
            if 0 <= nf < B:
                bad = np.where(failv.astype(bool))[0]
                if len(bad):
                    # per-lane fallback: the factor destroyed the failed
                    # lanes' K in place — rebuild just those and LU-solve
                    # them; healthy lanes keep their BK factors
                    K_bad = build_K(fresh=True)[bad]
                    sol_n[bad] = _np_solve_or_nan(
                        K_bad, rhs[bad, :, None])[:, :, 0]
                sol = sol_n

                def resolve(r):
                    rc = np.ascontiguousarray(r)
                    ok = lib.bkkt_resolve(B, nk, K, ipiv, rc, failv)
                    if ok != 0:
                        # never observed: skip the correction, the KKT
                        # check still gates the result
                        return np.zeros_like(rc)
                    if len(bad):
                        rc[bad] = _np_solve_or_nan(
                            K_bad, r[bad, :, None])[:, :, 0]
                    return rc
            else:
                # native error (nf < 0) or all-lane breakdown: rebuild K
                # (destroyed in place) and take the LU path for the chunk
                K = build_K()
        if sol is None:
            sol = _np_solve_or_nan(K, rhs[:, :, None])[:, :, 0]

            def resolve(r):
                return _np_solve_or_nan(K, r[:, :, None])[:, :, 0]
        for _ in range(refine_steps):
            sx, sn = sol[:, :n], sol[:, n:]
            top = _mv(Q, sx) + _vm(sn, Aact)
            bot = _mv(Aact, sx) + np.where(wc, 0.0, sn)
            r = rhs - np.concatenate([top, bot], axis=1)
            sol = sol + resolve(r)
        x = sol[:, :n]
        if compress:
            y = np.zeros((B, m), Q.dtype)
            np.put_along_axis(y, idx, sol[:, n:] * sel, 1)
        else:
            y = np.where(act, sol[:, n:], 0.0)
        return x, y

    def check(x, y):
        Ax = _mv(A, x)
        z = np.clip(Ax, np.maximum(bmin, -C.QPALM_INFTY),
                    np.minimum(bmax, C.QPALM_INFTY))
        pri_norm = (np.max(np.abs(Ax - z), axis=1) if m
                    else np.zeros(B, x.dtype))
        Qx = _mv(Q, x)
        Aty = _vm(y, A)
        dua = Qx + q + Aty
        dua_norm = np.max(np.abs(dua), axis=1)
        eps_pri = eps_abs + eps_rel * np.maximum(
            np.max(np.abs(Ax), axis=1), np.max(np.abs(z), axis=1)
        )
        eps_dua = eps_abs + eps_rel * np.maximum(
            np.max(np.abs(Qx), axis=1),
            np.maximum(np.max(np.abs(q), axis=1),
                       np.max(np.abs(Aty), axis=1)),
        )
        comp_viol = (np.max(
            np.where(y > eps_abs, np.abs(Ax - bmax), 0.0)
            + np.where(y < -eps_abs, np.abs(Ax - bmin), 0.0), axis=1,
        ) if m else np.zeros(B, x.dtype))
        viol = np.maximum(
            np.maximum(pri_norm / eps_pri, dua_norm / eps_dua),
            comp_viol / (eps_pri + eps_abs),
        )
        obj = np.sum((0.5 * Qx + q) * x, axis=1) + c
        return viol, pri_norm, dua_norm, obj

    best_chk = check(x0, y0)
    best_x, best_y = x0.copy(), y0.copy()
    x, y = x0, y0
    for _ in range(rounds):
        act_lo, act_hi = detect(x, y)
        x, y = kkt_solve(act_lo, act_hi)
        chk = check(x, y)
        better = chk[0] < best_chk[0]
        best_chk = tuple(np.where(better, a, b)
                         for a, b in zip(chk, best_chk))
        best_x = np.where(better[:, None], x, best_x)
        best_y = np.where(better[:, None], y, best_y)
    viol, pri_norm, dua_norm, obj = best_chk
    return PolishResult(
        x=best_x, y=best_y, ok=viol <= 1.0,
        pri_res=pri_norm, dua_res=dua_norm, objective=obj,
    )


def polish_batch_np(
    data: QPData,
    x: np.ndarray,
    y: np.ndarray,
    eps_abs: float = 1e-6,
    eps_rel: float = 1e-6,
    act_tol: float = 1e-4,
    rounds: int = 2,
    refine_steps: int = 2,
    threads: int = 4,
    compress: bool = True,
    precision: str = "f64",
) -> PolishResult:
    """Host-threaded numpy twin of `polish_batch` (same contract).

    `precision="mixed"` factors the KKT systems in float32 (native
    ssytrf; ~2x faster and half the memory traffic) and recovers f64
    accuracy through `refine_steps` rounds of f64 iterative refinement —
    pass refine_steps >= 2 with it.  Any lane the f32 factor cannot serve
    is gated out by the KKT check exactly like an f64 failure.

    `data`/`x`/`y` should be host (numpy) arrays — device arrays are
    converted one field at a time; fetch device-resident inputs with one
    `jax.device_get` first.

    `compress=False` forces the full (n+m) KKT solve (the exact
    operation-for-operation twin of `polish_batch`); the default solves
    the compacted active-rows-only system — identical in exact
    arithmetic, ~2x faster, but a different LU rounding path.
    """
    Q = np.asarray(data.Q, np.float64)
    A = np.asarray(data.A, np.float64)
    q = np.asarray(data.q, np.float64)
    bmin = np.asarray(data.bmin, np.float64)
    bmax = np.asarray(data.bmax, np.float64)
    c = np.asarray(data.c, np.float64)
    x0 = np.asarray(x, np.float64)
    y0 = np.asarray(y, np.float64)
    B = Q.shape[0]
    nch = max(1, min(threads, B))
    bounds = np.linspace(0, B, nch + 1).astype(int)
    args = [(Q[a:b], A[a:b], q[a:b], bmin[a:b], bmax[a:b], c[a:b],
             x0[a:b], y0[a:b], eps_abs, eps_rel, act_tol, rounds,
             refine_steps, compress, precision)
            for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
    # one BLAS thread everywhere: the chunks already use every core, so
    # OpenBLAS threading inside dsytrf/gesv on top is pure oversubscription
    # (measured 3.3x slower on the lasso shape: 0.48 s vs 0.15 s at B=512,
    # nk~150, 4 cores).  This applies to the single-chunk path too — the
    # per-lane LAPACK calls are far too small for threaded BLAS, and the
    # thread-sync overhead dominated the bench retry pass (22 ms for 10
    # lanes before; ~3 ms after).
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # pragma: no cover - baked into this env
        import contextlib
        threadpool_limits = lambda limits: contextlib.nullcontext()
    with threadpool_limits(limits=1):
        if len(args) == 1:
            parts = [_np_polish_chunk(*args[0])]
        else:
            parts = list(_polish_pool().map(
                lambda t: _np_polish_chunk(*t), args))
    return PolishResult(*(np.concatenate([getattr(p, f) for p in parts])
                          for f in PolishResult._fields))


_pool_holder = []


def _polish_pool():
    """Persistent worker pool (spawning a fresh ThreadPoolExecutor per call
    costs ~1 ms and defeats the per-thread K-buffer reuse)."""
    if not _pool_holder:
        _pool_holder.append(ThreadPoolExecutor(max_workers=8))
    return _pool_holder[0]
