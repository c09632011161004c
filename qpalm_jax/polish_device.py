"""On-device active-set polish: certify f32 solutions at 1e-6 on the
device that produced them.

The host polish (`qpalm_jax.polish`) certifies lanes with one f64 KKT solve
per lane on host cores.  This module runs the same certification as one
XLA program on the device that already holds the batch:

  * active-set detection from the f32 iterates — same rules as
    `polish._polish_one` (multiplier sign + slack tolerance + equality
    rows), evaluated in f64,
  * a float32 batched Cholesky of the PRIMAL regularized form
        P = Q + A_act' A_act / delta_hat
    as the preconditioner M = [[Q, Aact'], [Aact, -delta_hat I (+) I]]
    (block elimination of the dual => exactly one SPD n x n factor —
    and P stays SPD even when the detected active set is rank-deficient,
    where the host path's indefinite KKT factorization goes singular),
  * iterative refinement against the TRUE polish KKT system (the host
    module's delta = 1e-9 regularization).  Residuals are evaluated in f64
    by default; `residual32=True` evaluates residuals and the check with
    f32 'highest' matmuls instead.  The f32 residual floor (~4e-7 absolute
    — a residual is a cancellation, so its error is u32 * ||terms||
    regardless of iterate precision) sits well under the 1e-6-protocol
    thresholds; `accept_viol` then gates certification with a margin so the
    f32 measurement error cannot mis-certify a lane,
  * the full unscaled-problem KKT check (primal + dual residuals +
    complementarity sign) on device — identical formulas to
    `polish._polish_one.check` (reference termination.c:44-129 semantics
    with identity scaling).

Per refinement sweep the error contracts by ~max(delta_hat, cond(P)*u32);
with delta_hat = 1e-2 and the bench problem class, 3 sweeps take an f32
seed (~1e-3) to the residual floor.  Lanes whose check fails (wrong f32
active set, extreme conditioning) are reported unpolished, exactly like
the host polish — callers route them to a host rescue path and should
re-verify device-certified lanes with an exact host check when the
certification claim matters (bench.py's untimed referee does).

Parity: tests/test_polish.py::test_device_polish_matches_np; on the GPU,
chip_smoke.py's fleet phase re-checks every device-certified lane on the
host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import constants as C
from .precision import full_matmul_precision
from .types import QPData


class DevicePolishResult(NamedTuple):
    x: jnp.ndarray        # (B, n) f64 polished primal
    y: jnp.ndarray        # (B, m) f64 polished dual
    ok: jnp.ndarray       # (B,) bool — full KKT check at (eps_abs, eps_rel)
    pri_res: jnp.ndarray  # (B,) unscaled primal residual inf-norm
    dua_res: jnp.ndarray  # (B,) unscaled dual residual inf-norm
    objective: jnp.ndarray  # (B,)


_DELTA_REG = 1e-9  # the true system's regularization (matches polish.py)


def _detect(A, bmin, bmax, x, y, act_tol, eps_abs):
    """Active-set rules of polish._polish_one.detect, batched, f64."""
    has_lb = bmin > -C.QPALM_INFTY
    has_ub = bmax < C.QPALM_INFTY
    y_strong, y_zero = act_tol, eps_abs
    Ax = jnp.einsum("bmn,bn->bm", A, x)
    act_lo = has_lb & (
        (y < -y_strong) | ((Ax - bmin < act_tol) & (y <= y_zero))
    )
    act_hi = has_ub & (
        (y > y_strong) | ((bmax - Ax < act_tol) & (y >= -y_zero))
    )
    eq = has_lb & has_ub & (
        bmax - bmin <= 1e-12 * jnp.maximum(1.0, jnp.abs(bmax))
    )
    act_lo = act_lo | eq
    act_hi = act_hi & ~act_lo
    return act_lo, act_hi


def _check(Q, A, q, bmin, bmax, c, x, y, eps_abs, eps_rel):
    """Full unscaled KKT check, batched, f64 (twin of polish.check)."""
    Ax = jnp.einsum("bmn,bn->bm", A, x)
    z = jnp.clip(Ax, jnp.maximum(bmin, -C.QPALM_INFTY),
                 jnp.minimum(bmax, C.QPALM_INFTY))
    pri_norm = jnp.max(jnp.abs(Ax - z), axis=1)
    Qx = jnp.einsum("bij,bj->bi", Q, x)
    Aty = jnp.einsum("bmn,bm->bn", A, y)
    dua = Qx + q + Aty
    dua_norm = jnp.max(jnp.abs(dua), axis=1)
    eps_pri = eps_abs + eps_rel * jnp.maximum(
        jnp.max(jnp.abs(Ax), axis=1), jnp.max(jnp.abs(z), axis=1)
    )
    eps_dua = eps_abs + eps_rel * jnp.maximum(
        jnp.max(jnp.abs(Qx), axis=1),
        jnp.maximum(jnp.max(jnp.abs(q), axis=1),
                    jnp.max(jnp.abs(Aty), axis=1)),
    )
    comp_viol = jnp.max(
        jnp.where(y > eps_abs, jnp.abs(Ax - bmax), 0.0)
        + jnp.where(y < -eps_abs, jnp.abs(Ax - bmin), 0.0), axis=1,
    )
    viol = jnp.maximum(
        jnp.maximum(pri_norm / eps_pri, dua_norm / eps_dua),
        comp_viol / (eps_pri + eps_abs),
    )
    obj = jnp.sum((0.5 * Qx + q) * x, axis=1) + c
    return viol, pri_norm, dua_norm, obj


@functools.partial(
    jax.jit,
    static_argnames=("eps_abs", "eps_rel", "act_tol", "delta_hat",
                     "refine_iters", "seed_guard", "second_round_k",
                     "residual32", "accept_viol"),
)
@full_matmul_precision
def polish_batch_device(
    data: QPData,
    x32: jnp.ndarray,
    y32: jnp.ndarray,
    eps_abs: float = 1e-6,
    eps_rel: float = 1e-6,
    act_tol: float = 1e-4,
    delta_hat: float = 1e-2,
    refine_iters: int = 4,
    seed_guard: bool = True,
    second_round_k: int = 0,
    residual32: bool = False,
    accept_viol: float = 1.0,
) -> DevicePolishResult:
    """Polish a stacked batch on-device (leading batch axis everywhere).

    `data` must be float64 *unscaled* problem data resident on the
    device; `x32`/`y32` the f32 pass solutions.  Runs as one XLA program:
    f32 factor + f64 refinement + f64 check (see module docstring).

    `seed_guard` modes: True runs a full f64 KKT check of the seed and
    keeps the better point per lane (host-polish best-point semantics);
    "norm" falls back to the seed only on refinement divergence (final
    correction >= first), which needs no second check — same certified
    set, one check cheaper; False reports the polished point as-is (a
    degraded lane fails its check and rides the caller's rescue path,
    but hands it the degraded iterate as a warm start — measured to
    slow the rescue finisher ~3x; prefer "norm").

    `second_round_k > 0` adds a second-chance round on the worst-K lanes
    (by KKT violation): active-set re-detection from the round-1 point +
    a fresh factor/refine/check on the gathered K-lane sub-batch — the
    device analogue of the host polish's rounds=2, at K/B of the cost.
    """
    Q = jnp.asarray(data.Q, jnp.float64)
    A = jnp.asarray(data.A, jnp.float64)
    q = jnp.asarray(data.q, jnp.float64)
    bmin, bmax = data.bmin, data.bmax
    c = jnp.asarray(data.c, jnp.float64)
    x0 = jnp.asarray(x32, jnp.float64)
    y0 = jnp.asarray(y32, jnp.float64)
    n = Q.shape[-1]

    res1 = _polish_core(Q, A, q, bmin, bmax, c, x0, y0,
                        eps_abs, eps_rel, act_tol, delta_hat,
                        refine_iters,
                        fallback_to_seed=(seed_guard == "norm"),
                        residual32=residual32)
    x, y, viol, pri, dua, obj = res1

    if seed_guard is True:
        # best-point guard (host-polish semantics): a misdetected active
        # set must never degrade the reported solution below the f32
        # seed.  Costs a second full f64 KKT check of the seed; the
        # cheaper seed_guard="norm" mode reaches the same certified-lane
        # set by falling back on refinement divergence instead (one
        # check total — see _polish_core).
        viol0, pri0, dua0, obj0 = _check(Q, A, q, bmin, bmax, c, x0, y0,
                                         eps_abs, eps_rel)
        better = viol <= viol0
        bb = better[:, None]
        x = jnp.where(bb, x, x0)
        y = jnp.where(bb, y, y0)
        viol = jnp.where(better, viol, viol0)
        pri = jnp.where(better, pri, pri0)
        dua = jnp.where(better, dua, dua0)
        obj = jnp.where(better, obj, obj0)

    if second_round_k:
        # second-chance rounds on the worst-K lanes only: re-detect the
        # active set from the polished point and re-solve — the device
        # twin of the host retry (polish_batch_np rounds>1), but gathered
        # to a fixed-size sub-batch so it costs ~K/B of a full round
        # (K=64 covers the ~2-3% observed stage-1 failures with margin).
        # These lanes are hard BECAUSE the delta_hat=1e-2 f32 factor
        # cannot contract on them (near-degenerate active sets), so the
        # retry runs a more robust configuration: delta_hat=0.1 lowers
        # cond(P) 10x in exchange for a slower ~0.1/sweep contraction,
        # which 10 sweeps more than recover; two detection rounds match
        # the host retry's active-set iteration.
        k2 = min(int(second_round_k), x.shape[0])
        _, idx = jax.lax.top_k(viol, k2)
        g = lambda a: jnp.take(a, idx, axis=0)  # noqa: E731
        dh2 = max(delta_hat, 1e-1)
        x2, y2 = g(x), g(y)
        for _ in range(2):
            x2, y2, viol2, pri2, dua2, obj2 = _polish_core(
                g(Q), g(A), g(q), g(bmin), g(bmax), g(c), x2, y2,
                eps_abs, eps_rel, act_tol, dh2, 10,
                fallback_to_seed=bool(seed_guard),
                residual32=residual32,
            )
        imp = viol2 < jnp.take(viol, idx)
        upd = lambda a, a2: a.at[idx].set(  # noqa: E731
            jnp.where(imp[:, None] if a.ndim == 2 else imp, a2,
                      jnp.take(a, idx, axis=0))
        )
        x = upd(x, x2)
        y = upd(y, y2)
        viol = upd(viol, viol2)
        pri = upd(pri, pri2)
        dua = upd(dua, dua2)
        obj = upd(obj, obj2)

    return DevicePolishResult(
        x=x, y=y, ok=viol <= accept_viol, pri_res=pri, dua_res=dua,
        objective=obj,
    )


def _polish_core(Q, A, q, bmin, bmax, c, x0, y0, eps_abs, eps_rel,
                 act_tol, delta_hat, refine_iters,
                 fallback_to_seed=False, residual32=False):
    """One detect -> f32 factor -> refinement -> check round.

    `fallback_to_seed=True` replaces diverged lanes (final refinement
    correction >= first — the f32 factor failed to contract) with the
    (x0, y0) seed BEFORE the check, so the single check both gates
    certification and leaves rescue paths a sane warm start.

    `residual32=True` evaluates the refinement residuals AND the KKT
    check with f32 matmuls at precision 'highest' (a reduced-precision
    product — bf16 or TF32 passes — floors the residual above the
    thresholds) instead of f64.  The iterates stay f64.
    Numerics: a residual is a catastrophic cancellation, so its f32
    evaluation error is ~u32 * ||terms|| ~ 6e-7 absolute regardless of
    iterate precision — that is simultaneously (a) the refinement's
    convergence floor and (b) the check's measurement error.  Both sit
    10-30x under the 1e-6-protocol thresholds (eps_dua ~ 1e-5 at the
    bench scale), so callers must gate acceptance with a MARGIN
    (polish_batch_device.accept_viol < 1) and treat margin-zone lanes as
    failures; an exact (host or f64) referee should confirm certified
    lanes when the claim matters."""
    if residual32:
        # f32 slack evaluation: error ~6e-7 against act_tol = 1e-4
        act_lo, act_hi = _detect(A.astype(jnp.float32), bmin, bmax,
                                 x0.astype(jnp.float32), y0,
                                 act_tol, eps_abs)
    else:
        act_lo, act_hi = _detect(A, bmin, bmax, x0, y0, act_tol, eps_abs)
    act = act_lo | act_hi
    w = act.astype(jnp.float64)
    Aw = A * w[:, :, None]
    b_side = jnp.where(act_lo, bmin, bmax)
    rhs_x = -q
    rhs_nu = jnp.where(act, b_side, 0.0)

    # f32 preconditioner factor: P = Q + Aw'Aw/delta_hat (SPD; block
    # elimination of M's dual rows — see module docstring).  The assembly
    # runs at full f32 precision (the caller's 'highest'): with
    # ||A'A||/delta_hat ~ 1e4, a reduced-precision product (bf16 or TF32
    # passes) has an absolute error that swamps lambda_min(Q), and the
    # refinement then diverges.
    Aw32 = Aw.astype(jnp.float32)
    P32 = Q.astype(jnp.float32) + (
        jnp.einsum("bmi,bmj->bij", Aw32, Aw32) / jnp.float32(delta_hat)
    )
    L32 = jnp.linalg.cholesky(P32)
    # explicit preconditioner inverse: pay the batched triangular solves
    # ONCE for n right-hand sides (one GEMM-shaped trsm pair) and turn
    # every refinement sweep's apply into a batched matmul.  P^-1 is less
    # stable than solving from the factor, but M is only a
    # preconditioner — the residuals keep the refinement honest.
    n_dim = P32.shape[-1]
    eye_b = jnp.broadcast_to(jnp.eye(n_dim, dtype=jnp.float32),
                             P32.shape)
    Pinv32 = jax.scipy.linalg.cho_solve((L32, True), eye_b)

    wf = w.astype(jnp.float32)

    def solve_M(r_x64, r_nu64):
        """Apply M^-1 in f32, return f64 corrections."""
        r_x = r_x64.astype(jnp.float32)
        r_nu = r_nu64.astype(jnp.float32)
        t = r_x + jnp.einsum("bmi,bm->bi", Aw32, r_nu) / jnp.float32(
            delta_hat
        )
        dx = jnp.einsum("bij,bj->bi", Pinv32, t)
        awx = jnp.einsum("bmi,bi->bm", Aw32, dx)
        dnu = wf * (awx - r_nu) / jnp.float32(delta_hat) \
            + (1.0 - wf) * r_nu
        return dx.astype(jnp.float64), dnu.astype(jnp.float64)

    if residual32:
        Q32 = Q.astype(jnp.float32)
        q32 = q.astype(jnp.float32)
        rhs_nu32 = rhs_nu.astype(jnp.float32)
        actf = wf

        def refine(i, z):
            x, nu, first_n, last_n = z
            x32 = x.astype(jnp.float32)
            nu32 = nu.astype(jnp.float32)
            with jax.default_matmul_precision("highest"):
                r_x = -q32 - (jnp.einsum("bij,bj->bi", Q32, x32)
                              + jnp.einsum("bmi,bm->bi", Aw32, nu32))
                Kx_nu = jnp.einsum("bmi,bi->bm", Aw32, x32) \
                    + actf * jnp.float32(-_DELTA_REG) * nu32 \
                    + (1.0 - actf) * nu32
            r_nu = rhs_nu32 - Kx_nu
            dx, dnu = solve_M(r_x, r_nu)
            dn = jnp.max(jnp.abs(dx), axis=1)
            first_n = jnp.where(i == 0, dn, first_n)
            return (x + dx, nu + dnu, first_n, dn)
    else:
        def refine(i, z):
            x, nu, first_n, last_n = z
            # residual of the TRUE system (delta = 1e-9) in f64
            r_x = rhs_x - (jnp.einsum("bij,bj->bi", Q, x)
                           + jnp.einsum("bmi,bm->bi", Aw, nu))
            Kx_nu = jnp.einsum("bmi,bi->bm", Aw, x) \
                + jnp.where(act, -_DELTA_REG * nu, nu)
            r_nu = rhs_nu - Kx_nu
            dx, dnu = solve_M(r_x, r_nu)
            dn = jnp.max(jnp.abs(dx), axis=1)
            first_n = jnp.where(i == 0, dn, first_n)
            return (x + dx, nu + dnu, first_n, dn)

    zeros_b = jnp.zeros(x0.shape[0], jnp.float64)
    x, nu, first_n, last_n = jax.lax.fori_loop(
        0, refine_iters, refine, (x0, y0, zeros_b, zeros_b)
    )
    y = jnp.where(act, nu, 0.0)
    if fallback_to_seed:
        # divergence flag: the refinement contraction failed when the
        # final correction is no smaller than the first (cond(P) beyond
        # f32, or a pathological active set) — fall back to the seed
        # there; such a lane then fails the check and rides the caller's
        # retry/rescue path with an intact warm start
        diverged = ~(last_n < first_n) | ~jnp.isfinite(last_n)
        db = diverged[:, None]
        x = jnp.where(db, x0, x)
        y = jnp.where(db, y0, y)
    if residual32:
        with jax.default_matmul_precision("highest"):
            viol, pri, dua, obj = _check(
                Q.astype(jnp.float32), A.astype(jnp.float32),
                q.astype(jnp.float32),
                bmin.astype(jnp.float32), bmax.astype(jnp.float32),
                c, x.astype(jnp.float32), y.astype(jnp.float32),
                eps_abs, eps_rel,
            )
    else:
        viol, pri, dua, obj = _check(Q, A, q, bmin, bmax, c, x, y,
                                     eps_abs, eps_rel)
    return x, y, viol, pri, dua, obj
