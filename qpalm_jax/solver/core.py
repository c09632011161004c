"""The QPALM solve loop: proximal augmented Lagrangian with semismooth Newton
inner iterations, as one jittable/vmappable `lax.while_loop`.

This re-implements the fused outer/inner iteration state machine of the
reference `qpalm_solve` (reference: src/qpalm.c:401-736) plus the per-iteration
math of src/iteration.c, src/newton.c and src/termination.c.  Mapping:

  * the ~60 mutable workspace arrays -> one `SolverState` pytree
  * early `return`s                  -> a `done` flag + status code
  * the 4-way branch per iteration   -> `lax.switch` on a branch index
  * sparse LDL' rank-1 surgery       -> masked dense Schur refactorization
                                        (see qpalm_jax.linalg.dense)

Everything in this file is pure: (state, data, scaling, settings) -> state.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import constants as C
from ..linalg.dense import (
    cho_solve,
    gershgorin_max,
    newton_solve_kkt,
    norm_inf,
    vec_mid,
)
from ..precision import full_matmul_precision
from ..scaling import identity_scaling, scale_data
from ..types import QPData, ScalingInfo, Settings, SolverState
from .linesearch import exact_linesearch


# ---------------------------------------------------------------------------
# state construction / warm start
# ---------------------------------------------------------------------------

@full_matmul_precision
def init_state(
    data: QPData,
    scal: ScalingInfo,
    settings: Settings,
    x_ws=None,
    y_ws=None,
    gamma_init=None,
    gamma_max=None,
) -> SolverState:
    """Build the initial solver state (qpalm_warm_start semantics,
    reference: src/qpalm.c:322-399, and solve-entry resets qpalm.c:410-416).

    `x_ws`/`y_ws` are *unscaled* user warm starts or None for a cold start.
    `gamma_init`/`gamma_max` are optional *traced* per-problem overrides of the
    corresponding settings — how nonconvex gamma pinning (reference:
    nonconvex.c:171-183) stays batchable under vmap without a retrace.
    """
    n, m = data.n, data.m
    dtype = data.Q.dtype
    f0 = lambda k: jnp.zeros((k,), dtype)
    if gamma_init is None:
        gamma_init = settings.gamma_init
    if gamma_max is None:
        gamma_max = settings.gamma_max
    gamma = jnp.asarray(gamma_init, dtype)

    if x_ws is not None:
        x = jnp.asarray(x_ws, dtype) * scal.Dinv
        Qx_pure = data.Q @ x
        Qx = Qx_pure + x / gamma if settings.proximal else Qx_pure
        Ax = data.A @ x
    else:
        x = f0(n)
        Qx = f0(n)
        Ax = f0(m)

    if y_ws is not None:
        y = jnp.asarray(y_ws, dtype) * scal.Einv * scal.c
    else:
        y = f0(m)

    # initialize_sigma (reference: src/iteration.c:50-84); NB the objective f
    # uses the workspace Qx, which includes the x/gamma proximal term — kept
    # for bit-parity with the reference.
    f = 0.5 * jnp.vdot(x, Qx) + jnp.vdot(data.q, x)
    dist = Ax - vec_mid(Ax, data.bmin, data.bmax)
    dist2 = jnp.vdot(dist, dist)
    sig0 = jnp.clip(
        settings.sigma_init * jnp.maximum(1.0, jnp.abs(f))
        / jnp.maximum(1.0, 0.5 * dist2),
        1e-4,
        1e4,
    ).astype(dtype)
    sigma = jnp.full((m,), 1.0, dtype) * sig0

    fbool = jnp.zeros((), bool)
    i0 = jnp.zeros((), jnp.int32)
    s0 = jnp.zeros((), dtype)

    return SolverState(
        x=x,
        y=y,
        x0=x,
        x_prev=x,
        Qx=Qx,
        Ax=Ax,
        Aty=f0(n),
        Axys=f0(m),
        z=f0(m),
        pri_res=f0(m),
        pri_res_in=f0(m),
        yh=f0(m),
        Atyh=f0(n),
        df=f0(n),
        dphi=f0(n),
        dphi_prev=f0(n),
        d=f0(n),
        Qd=f0(n),
        Ad=f0(m),
        tau=s0,
        active=jnp.zeros((m,), bool),
        active_old=jnp.zeros((m,), bool),
        nb_enter=i0,
        nb_leave=i0,
        # CG/STAGE modes never cache a dense factor: a dummy 1x1 keeps
        # SolverState O(n) (large sparse problems must not allocate n x n)
        L=jnp.zeros(
            (1, 1) if settings.factorization_method
            in (C.FACTORIZE_CG, C.FACTORIZE_STAGE)
            else (n, n),
            dtype,
        ),
        factor_valid=fbool,
        gersh=s0,
        sigma=sigma,
        sigma_inv=1.0 / sigma,
        sqrt_sigma=jnp.sqrt(sigma),
        gamma=gamma,
        gamma_maxed=jnp.asarray(settings.nonconvex, bool),
        gamma_max=jnp.asarray(gamma_max, dtype),
        eps_abs_in=jnp.asarray(settings.eps_abs_in, dtype),
        eps_rel_in=jnp.asarray(settings.eps_rel_in, dtype),
        eps_k_abs=jnp.asarray(settings.eps_abs_in, dtype),
        eps_k_rel=jnp.asarray(settings.eps_rel_in, dtype),
        pri_res_norm=s0,
        dua_res_norm=s0,
        dua2_res_norm=s0,
        eps_pri=s0,
        eps_dua=s0,
        eps_dua_in=s0,
        delta_y=f0(m),
        delta_x=f0(n),
        iter=i0,
        iter_out=i0,
        prev_iter=i0,
        no_change=i0,
        done=fbool,
        status=jnp.asarray(C.QPALM_UNSOLVED, jnp.int32),
        dual_objective=s0,
    )


# ---------------------------------------------------------------------------
# per-iteration math (reference: src/iteration.c)
# ---------------------------------------------------------------------------

def compute_residuals(st: SolverState, data: QPData, settings: Settings) -> SolverState:
    """reference: src/iteration.c:24-48.

    With `residuals_fp64` (the float32 speed mode) every quantity here is
    evaluated in float64 from fresh matvecs and *stored* back in float32:
    storage precision is relative (harmless), while f32 *computation* of
    dphi = Qx + q + A'yh loses absolute accuracy ~eps_f32*||Qx|| to
    cancellation, which floors the dual residual around 1e-4 and strands
    lanes at max_iter.  The O(n^2) f64 matvecs are noise next to
    the O(n^2 m) f32 Schur assembly.
    """
    dtype = st.x.dtype
    hp = settings.residuals_fp64 and dtype == jnp.float32
    ct = jnp.float64 if hp else dtype
    if hp:
        x = st.x.astype(ct)
        Qx = data.Q.astype(ct) @ x
        if settings.proximal:
            Qx = Qx + x / st.gamma.astype(ct)
        Ax = data.A.astype(ct) @ x
        st = st._replace(Qx=Qx.astype(dtype), Ax=Ax.astype(dtype))
    else:
        Qx, Ax = st.Qx, st.Ax
    y = st.y.astype(ct)
    Axys = Ax + y * st.sigma_inv.astype(ct)
    z = vec_mid(Axys, data.bmin.astype(ct), data.bmax.astype(ct))
    pri_res = Ax - z
    yh = y + pri_res * st.sigma.astype(ct)
    df = Qx + data.q.astype(ct)  # NB Qx holds Qx + x/gamma when proximal
    if settings.proximal:
        df = df - st.x0.astype(ct) / st.gamma.astype(ct)
    Atyh = data.A.astype(ct).T @ yh
    dphi = df + Atyh
    return st._replace(
        Axys=Axys.astype(dtype),
        z=z.astype(dtype),
        pri_res=pri_res.astype(dtype),
        yh=yh.astype(dtype),
        df=df.astype(dtype),
        Atyh=Atyh.astype(dtype),
        dphi=dphi.astype(dtype),
    )


def update_sigma(st: SolverState, settings: Settings, enabled) -> SolverState:
    """Per-constraint penalty boosts (reference: src/iteration.c:86-145).

    Any sigma change invalidates the cached Schur factor — the dense analogue
    of the reference's reset_newton / ldlupdate_sigma_changed dichotomy.
    """
    dtype = st.sigma.dtype
    pri_norm = norm_inf(st.pri_res)
    cond = (
        enabled
        & (jnp.abs(st.pri_res) > settings.theta * jnp.abs(st.pri_res_in))
        & st.active
    )
    mult = jnp.maximum(
        1.0, settings.delta * jnp.abs(st.pri_res) / (pri_norm + 1e-6)
    ).astype(dtype)
    sig_tmp = jnp.minimum(mult * st.sigma, settings.sigma_max)
    new_sigma = jnp.where(cond, sig_tmp, st.sigma)
    changed = jnp.sum((new_sigma != st.sigma).astype(jnp.int32), dtype=jnp.int32)
    return st._replace(
        sigma=new_sigma,
        sigma_inv=1.0 / new_sigma,
        sqrt_sigma=jnp.sqrt(new_sigma),
        factor_valid=st.factor_valid & (changed == 0),
    )


def _apply_gamma_change(st: SolverState, new_gamma) -> SolverState:
    """Qx/Qd fixups when gamma changes (reference: iteration.c:153,206-210)."""
    changed = new_gamma != st.gamma
    diff = 1.0 / new_gamma - 1.0 / st.gamma
    Qx = jnp.where(changed, st.Qx + diff * st.x, st.Qx)
    Qd = jnp.where(changed, st.Qd + st.tau * diff * st.d, st.Qd)
    return st._replace(
        gamma=new_gamma, Qx=Qx, Qd=Qd, factor_valid=st.factor_valid & ~changed
    )


def update_gamma(st: SolverState, settings: Settings) -> SolverState:
    """reference: src/iteration.c:147-156.

    Like the reference, this step fixes up Qx but not Qd.  (The boost path
    goes through `_apply_gamma_change`, which also fixes Qd — required for
    the dual-infeasibility curvature test `Qd - (tau/gamma) d` to stay exact
    under the new gamma; the reference's plain update_gamma tolerates the
    same small inexactness this one does, iteration.c:147-156 vs 206-210.)
    """
    upd = st.gamma < st.gamma_max
    new_gamma = jnp.where(
        upd, jnp.minimum(st.gamma * settings.gamma_upd, st.gamma_max), st.gamma
    )
    diff = 1.0 / new_gamma - 1.0 / st.gamma
    Qx = jnp.where(upd, st.Qx + diff * st.x, st.Qx)
    return st._replace(
        gamma=new_gamma, Qx=Qx, factor_valid=st.factor_valid & ~upd
    )


def _boost_gamma_values(st: SolverState, data: QPData, settings: Settings, active2):
    """gamma after boost (reference: src/iteration.c:158-205, Schur path).

    On the Schur path the Gershgorin bound of A' diag(sigma*active) A is read
    from the scalar cached at the last factorization (st.gersh) instead of
    re-assembling the product: when the boost actually fires the active set
    has settled (nb_enter = nb_leave = 0), so the cached mask equals active2
    and the bound is exact; sigma cannot have changed this outer update
    because the boost requires pri_res < eps_pri while sigma updates require
    the opposite.
    """
    dtype = st.sigma.dtype
    nb_active = jnp.sum(active2.astype(jnp.int32))
    if settings.factorization_method == C.FACTORIZE_KKT:
        # the reference's KKT boost is a flat 1e10 (its Gershgorin estimate
        # is disabled there, iteration.c:174-182)
        boosted = jnp.asarray(1e10, dtype)
    else:
        boosted = jnp.maximum(
            st.gamma_max.astype(dtype), 1e14 / jnp.maximum(st.gersh, 1e-30)
        )
    return jnp.where(nb_active > 0, boosted, jnp.asarray(1e12, dtype))


@full_matmul_precision
def compute_objective(st: SolverState, data: QPData, scal: ScalingInfo,
                      settings: Settings):
    """reference: src/iteration.c:231-270."""
    Qx_pure = st.Qx - st.x / st.gamma if settings.proximal else st.Qx
    obj = jnp.vdot(0.5 * Qx_pure + data.q, st.x)
    if settings.scaling:
        obj = obj * scal.cinv
    return obj + data.c


def compute_dual_objective(st: SolverState, data: QPData, scal: ScalingInfo,
                           settings: Settings, LQ):
    """reference: src/iteration.c:272-299 (assumes Q positive definite)."""
    g = st.Aty + data.q
    v = cho_solve(LQ, g)
    dual_obj = -0.5 * jnp.vdot(g, v)
    contrib = jnp.where(st.y > 0, st.y * data.bmax, st.y * data.bmin)
    dual_obj = dual_obj - jnp.sum(contrib)
    if settings.scaling:
        dual_obj = dual_obj * scal.cinv
    return dual_obj + data.c


# ---------------------------------------------------------------------------
# termination (reference: src/termination.c)
# ---------------------------------------------------------------------------

def calculate_residuals_and_tolerances(
    st: SolverState, data: QPData, scal: ScalingInfo, settings: Settings
) -> SolverState:
    """reference: src/termination.c:44-129.  With scaling off, scal is the
    identity and the scaled formulas reduce to the unscaled ones."""
    pri_res_norm = norm_inf(scal.Einv * st.pri_res)

    if settings.proximal:
        xx0 = st.x - st.x0
        dua_res_norm = norm_inf(scal.Dinv * (st.dphi - xx0 / st.gamma))
        dua2_res_norm = norm_inf(scal.Dinv * st.dphi)
    else:
        dua_res_norm = norm_inf(scal.Dinv * st.dphi)
        dua2_res_norm = dua_res_norm
    dua_res_norm = dua_res_norm * scal.cinv
    dua2_res_norm = dua2_res_norm * scal.cinv

    eps_pri = settings.eps_abs + settings.eps_rel * jnp.maximum(
        norm_inf(scal.Einv * st.Ax), norm_inf(scal.Einv * st.z)
    )

    max_norm = jnp.maximum(
        norm_inf(scal.Dinv * st.Qx),
        jnp.maximum(norm_inf(scal.Dinv * data.q), norm_inf(scal.Dinv * st.Atyh)),
    ) * scal.cinv
    eps_dua = settings.eps_abs + settings.eps_rel * max_norm
    eps_dua_in = st.eps_abs_in + st.eps_rel_in * max_norm

    return st._replace(
        pri_res_norm=pri_res_norm,
        dua_res_norm=dua_res_norm,
        dua2_res_norm=dua2_res_norm,
        eps_pri=eps_pri,
        eps_dua=eps_dua,
        eps_dua_in=eps_dua_in,
    )


def is_primal_infeasible(st: SolverState, data: QPData, scal: ScalingInfo,
                         settings: Settings):
    """reference: src/termination.c:136-182.  Returns (flag, unscaled delta_y
    certificate)."""
    delta_y = st.yh - st.y
    eps_norm = settings.eps_prim_inf * norm_inf(scal.E * delta_y)
    At_dy = scal.Dinv * (st.Atyh - st.Aty)

    has_ub = data.bmax < scal.E * C.QPALM_INFTY
    has_lb = data.bmin > -scal.E * C.QPALM_INFTY
    out_of_bounds = jnp.sum(
        jnp.where(has_ub, data.bmax * jnp.maximum(delta_y, 0.0), 0.0)
        + jnp.where(has_lb, data.bmin * jnp.minimum(delta_y, 0.0), 0.0)
    )
    flag = (
        (eps_norm > 0)
        & (norm_inf(At_dy) <= eps_norm)
        & (out_of_bounds <= -eps_norm)
    )
    cert = scal.E * (scal.cinv * delta_y)
    return flag, cert


def is_dual_infeasible(st: SolverState, data: QPData, scal: ScalingInfo,
                       settings: Settings):
    """reference: src/termination.c:184-240.  Returns (flag, unscaled delta_x
    certificate).  NB st.Qd/st.Ad hold tau*Qd / tau*Ad of the last inner step."""
    delta_x = st.x - st.x_prev
    Ddx = scal.D * delta_x
    eps_norm = settings.eps_dual_inf * norm_inf(Ddx)
    dxdx = jnp.vdot(Ddx, Ddx)

    A_dx = scal.Einv * st.Ad
    has_ub = data.bmax < scal.E * C.QPALM_INFTY
    has_lb = data.bmin > -scal.E * C.QPALM_INFTY
    bound_violation = jnp.any(
        (has_ub & (A_dx >= eps_norm)) | (has_lb & (A_dx <= -eps_norm))
    )

    if settings.proximal:
        Qdx = st.Qd - (st.tau / st.gamma) * st.d
    else:
        Qdx = st.Qd
    dxQdx = jnp.vdot(delta_x, Qdx)
    e2 = settings.eps_dual_inf * settings.eps_dual_inf
    cs = scal.c if settings.scaling else jnp.ones((), st.x.dtype)
    curvature_ok = (dxQdx <= -cs * e2 * dxdx) | (
        (dxQdx <= cs * e2 * dxdx)
        & (jnp.vdot(data.q, delta_x) <= -cs * eps_norm)
    )
    flag = (eps_norm > 0) & ~bound_violation & curvature_ok
    cert = scal.D * delta_x
    return flag, cert


# ---------------------------------------------------------------------------
# newton + primal update (reference: src/newton.c, iteration.c:213-229)
# ---------------------------------------------------------------------------

def _newton_and_linesearch(st: SolverState, data: QPData, settings: Settings
                           ) -> SolverState:
    """update_primal_iterate (reference: src/iteration.c:213-229)."""
    dtype = st.x.dtype
    active = (st.Axys <= data.bmin) | (st.Axys >= data.bmax)
    nb_enter = jnp.sum((active & ~st.active_old).astype(jnp.int32), dtype=jnp.int32)
    nb_leave = jnp.sum((~active & st.active_old).astype(jnp.int32), dtype=jnp.int32)
    reuse = st.factor_valid & (nb_enter == 0) & (nb_leave == 0)
    neg_dphi = -st.dphi

    method = settings.factorization_method
    gersh = st.gersh
    if method == C.FACTORIZE_CG:
        # matrix-free Newton: Jacobi-preconditioned CG on the Schur operator
        # (the large-sparse path; works for dense and BCOO data alike)
        from ..linalg.cg import pcg
        from ..linalg.sparse import ata_diag, ata_gershgorin_upper, is_sparse, sym_diag

        sparse = is_sparse(data.A)
        sig_act = jnp.where(active, st.sigma, jnp.zeros_like(st.sigma))
        gamma_inv = (
            1.0 / st.gamma if settings.proximal else jnp.zeros((), dtype)
        )

        def matvec(v):
            Av = data.A @ v
            r = data.Q @ v + data.A.T @ (sig_act * Av)
            if settings.proximal:
                r = r + v * gamma_inv
            return r

        if sparse:
            diagM = sym_diag(data.Q) + gamma_inv + ata_diag(data.A, sig_act)
            gersh = ata_gershgorin_upper(data.A, sig_act)
        else:
            diagM = (
                jnp.diagonal(data.Q) + gamma_inv
                + jnp.einsum("mn,m->n", data.A * data.A, sig_act)
            )
            # matrix-free |A|' diag(sig) |A| 1 row-sum bound: assembling
            # the dense n x n product every inner iteration just for this
            # scalar defeats the CG mode's whole point (the bound is only
            # consumed by the rare gamma boost, and a conservative bound
            # only picks a smaller boosted gamma — same rationale as the
            # sparse path's ata_gershgorin_upper)
            absA = jnp.abs(data.A)
            gersh = jnp.max(
                absA.T @ (sig_act * (absA @ jnp.ones((data.n,), dtype)))
            )
        if settings.cg_precond == "block_jacobi":
            # factored block diagonals of M: bounds CG iteration growth on
            # ill-conditioned problems (VERDICT r1 item 4 — the middle
            # ground between diag(M) and the reference's full sparse LDL',
            # solver_interface.c:319-405)
            from ..linalg.sparse import block_diagonals, block_jacobi_apply

            blocks = block_diagonals(
                data.Q, data.A, sig_act, gamma_inv, settings.cg_block
            )
            chol_blocks = jnp.linalg.cholesky(blocks)
            precond = lambda r: block_jacobi_apply(chol_blocks, r)
        else:
            precond = diagM
        # inexact-Newton forcing: early outer iterations only need the
        # direction to the accuracy of the current inner tolerance, so the
        # CG tolerance loosens to (a fraction of) eps_dua_in relative to
        # ||dphi|| and tightens to cg_tol near convergence
        dphi_norm = jnp.sqrt(jnp.vdot(neg_dphi, neg_dphi))
        forcing = jnp.clip(
            0.01 * st.eps_dua_in / jnp.maximum(dphi_norm, 1e-30),
            settings.cg_tol,
            1e-2,
        ).astype(dtype)
        d, _, _ = pcg(
            matvec, neg_dphi, precond,
            tol=forcing,
            max_iter=settings.cg_max_iter,
        )
        L = st.L
    elif method == C.FACTORIZE_STAGE:
        # stage-structured Newton: the Schur matrix of a stage-ordered MPC
        # QP is block-tridiagonal (dynamics couple adjacent stages, box rows
        # are diagonal) — solve with block Thomas in O(S * nb^3) instead of
        # a dense O(n^3) Cholesky.  Distributed stage partitioning of the
        # same system: parallel.block_tridiag.spike_solve.
        from ..parallel.block_tridiag import extract_block_tridiag, thomas_solve

        nb = settings.stage_block
        gamma_inv = (
            1.0 / st.gamma if settings.proximal else jnp.zeros((), dtype)
        )
        w = jnp.where(active, st.sqrt_sigma, jnp.zeros_like(st.sqrt_sigma))
        B = data.A * w[:, None]
        AtsA = jnp.dot(B.T, B, preferred_element_type=dtype)
        gersh = gershgorin_max(AtsA)
        M = data.Q + AtsA
        if settings.proximal:
            M = M + gamma_inv * jnp.eye(data.n, dtype=dtype)
        Db, Eb = extract_block_tridiag(M, nb)
        S = data.n // nb
        d = thomas_solve(Db, Eb[:-1], neg_dphi.reshape(S, nb)).reshape(-1)
        L = st.L
    elif method == C.FACTORIZE_KKT:
        d = newton_solve_kkt(
            data.Q, data.A, st.sigma, active, st.gamma, neg_dphi,
            settings.proximal,
        )
        L = st.L
    else:
        # Schur path: refactor only when the active set / penalties changed;
        # under vmap the cond lowers to a select (both branches run), which is
        # exactly the dense-batched regime the design targets.
        gamma_inv = (
            1.0 / st.gamma if settings.proximal else jnp.zeros((), dtype)
        )

        def refactor(_):
            w = jnp.where(active, st.sqrt_sigma, jnp.zeros_like(st.sqrt_sigma))
            B = data.A * w[:, None]
            AtsA = jnp.dot(B.T, B, preferred_element_type=dtype)
            g = gershgorin_max(AtsA)
            M = data.Q + AtsA
            if settings.proximal:
                M = M + gamma_inv * jnp.eye(data.n, dtype=dtype)
            return jnp.linalg.cholesky(M), g

        L, gersh = jax.lax.cond(
            reuse, lambda _: (st.L, st.gersh), refactor, None
        )
        d = cho_solve(L, neg_dphi)
        if settings.max_refine > 0:
            # matvec-based iterative refinement (reference newton.c:57-90).
            # With refine_fp64 the residual b - M d is evaluated in float64
            # while the factor stays float32 — classical mixed-precision IR:
            # the O(n^3)/O(n^2 m) work runs in f32 and the O(n^2)
            # residual recovers the accuracy the f32 solve loses on
            # ill-conditioned M (gamma ~ 1e7 makes cond(M) exceed 1/eps_f32).
            rdt = (
                jnp.float64
                if (settings.refine_fp64 and dtype != jnp.float64)
                else dtype
            )
            Qr = data.Q.astype(rdt)
            Ar = data.A.astype(rdt)
            sig_r = st.sigma.astype(rdt)

            def matvec(v):
                w = jnp.where(active, sig_r, jnp.zeros_like(sig_r))
                Av = Ar @ v
                r = Qr @ v + Ar.T @ (w * Av)
                if settings.proximal:
                    r = r + v / st.gamma.astype(rdt)
                return r

            b_r = neg_dphi.astype(rdt)

            def ref_body(i, dd):
                r = b_r - matvec(dd)
                return dd + cho_solve(L, r.astype(dtype)).astype(rdt)

            res0 = norm_inf(b_r - matvec(d.astype(rdt)))
            ref_norm = jnp.maximum(norm_inf(b_r), 1.0)
            need = res0 > jnp.maximum(
                C.RELATIVE_REFINEMENT_TOLERANCE * ref_norm,
                C.ABSOLUTE_REFINEMENT_TOLERANCE,
            )
            d = jax.lax.cond(
                need,
                lambda dd: jax.lax.fori_loop(
                    0, settings.max_refine, ref_body, dd
                ).astype(dtype),
                lambda dd: dd.astype(dtype),
                d.astype(rdt),
            )

    st = st._replace(
        d=d,
        L=L,
        gersh=gersh,
        active=active,
        active_old=active,
        nb_enter=nb_enter,
        nb_leave=nb_leave,
        factor_valid=jnp.ones((), bool),
    )

    # exact linesearch (reference: src/linesearch.c:14-120)
    Qd = data.Q @ d
    if settings.proximal:
        Qd = Qd + d / st.gamma
    Ad = data.A @ d
    ls_mode = settings.linesearch
    if ls_mode == "auto":
        # bisect for f32 (sort-free, exact at f32 precision), sort for f64
        # reference parity
        ls_mode = "bisect" if dtype == jnp.float32 else "sort"
    tau = exact_linesearch(
        d, Qd, Ad, st.df, st.Ax, st.y, st.sigma, st.sqrt_sigma,
        data.bmin, data.bmax, mode=ls_mode,
    )

    Qd_t = tau * Qd
    Ad_t = tau * Ad
    return st._replace(
        x_prev=st.x,
        dphi_prev=st.dphi,
        x=st.x + tau * d,
        tau=tau,
        Qd=Qd_t,
        Ad=Ad_t,
        Qx=st.Qx + Qd_t,
        Ax=st.Ax + Ad_t,
    )


# ---------------------------------------------------------------------------
# the fused outer/inner loop (reference: src/qpalm.c:484-711)
# ---------------------------------------------------------------------------

def make_iteration(data: QPData, scal: ScalingInfo, settings: Settings, LQ=None):
    """Build the loop body. Returns fn(state) -> state performing exactly one
    reference iteration (one trip through the for-loop at qpalm.c:484)."""

    def outer_update(st: SolverState) -> SolverState:
        """Subproblem converged / stalled: dual + penalty updates
        (reference: qpalm.c:515-644)."""
        st = st._replace(no_change=jnp.zeros((), jnp.int32))
        do_sigma = (st.iter_out > 0) & (st.pri_res_norm > st.eps_pri)
        st = update_sigma(st, settings, do_sigma)
        st = st._replace(y=st.yh, Aty=st.Atyh)

        if settings.enable_dual_termination:
            dual_obj = compute_dual_objective(st, data, scal, settings, LQ)
            # NaN-guard: a PSD-singular Q NaNs the Q-Cholesky solve; the
            # check must then deterministically not fire (the solver falls
            # through to normal termination) rather than rely on NaN
            # comparison semantics
            terminated = (
                jnp.isfinite(dual_obj)
                & (dual_obj > settings.dual_objective_limit)
            )
            st = st._replace(
                dual_objective=dual_obj,
                done=st.done | terminated,
                status=jnp.where(
                    terminated,
                    jnp.asarray(C.QPALM_DUAL_TERMINATED, jnp.int32),
                    st.status,
                ),
            )

        st = st._replace(
            eps_abs_in=jnp.maximum(settings.eps_abs, settings.rho * st.eps_abs_in),
            eps_rel_in=jnp.maximum(settings.eps_rel, settings.rho * st.eps_rel_in),
        )

        if settings.nonconvex:
            # move the proximal center only when pri_res has caught up
            # (reference: qpalm.c:586-609)
            eps_k = st.eps_k_abs + st.eps_k_rel * jnp.maximum(
                norm_inf(scal.Einv * st.Ax), norm_inf(scal.Einv * st.z)
            )
            move = st.pri_res_norm < eps_k
            st = st._replace(
                x0=jnp.where(move, st.x, st.x0),
                eps_k_abs=jnp.where(
                    move,
                    jnp.maximum(settings.eps_abs, settings.rho * st.eps_k_abs),
                    st.eps_k_abs,
                ),
                eps_k_rel=jnp.where(
                    move,
                    jnp.maximum(settings.eps_rel, settings.rho * st.eps_k_rel),
                    st.eps_k_rel,
                ),
            )
        elif settings.proximal:
            # gamma boost when the active set has settled
            # (reference: qpalm.c:612-630)
            check = (
                (~st.gamma_maxed)
                & (st.iter_out > 0)
                & (st.nb_enter == 0)
                & (st.nb_leave == 0)
                & (st.pri_res_norm < st.eps_pri)
            )
            Axys2 = st.Ax + st.y * st.sigma_inv  # y == yh here
            active2 = (Axys2 <= data.bmin) | (Axys2 >= data.bmax)
            nb_enter2 = jnp.sum((active2 & ~st.active_old).astype(jnp.int32), dtype=jnp.int32)
            nb_leave2 = jnp.sum((~active2 & st.active_old).astype(jnp.int32), dtype=jnp.int32)
            boost = check & (nb_enter2 == 0) & (nb_leave2 == 0)

            boosted_gamma = _boost_gamma_values(st, data, settings, active2)
            upd = st.gamma < st.gamma_max
            stepped_gamma = jnp.where(
                upd,
                jnp.minimum(st.gamma * settings.gamma_upd, st.gamma_max),
                st.gamma,
            )
            new_gamma = jnp.where(boost, boosted_gamma, stepped_gamma)
            st = _apply_gamma_change(st, new_gamma)
            # gamma_maxed latches only when constraints were active at the
            # boost (reference iteration.c:195: the empty-active 1e12 case
            # leaves the flag clear so a later boost can still fire)
            nb_active2 = jnp.sum(active2.astype(jnp.int32))
            st = st._replace(
                gamma_maxed=st.gamma_maxed | (boost & (nb_active2 > 0)),
                # the boost check overwrites the solver's active-set diff
                # (reference: qpalm.c:617-618 side effect)
                active=jnp.where(check, active2, st.active),
                nb_enter=jnp.where(check, nb_enter2, st.nb_enter),
                nb_leave=jnp.where(check, nb_leave2, st.nb_leave),
                x0=st.x,
            )

        return st._replace(
            pri_res_in=st.pri_res,
            iter_out=st.iter_out + 1,
            prev_iter=st.iter,
        )

    def inner_exhausted(st: SolverState) -> SolverState:
        """inner_max_iter hit (reference: qpalm.c:647-660)."""
        st = st._replace(no_change=jnp.zeros((), jnp.int32))
        do_sigma = (st.iter_out > 0) & (st.pri_res_norm > st.eps_pri)
        st = update_sigma(st, settings, do_sigma)
        if settings.proximal:
            st = update_gamma(st, settings)
            if not settings.nonconvex:
                st = st._replace(x0=st.x)
        return st._replace(
            pri_res_in=st.pri_res,
            iter_out=st.iter_out + 1,
            prev_iter=st.iter,
        )

    def inner_step(st: SolverState) -> SolverState:
        """One semismooth-Newton inner iteration (reference: qpalm.c:662-678)."""
        st = st._replace(
            no_change=jnp.where(
                st.nb_enter + st.nb_leave > 0,
                jnp.zeros((), jnp.int32),
                st.no_change + 1,
            )
        )
        reset = (st.iter % settings.reset_newton_iter) == 0
        st = st._replace(factor_valid=st.factor_valid & ~reset)
        return _newton_and_linesearch(st, data, settings)

    def iteration(st: SolverState) -> SolverState:
        st = compute_residuals(st, data, settings)
        st = calculate_residuals_and_tolerances(st, data, scal, settings)

        # per-iteration row (reference: util.c:107-119, qpalm.c:670-675),
        # printed through a host callback every print_iter iterations
        if settings.verbose:
            def _row(it, pri, dua, tau):
                print(
                    f"{int(it):6d} | {float(pri):.4e} | {float(dua):.4e} "
                    f"| {float(tau):.4e}"
                )

            jax.lax.cond(
                (st.iter % settings.print_iter) == 0,
                lambda s: jax.debug.callback(
                    _row, s.iter, s.pri_res_norm, s.dua2_res_norm, s.tau
                ),
                lambda s: None,
                st,
            )

        solved = (st.pri_res_norm < st.eps_pri) & (st.dua_res_norm < st.eps_dua)
        pinf, cert_dy = is_primal_infeasible(st, data, scal, settings)
        dinf, cert_dx = is_dual_infeasible(st, data, scal, settings)
        terminate = solved | pinf | dinf

        subproblem_done = st.dua2_res_norm <= st.eps_dua_in
        outer_trigger = subproblem_done | (st.no_change == 3)
        exhausted = st.iter == st.prev_iter + settings.inner_max_iter

        def terminate_fn(st: SolverState) -> SolverState:
            status = jnp.where(
                solved,
                jnp.asarray(C.QPALM_SOLVED, jnp.int32),
                jnp.where(
                    pinf,
                    jnp.asarray(C.QPALM_PRIMAL_INFEASIBLE, jnp.int32),
                    jnp.asarray(C.QPALM_DUAL_INFEASIBLE, jnp.int32),
                ),
            )
            return st._replace(
                done=jnp.ones((), bool),
                status=status,
                delta_y=jnp.where(pinf & ~solved, cert_dy, st.delta_y),
                delta_x=jnp.where(dinf & ~solved & ~pinf, cert_dx, st.delta_x),
            )

        branch = jnp.where(
            terminate,
            0,
            jnp.where(outer_trigger, 1, jnp.where(exhausted, 2, 3)),
        ).astype(jnp.int32)
        st = jax.lax.switch(
            branch, [terminate_fn, outer_update, inner_exhausted, inner_step], st
        )
        # the reference for-loop advances iter except on the terminating trip
        return st._replace(iter=jnp.where(st.done, st.iter, st.iter + 1))

    return iteration


@full_matmul_precision
def solve_from_state(
    st: SolverState,
    data: QPData,
    scal: ScalingInfo,
    settings: Settings,
    max_iter=None,
) -> SolverState:
    """Run the solve loop until termination or max_iter.

    `max_iter` (traceable) lets the host slice the loop into chunks for
    wall-clock time-limit enforcement (reference: qpalm.c:680-708) without
    reading a clock inside jit.
    """
    LQ = None
    if settings.enable_dual_termination:
        LQ = jnp.linalg.cholesky(data.Q)  # assumes Q PD (reference qpalm.c:456-469)
    iteration = make_iteration(data, scal, settings, LQ)
    limit = settings.max_iter if max_iter is None else max_iter

    def cond(st: SolverState):
        return (~st.done) & (st.iter < limit)

    if settings.unroll > 1:
        # K iterations per while_loop trip: amortizes the per-trip dispatch
        # floor.  Each sub-step is guarded on done | iter >= limit so an
        # unsolved lane can never overshoot max_iter (the while cond only
        # checks before a trip, not between unrolled sub-steps).
        base = iteration

        def iteration(st: SolverState):  # noqa: F811
            for _ in range(settings.unroll):
                nxt = base(st)
                stop = st.done | (st.iter >= limit)
                st = jax.tree.map(
                    lambda a, b: jnp.where(stop, a, b), st, nxt
                )
            return st

    final = jax.lax.while_loop(cond, iteration, st)
    # max-iter exit (reference: qpalm.c:712-716)
    hit_max = (~final.done) & (final.iter >= settings.max_iter)
    return final._replace(
        status=jnp.where(
            hit_max, jnp.asarray(C.QPALM_MAX_ITER_REACHED, jnp.int32), final.status
        ),
    )


@full_matmul_precision
def full_solve(
    dataj: QPData,
    x_ws: jnp.ndarray,
    y_ws: jnp.ndarray,
    settings: Settings,
    has_x: bool,
    has_y: bool,
    gamma_init=None,
    gamma_max=None,
):
    """Scale + warm-start-init + full solve as one pure device program
    (qpalm_setup + qpalm_warm_start + qpalm_solve, reference qpalm.c:73,322,401).

    Pure in all array arguments, so it jits (the host API), vmaps (problem
    batches) and shards (see qpalm_jax.parallel) unchanged.  The optional
    traced `gamma_init`/`gamma_max` carry per-problem nonconvex gamma pinning.

    Returns (final_state, x_unscaled, y_unscaled, objective).
    """
    if settings.scaling:
        data, scal = scale_data(dataj, settings.scaling)
    else:
        data, scal = dataj, identity_scaling(dataj.n, dataj.m, dataj.Q.dtype)
    st = init_state(
        data, scal, settings,
        x_ws if has_x else None,
        y_ws if has_y else None,
        gamma_init=gamma_init,
        gamma_max=gamma_max,
    )
    final = solve_from_state(st, data, scal, settings)
    x_sol = scal.D * final.x
    y_sol = scal.E * (scal.cinv * final.yh)
    obj = compute_objective(final, data, scal, settings)
    return final, x_sol, y_sol, obj
