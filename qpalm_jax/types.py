"""Core data types for the JAX QPALM solver.

Where the reference keeps ~60 mutable C arrays in one heap workspace
(reference: include/types.h:197-314), this implementation keeps one immutable
pytree of JAX arrays (`SolverState`) threaded through a `lax.while_loop`, so a
whole solve jits, vmaps and shards.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax.numpy as jnp

from . import constants as C


@dataclasses.dataclass(frozen=True)
class Settings:
    """Solver settings (reference: include/types.h:119-150, defaults
    constants.h:65-110).

    The dataclass is frozen + hashable so it can be passed as a static
    argument to `jax.jit`: settings select the *structure* of the compiled
    solver (proximal terms, factorization mode, loop bounds), so a retrace per
    distinct settings object is the natural compilation unit.
    """

    max_iter: int = C.MAX_ITER
    inner_max_iter: int = C.INNER_MAX_ITER
    eps_abs: float = C.EPS_ABS
    eps_rel: float = C.EPS_REL
    eps_abs_in: float = C.EPS_ABS_IN
    eps_rel_in: float = C.EPS_REL_IN
    rho: float = C.RHO
    eps_prim_inf: float = C.EPS_PRIM_INF
    eps_dual_inf: float = C.EPS_DUAL_INF
    theta: float = C.THETA
    delta: float = C.DELTA
    sigma_max: float = C.SIGMA_MAX
    sigma_init: float = C.SIGMA_INIT
    proximal: bool = C.PROXIMAL
    gamma_init: float = C.GAMMA_INIT
    gamma_upd: float = C.GAMMA_UPD
    gamma_max: float = C.GAMMA_MAX
    scaling: int = C.SCALING
    nonconvex: bool = C.NONCONVEX
    warm_start: bool = C.WARM_START
    verbose: bool = C.VERBOSE
    print_iter: int = C.PRINT_ITER
    reset_newton_iter: int = C.RESET_NEWTON_ITER
    enable_dual_termination: bool = C.ENABLE_DUAL_TERMINATION
    dual_objective_limit: float = C.DUAL_OBJECTIVE_LIMIT
    time_limit: float = C.TIME_LIMIT
    ordering: int = 0  # kept for API parity; the dense path has no ordering
    factorization_method: int = C.FACTORIZATION_METHOD
    max_rank_update: int = C.MAX_RANK_UPDATE
    max_rank_update_fraction: float = C.MAX_RANK_UPDATE_FRACTION
    # --- extensions (no reference equivalent) ---
    # max iterative-refinement rounds on the Newton solve (reference applies
    # refinement in the KKT path, newton.c:57-90; we expose it for both paths)
    max_refine: int = C.MAX_REFINEMENT_ITERATIONS
    dtype: str = "float64"  # "float64" (reference parity) or "float32" (speed)
    # mixed-precision iterative refinement: evaluate the Newton residual in
    # float64 while the factorization stays in `dtype` (only meaningful for
    # dtype="float32"; recovers f64-quality directions at f32 matmul cost)
    refine_fp64: bool = False
    # exact-linesearch form: "sort" (reference linesearch.c:14-120
    # sort-and-scan, bit-faithful to the qsort walk), "bisect" (sort-free
    # safeguarded Newton/bisection — same exact minimizer, differential-
    # tested), or "auto" (bisect for float32, sort for float64 reference
    # parity)
    linesearch: str = "auto"
    # CG Newton solve (factorization_method=FACTORIZE_CG): relative residual
    # tolerance and iteration cap of the matrix-free inner solver
    cg_tol: float = C.CG_TOL
    cg_max_iter: int = C.CG_MAX_ITER
    # CG preconditioner: "jacobi" (diag(M)) or "block_jacobi" (factored
    # block diagonals of M, size cg_block — bounds CG iteration growth on
    # ill-conditioned problems at O(n/b * nnz-slice) extra setup per
    # Newton step)
    cg_precond: str = "jacobi"
    cg_block: int = 64
    # stage-structured Newton (FACTORIZE_STAGE): block size nb = nx + nu of
    # the stage-ordered MPC problem; n must be divisible by it
    stage_block: int = 0
    # solver iterations per while_loop trip (unrolling K iterations per
    # trip amortizes a per-trip loop overhead; finished lanes hit the
    # idempotent terminate branch, so results are unchanged)
    unroll: int = 1
    # float32 speed mode: evaluate the per-iteration residual quantities
    # (Qx, Ax, dphi, yh) in float64 from fresh matvecs, store float32 —
    # removes the f32 cancellation floor (~1e-4) on the dual residual while
    # the dominant Schur assembly + Cholesky stay in f32
    residuals_fp64: bool = False

    def replace(self, **kw) -> "Settings":
        return dataclasses.replace(self, **kw)


class QPData(NamedTuple):
    """Problem data (reference: include/types.h:104-113).

    minimize 0.5 x'Qx + q'x + c   s.t.  bmin <= A x <= bmax

    Q and A are stored dense (padded): the device matvecs and Schur assembly
    are dense matrix products, which favour dense blocked layouts over the
    reference's CSC.
    """

    Q: jnp.ndarray  # (n, n) symmetric
    A: jnp.ndarray  # (m, n)
    q: jnp.ndarray  # (n,)
    bmin: jnp.ndarray  # (m,)
    bmax: jnp.ndarray  # (m,)
    c: jnp.ndarray  # scalar constant in the objective

    @property
    def n(self) -> int:
        return self.Q.shape[-1]

    @property
    def m(self) -> int:
        return self.A.shape[-2]


class ScalingInfo(NamedTuple):
    """Ruiz equilibration output (reference: include/types.h QPALMScaling)."""

    D: jnp.ndarray  # (n,) primal scaling
    Dinv: jnp.ndarray
    E: jnp.ndarray  # (m,) dual scaling
    Einv: jnp.ndarray
    c: jnp.ndarray  # scalar cost scaling
    cinv: jnp.ndarray


class SolverState(NamedTuple):
    """Full solver state: the functional analogue of QPALMWorkspace
    (reference: include/types.h:197-314). One pytree, one while_loop."""

    # iterates
    x: jnp.ndarray  # (n,) scaled primal iterate
    y: jnp.ndarray  # (m,) scaled dual iterate
    x0: jnp.ndarray  # (n,) proximal center
    x_prev: jnp.ndarray  # (n,)
    Qx: jnp.ndarray  # (n,) Q x (+ x/gamma when proximal)
    Ax: jnp.ndarray  # (m,)
    Aty: jnp.ndarray  # (n,)
    # residual quantities (compute_residuals, reference iteration.c:24-48)
    Axys: jnp.ndarray  # (m,) Ax + y/sigma
    z: jnp.ndarray  # (m,) clamp(Axys, bmin, bmax)
    pri_res: jnp.ndarray  # (m,) Ax - z
    pri_res_in: jnp.ndarray  # (m,) pri_res at last outer update
    yh: jnp.ndarray  # (m,) candidate dual y + sigma*pri_res
    Atyh: jnp.ndarray  # (n,)
    df: jnp.ndarray  # (n,) gradient of f
    dphi: jnp.ndarray  # (n,) gradient of phi
    dphi_prev: jnp.ndarray  # (n,)
    # newton / linesearch
    d: jnp.ndarray  # (n,) newton direction
    Qd: jnp.ndarray  # (n,) after update: tau*(Qd [+ d/gamma])
    Ad: jnp.ndarray  # (m,) after update: tau*Ad
    tau: jnp.ndarray  # scalar step
    active: jnp.ndarray  # (m,) bool
    active_old: jnp.ndarray  # (m,) bool
    nb_enter: jnp.ndarray  # scalar int
    nb_leave: jnp.ndarray  # scalar int
    L: jnp.ndarray  # (n,n) cached Cholesky factor of the Schur matrix
    factor_valid: jnp.ndarray  # scalar bool: L matches current (active, sigma, gamma)
    # Gershgorin upper bound of A' diag(sigma*active) A cached at
    # factorization time, so boost_gamma (reference: iteration.c:158-205)
    # reads a scalar instead of re-assembling the O(n^2 m) product — under
    # vmap every branch of the iteration runs every step, so that matmul
    # would otherwise double the per-iteration cost
    gersh: jnp.ndarray  # scalar
    # penalties
    sigma: jnp.ndarray  # (m,)
    sigma_inv: jnp.ndarray
    sqrt_sigma: jnp.ndarray
    gamma: jnp.ndarray  # scalar
    gamma_maxed: jnp.ndarray  # scalar bool
    # gamma cap carried as *state* (not a static setting) so nonconvex gamma
    # pinning (reference: nonconvex.c:171-183) is per-problem under vmap
    gamma_max: jnp.ndarray  # scalar
    # inner tolerance state
    eps_abs_in: jnp.ndarray  # scalar
    eps_rel_in: jnp.ndarray
    eps_k_abs: jnp.ndarray  # nonconvex proximal-center tolerances (qpalm.c:477-482)
    eps_k_rel: jnp.ndarray
    # termination quantities
    pri_res_norm: jnp.ndarray
    dua_res_norm: jnp.ndarray
    dua2_res_norm: jnp.ndarray
    eps_pri: jnp.ndarray
    eps_dua: jnp.ndarray
    eps_dua_in: jnp.ndarray
    # infeasibility certificates
    delta_y: jnp.ndarray  # (m,)
    delta_x: jnp.ndarray  # (n,)
    # loop bookkeeping
    iter: jnp.ndarray  # scalar int
    iter_out: jnp.ndarray
    prev_iter: jnp.ndarray
    no_change: jnp.ndarray  # consecutive iters without active-set change
    done: jnp.ndarray  # scalar bool
    status: jnp.ndarray  # scalar int
    dual_objective: jnp.ndarray  # scalar


class Info(NamedTuple):
    """Result info (reference: include/types.h:76-95 QPALMInfo)."""

    iter: jnp.ndarray
    iter_out: jnp.ndarray
    status_val: jnp.ndarray
    pri_res_norm: jnp.ndarray
    dua_res_norm: jnp.ndarray
    dua2_res_norm: jnp.ndarray
    objective: jnp.ndarray
    dual_objective: jnp.ndarray
    setup_time: float = 0.0
    solve_time: float = 0.0
    run_time: float = 0.0

    @property
    def status(self) -> str:
        try:
            return C.STATUS_STRINGS[int(self.status_val)]
        except (TypeError, KeyError):
            return "unknown"


class Solution(NamedTuple):
    """Unscaled solution (reference: include/types.h QPALMSolution)."""

    x: jnp.ndarray
    y: jnp.ndarray


class SolveResult(NamedTuple):
    solution: Solution
    info: Info
    # infeasibility certificates (unscaled), NaN-free only when relevant
    delta_x: jnp.ndarray
    delta_y: jnp.ndarray
    # final internal state (scaled) — reusable for warm starting
    state: Optional[SolverState] = None
