"""Host-facing solver API.

`QPALM` mirrors the reference lifecycle qpalm_setup / qpalm_warm_start /
qpalm_solve / qpalm_update_* / (no cleanup needed — state is garbage-collected)
(reference: include/qpalm.h:43-138, interfaces/python/qpalm.py:191-226), but
the hot path is one jitted, padded, fixed-shape device program.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as C
from .scaling import identity_scaling, scale_data
from .solver.core import full_solve, init_state, solve_from_state
from .solver.core import compute_objective as _compute_objective
from .solver.nonconvex import lobpcg_min_eig
from .types import Info, QPData, Settings, Solution, SolveResult
from .validate import validate_data, validate_settings

__all__ = ["QPALM", "solve", "Settings"]


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


# Padding conventions (neutral w.r.t. the solve — see pad_problem):
_PAD_BOUND = 1e21  # beyond QPALM_INFTY so padded rows count as unconstrained


def _densify(M) -> np.ndarray:
    if hasattr(M, "toarray"):  # scipy sparse
        return np.asarray(M.toarray())
    return np.asarray(M)


def pad_problem(Q, A, q, bmin, bmax, n_pad: int, m_pad: int, dtype):
    """Embed the QP in padded fixed shapes without changing its solution.

    Padded variables get a unit Hessian diagonal and zero gradient (they stay
    exactly 0); padded constraints get zero rows and +-1e21 bounds (beyond
    QPALM_INFTY, so they are inactive and excluded from every infeasibility
    test, reference: termination.c:160-177).
    """
    n, m = Q.shape[0], A.shape[0]
    Qp = np.zeros((n_pad, n_pad), dtype)
    Qp[:n, :n] = Q
    if n_pad > n:
        Qp[range(n, n_pad), range(n, n_pad)] = 1.0
    Ap = np.zeros((m_pad, n_pad), dtype)
    Ap[:m, :n] = A
    qp = np.zeros((n_pad,), dtype)
    qp[:n] = q
    bl = np.full((m_pad,), -_PAD_BOUND, dtype)
    bl[:m] = bmin
    bu = np.full((m_pad,), _PAD_BOUND, dtype)
    bu[:m] = bmax
    return Qp, Ap, qp, bl, bu


_setup_and_solve = jax.jit(
    full_solve, static_argnames=("settings", "has_x", "has_y")
)


@functools.partial(jax.jit, static_argnames=("settings", "has_x", "has_y"))
def _setup_and_init(dataj: QPData, x_ws, y_ws, settings: Settings,
                    has_x: bool, has_y: bool, gamma_init=None, gamma_max=None):
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
    return st, data, scal


@functools.partial(jax.jit, static_argnames=("settings",))
def _solve_chunk(st, data, scal, settings: Settings, limit):
    final = solve_from_state(st, data, scal, settings, max_iter=limit)
    x_sol = scal.D * final.x
    y_sol = scal.E * (scal.cinv * final.yh)
    obj = _compute_objective(final, data, scal, settings)
    return final, x_sol, y_sol, obj


@functools.partial(jax.jit, static_argnames=("iters",))
def _scale_only(dataj: QPData, iters: int):
    return scale_data(dataj, iters)


class QPALM:
    """A QPALM solver instance for one problem.

    minimize 0.5 x'Qx + q'x + c   s.t.   bmin <= A x <= bmax

    Accepts dense numpy arrays or scipy sparse matrices for Q (n x n,
    symmetric) and A (m x n).
    """

    def __init__(self, Q, A, q, bmin, bmax, c=0.0,
                 settings: Optional[Settings] = None,
                 pad_multiple: int = 8,
                 sparse: Optional[bool] = None):
        t0 = time.perf_counter()
        settings = settings or Settings()
        validate_settings(settings)
        q = np.asarray(q, float).ravel()
        bmin = np.asarray(bmin, float).ravel()
        bmax = np.asarray(bmax, float).ravel()

        # large-problem sparse path: keep Q/A as BCOO and solve Newton
        # systems matrix-free (FACTORIZE_CG) — no n x n memory anywhere.
        # Auto-enabled for scipy-sparse input beyond the dense memory knee.
        is_scipy = hasattr(Q, "tocoo") and hasattr(A, "tocoo")
        if sparse is None:
            sparse = (
                is_scipy and Q.shape[0] >= 2048
            ) or settings.factorization_method == C.FACTORIZE_CG
        self.sparse = bool(sparse)
        dtype = np.dtype(settings.dtype)

        if self.sparse:
            import scipy.sparse as sp

            from .linalg.sparse import from_scipy

            if not is_scipy:
                Q = sp.csc_matrix(np.asarray(Q))
                A = sp.csc_matrix(np.asarray(A))
            self.n, self.m = validate_data(Q, A, q, bmin, bmax)
            if settings.enable_dual_termination:
                raise ValueError(
                    "enable_dual_termination requires a factorization of Q "
                    "and is unsupported on the sparse (CG) path"
                )
            settings = settings.replace(
                factorization_method=C.FACTORIZE_CG
            )
            self._n_pad, self._m_pad = self.n, max(self.m, 1)
            bl = np.maximum(np.asarray(bmin, dtype), -_PAD_BOUND)
            bu = np.minimum(np.asarray(bmax, dtype), _PAD_BOUND)
            if self.m == 0:
                A = sp.csc_matrix((1, self.n))
                bl = np.array([-_PAD_BOUND], dtype)
                bu = np.array([_PAD_BOUND], dtype)
            self._data = QPData(
                Q=from_scipy(Q, dtype), A=from_scipy(A, dtype),
                q=jnp.asarray(q, dtype),
                bmin=jnp.asarray(bl), bmax=jnp.asarray(bu),
                c=jnp.asarray(c, dtype),
            )
        else:
            Q = _densify(Q)
            A = _densify(A)
            self.n, self.m = validate_data(Q, A, q, bmin, bmax)
            if settings.factorization_method == C.FACTORIZE_STAGE:
                # padding would shift the stage blocks; keep exact shapes
                if self.n % max(settings.stage_block, 1):
                    raise ValueError(
                        "FACTORIZE_STAGE: n must be divisible by stage_block"
                    )
                pad_multiple = 1
            self._n_pad = _round_up(self.n, pad_multiple)
            self._m_pad = _round_up(max(self.m, 1), pad_multiple)
            Qp, Ap, qp, bl, bu = pad_problem(
                Q, A, q, bmin, bmax, self._n_pad, self._m_pad, dtype
            )
            # clip user infinities to the QPALM convention
            bl = np.maximum(bl, -_PAD_BOUND)
            bu = np.minimum(bu, _PAD_BOUND)
            self._data = QPData(
                Q=jnp.asarray(Qp), A=jnp.asarray(Ap), q=jnp.asarray(qp),
                bmin=jnp.asarray(bl), bmax=jnp.asarray(bu),
                c=jnp.asarray(c, dtype),
            )

        # nonconvex setup: min-eigenvalue of the *scaled* Q pins gamma
        # (reference: qpalm_setup -> set_settings_nonconvex, qpalm.c:294-296).
        # The pin is passed as a *traced* gamma override, not baked into the
        # static Settings, so distinct problems share one compiled solver.
        self._gamma_override: Optional[float] = None
        if settings.nonconvex:
            if settings.scaling:
                sdata, _ = _scale_only(self._data, settings.scaling)
            else:
                sdata = self._data
            if self.n <= 3:
                # LOBPCG's 3-vector subspace degenerates for n <= 3
                # (reference nonconvex.c special-cases these too); the exact
                # eigensolve is trivial at this size
                Qs = np.asarray(
                    sdata.Q.todense() if self.sparse else sdata.Q
                )[: self.n, : self.n]
                # the safety margin keeps M = Q + (1/gamma) I strictly PD
                # (reference applies the same -1e-6 at n <= 3,
                # nonconvex.c:122-124); exact lambda_min would make the
                # Newton system exactly singular on inactive iterates
                lam = float(np.linalg.eigvalsh(Qs)[0]) - 1e-6
            else:
                # start vector spans the padded dims too — padding only adds
                # unit eigenvalues, and full support keeps the subspace
                # non-degenerate
                rng = np.random.default_rng(0)
                x0 = rng.random(self._n_pad).astype(dtype)
                x0 /= np.linalg.norm(x0)
                lam = float(lobpcg_min_eig(sdata.Q, jnp.asarray(x0)))
            if lam < 0:
                settings = settings.replace(proximal=True)
                self._gamma_override = 1.0 / abs(lam)
            else:
                settings = settings.replace(nonconvex=False)
        self.settings = settings

        self._ws_x: Optional[np.ndarray] = None
        self._ws_y: Optional[np.ndarray] = None
        self._initialized = False  # a warm start is pending
        self.info: Optional[Info] = None
        self.solution: Optional[Solution] = None
        self._setup_time = time.perf_counter() - t0

    # -- lifecycle ---------------------------------------------------------

    def warm_start(self, x=None, y=None):
        """Provide starting iterates for the next solve (reference:
        qpalm_warm_start, src/qpalm.c:322-399; applies to one solve, matching
        the reference's initialized flag)."""
        dtype = np.dtype(self.settings.dtype)
        if x is not None:
            xp = np.zeros(self._n_pad, dtype)
            xp[: self.n] = np.asarray(x, float).ravel()
            self._ws_x = xp
        else:
            self._ws_x = None
        if y is not None:
            yp = np.zeros(self._m_pad, dtype)
            yp[: self.m] = np.asarray(y, float).ravel()
            self._ws_y = yp
        else:
            self._ws_y = None
        self._initialized = True

    def solve(self) -> SolveResult:
        """Run the solver (reference: qpalm_solve, src/qpalm.c:401-736)."""
        settings = self.settings
        dtype = np.dtype(settings.dtype)
        has_x = self._initialized and self._ws_x is not None
        has_y = self._initialized and self._ws_y is not None
        zeros_n = jnp.zeros((self._n_pad,), dtype)
        zeros_m = jnp.zeros((self._m_pad,), dtype)
        x_ws = jnp.asarray(self._ws_x) if has_x else zeros_n
        y_ws = jnp.asarray(self._ws_y) if has_y else zeros_m

        govr = self._gamma_override
        gi = jnp.asarray(govr, dtype) if govr is not None else None
        if settings.verbose:
            # header + run banner (reference: util.c:107-119)
            print(f"qpalm_jax 0.1.0  (n = {self.n}, m = {self.m})")
            print("  iter |   pri res    |   dua res    |     tau")
        t0 = time.perf_counter()
        if settings.time_limit >= C.QPALM_INFTY:
            final, x_sol, y_sol, obj = _setup_and_solve(
                self._data, x_ws, y_ws, settings, has_x, has_y,
                gamma_init=gi, gamma_max=gi,
            )
        else:
            # host-level chunking approximates the reference's in-loop
            # wall-clock abort (qpalm.c:680-708) without a clock inside jit
            st, data, scal = _setup_and_init(
                self._data, x_ws, y_ws, settings, has_x, has_y,
                gamma_init=gi, gamma_max=gi,
            )
            chunk = max(1, min(200, settings.max_iter))
            limit = chunk
            while True:
                final, x_sol, y_sol, obj = _solve_chunk(
                    st, data, scal, settings, jnp.asarray(limit, jnp.int32)
                )
                if bool(final.done) or int(final.iter) >= settings.max_iter:
                    break
                if time.perf_counter() - t0 > settings.time_limit:
                    final = final._replace(
                        status=jnp.asarray(C.QPALM_TIME_LIMIT_REACHED, jnp.int32)
                    )
                    break
                st = final
                limit = min(limit + chunk, settings.max_iter)
        solve_time = time.perf_counter() - t0
        if settings.verbose:
            # final boxed message (reference: util.c:121-206)
            status = C.STATUS_STRINGS.get(int(final.status), "unknown")
            print("-" * 54)
            print(f"status:     {status}")
            print(f"iterations: {int(final.iter)} "
                  f"(outer: {int(final.iter_out)})")
            print(f"objective:  {float(obj):.6e}")
            print(f"pri res:    {float(final.pri_res_norm):.4e}   "
                  f"dua res: {float(final.dua_res_norm):.4e}")
            print(f"solve time: {solve_time:.6f} s")
            print("-" * 54)

        self._initialized = False  # reference: qpalm.c:497 (one-shot warm start)

        n, m = self.n, self.m
        info = Info(
            iter=final.iter,
            iter_out=final.iter_out,
            status_val=final.status,
            pri_res_norm=final.pri_res_norm,
            dua_res_norm=final.dua_res_norm,
            dua2_res_norm=final.dua2_res_norm,
            objective=obj,
            dual_objective=final.dual_objective,
            setup_time=self._setup_time,
            solve_time=solve_time,
            run_time=self._setup_time + solve_time,
        )
        sol = Solution(x=np.asarray(x_sol)[:n], y=np.asarray(y_sol)[:m])
        result = SolveResult(
            solution=sol,
            info=info,
            delta_x=np.asarray(final.delta_x)[:n],
            delta_y=np.asarray(final.delta_y)[:m],
            state=final,
        )
        self.info = info
        self.solution = sol
        return result

    # -- parametric updates (reference: src/qpalm.c:739-871) ---------------

    def update_settings(self, settings: Settings):
        validate_settings(settings)
        if settings.scaling < self.settings.scaling:
            raise ValueError(
                "Decreasing the number of scaling iterations is not allowed"
            )
        self.settings = settings

    def update_bounds(self, bmin=None, bmax=None):
        dtype = np.dtype(self.settings.dtype)
        bl = np.asarray(self._data.bmin)
        bu = np.asarray(self._data.bmax)
        if bmin is not None:
            new_bl = np.asarray(bmin, float).ravel()
            if new_bl.shape != (self.m,):
                raise ValueError("bmin must have length m")
            bl = bl.copy()
            bl[: self.m] = np.maximum(new_bl, -_PAD_BOUND)
        if bmax is not None:
            new_bu = np.asarray(bmax, float).ravel()
            if new_bu.shape != (self.m,):
                raise ValueError("bmax must have length m")
            bu = bu.copy()
            bu[: self.m] = np.minimum(new_bu, _PAD_BOUND)
        if np.any(bl > bu):
            raise ValueError("Lower bound greater than upper bound")
        self._data = self._data._replace(
            bmin=jnp.asarray(bl, dtype), bmax=jnp.asarray(bu, dtype)
        )

    def update_q(self, q):
        dtype = np.dtype(self.settings.dtype)
        new_q = np.asarray(q, float).ravel()
        if new_q.shape != (self.n,):
            raise ValueError("q must have length n")
        qp = np.zeros(self._n_pad, dtype)
        qp[: self.n] = new_q
        self._data = self._data._replace(q=jnp.asarray(qp))


def solve(Q, A, q, bmin, bmax, c=0.0, settings: Optional[Settings] = None,
          x0=None, y0=None, **settings_kw) -> SolveResult:
    """One-shot convenience wrapper: setup + (warm start) + solve.

    Large scipy-sparse convex problems (n >= 2048 with no explicit
    factorization_method) route through `solve_sparse_auto`, which picks
    the native direct LDL' backends (Schur or KKT form, simplicial or
    supernodal, AMD/RCM ordering) or matrix-free CG by estimated factor
    cost — the reference's qpalm_qps driver gets this selection through
    LADEL; here it is the host path (results repackaged as SolveResult)."""
    if settings is None:
        settings = Settings(**settings_kw)
    elif settings_kw:
        settings = settings.replace(**settings_kw)
    is_scipy = hasattr(Q, "tocoo") and hasattr(A, "tocoo")
    if (is_scipy and Q.shape[0] >= 2048
            and not settings.enable_dual_termination
            and settings.factorization_method == C.FACTORIZE_KKT_OR_SCHUR
            and settings.time_limit >= C.QPALM_INFTY):
        from .host_sparse import solve_sparse_auto

        t0 = time.perf_counter()
        r = solve_sparse_auto(Q, A, q, bmin, bmax, settings, c=c,
                              x0=x0, y0=y0)
        dt = time.perf_counter() - t0
        nan_n = jnp.full(np.shape(q), jnp.nan)
        nan_m = jnp.full(np.shape(bmin), jnp.nan)
        return SolveResult(
            solution=Solution(x=jnp.asarray(r.x), y=jnp.asarray(r.y)),
            info=Info(
                iter=jnp.asarray(r.iterations),
                iter_out=jnp.asarray(0),
                status_val=jnp.asarray(r.status),
                pri_res_norm=jnp.asarray(r.pri_res_norm),
                dua_res_norm=jnp.asarray(r.dua_res_norm),
                dua2_res_norm=jnp.asarray(jnp.nan),
                objective=jnp.asarray(r.objective),
                dual_objective=jnp.asarray(jnp.nan),
                setup_time=0.0, solve_time=dt, run_time=dt,
            ),
            delta_x=(jnp.asarray(r.delta_x) if r.delta_x is not None
                     else nan_n),
            delta_y=(jnp.asarray(r.delta_y) if r.delta_y is not None
                     else nan_m),
            state=None,
        )
    solver = QPALM(Q, A, q, bmin, bmax, c=c, settings=settings)
    if x0 is not None or y0 is not None:
        solver.warm_start(x0, y0)
    return solver.solve()
