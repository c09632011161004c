"""Batched QPALM: solve many independent QPs per chip with one `vmap`.

The reference solves one QP per process (one heap workspace, reference:
src/qpalm.c:401-736); its batch workloads — Maros-Meszaros sweeps
(simulations/maros_meszaros/test_maros_meszaros.m) and MPC scenario trees —
loop over problems on the host.  On the device the batch *is* the
parallelism: the whole solve loop in `qpalm_jax.solver.core` is pure and
fixed-shape, so `jax.vmap` turns it into one device program over a stacked
problem pytree.
Per-instance early termination becomes the `done` mask inside the while_loop
(the loop runs until every instance in the batch is done; finished instances
hit the `terminate_fn` branch and stop mutating).

Heterogeneous problem sizes are handled by padding to a shared shape bucket
(`stack_problems` / `bucket_indices` / `solve_many`): padded variables/constraints are
constructed to be exactly neutral (see qpalm_jax.api.pad_problem).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as C
from .api import _PAD_BOUND, _densify, _round_up, pad_problem
from .solver.core import full_solve
from .solver.nonconvex import batch_gamma_pins
from .types import QPData, Settings


class BatchResult(NamedTuple):
    """Stacked per-instance results (leading axis = batch)."""

    x: jnp.ndarray  # (B, n_pad) unscaled primal solutions
    y: jnp.ndarray  # (B, m_pad) unscaled dual solutions
    status: jnp.ndarray  # (B,) int32 status codes (constants.QPALM_*)
    iterations: jnp.ndarray  # (B,) int32
    objective: jnp.ndarray  # (B,)
    pri_res_norm: jnp.ndarray  # (B,)
    dua_res_norm: jnp.ndarray  # (B,)

    @property
    def solved(self) -> jnp.ndarray:
        return self.status == C.QPALM_SOLVED

    def iteration_histogram(self, bins=10):
        """Per-lane iteration histogram (counts, edges) — the lockstep-
        straggler diagnostic (VERDICT r1 item 8)."""
        return np.histogram(np.asarray(self.iterations), bins=bins)


# in_axes template: every QPData leaf carries a leading batch axis,
# including the scalar objective constant (it is per-problem)
_DATA_AXES = QPData(Q=0, A=0, q=0, bmin=0, bmax=0, c=0)


def _solve_one(data, x_ws, y_ws, gamma, settings, has_ws, has_gamma):
    # per-iteration verbose printing is a host callback: meaningless (and
    # slow) under vmap — force off
    settings = settings.replace(verbose=False)
    g = gamma if has_gamma else None
    final, x_sol, y_sol, obj = full_solve(
        data, x_ws, y_ws, settings,
        has_x=has_ws, has_y=has_ws,
        gamma_init=g, gamma_max=g,
    )
    return BatchResult(
        x=x_sol,
        y=y_sol,
        status=final.status,
        iterations=final.iter,
        objective=obj,
        pri_res_norm=final.pri_res_norm,
        dua_res_norm=final.dua_res_norm,
    )


@functools.partial(
    jax.jit, static_argnames=("settings", "has_ws", "has_gamma")
)
def solve_batch_jit(
    data: QPData,
    x_ws: jnp.ndarray,
    y_ws: jnp.ndarray,
    gamma: jnp.ndarray,
    settings: Settings,
    has_ws: bool,
    has_gamma: bool,
) -> BatchResult:
    """vmapped solve over a stacked `QPData` (leading batch axis on every
    leaf).  `gamma` is the per-problem nonconvex gamma pin (ignored unless
    `has_gamma`).  Jittable, shardable (see qpalm_jax.parallel)."""
    return jax.vmap(
        _solve_one, in_axes=(_DATA_AXES, 0, 0, 0, None, None, None)
    )(data, x_ws, y_ws, gamma, settings, has_ws, has_gamma)


@functools.partial(jax.jit, static_argnames=("settings", "has_ws"))
def _batch_init(data, x_ws, y_ws, settings, has_ws):
    from .api import _setup_and_init

    settings = settings.replace(verbose=False)

    def one(d, xw, yw):
        return _setup_and_init(d, xw, yw, settings, has_ws, has_ws)

    return jax.vmap(one, in_axes=(_DATA_AXES, 0, 0))(data, x_ws, y_ws)


@functools.partial(jax.jit, static_argnames=("settings",))
def _batch_chunk(sts, sdata, scals, settings, limit):
    from .solver.core import solve_from_state

    def one(st, d, sc):
        return solve_from_state(st, d, sc, settings, max_iter=limit)

    return jax.vmap(one, in_axes=(0, _DATA_AXES, 0))(sts, sdata, scals)


@functools.partial(jax.jit, static_argnames=("settings",))
def _batch_finalize(final, sdata, scals, settings):
    from .solver.core import compute_objective

    def one(f, d, sc):
        return BatchResult(
            x=sc.D * f.x,
            y=sc.E * (sc.cinv * f.yh),
            status=f.status,
            iterations=f.iter,
            objective=compute_objective(f, d, sc, settings),
            pri_res_norm=f.pri_res_norm,
            dua_res_norm=f.dua_res_norm,
        )

    return jax.vmap(one, in_axes=(0, _DATA_AXES, 0))(final, sdata, scals)


def _solve_batch_time_limited(data, x_ws, y_ws, settings, has_ws):
    """Host-chunked batch solve enforcing settings.time_limit wall-clock
    (the batch analogue of the single-QP chunking, reference
    qpalm.c:680-708): run max-iteration chunks, checking the clock between
    dispatches; unfinished lanes get QPALM_TIME_LIMIT_REACHED."""
    import time as _time

    t0 = _time.perf_counter()
    sts, sdata, scals = _batch_init(data, x_ws, y_ws, settings, has_ws)
    chunk = max(1, min(200, settings.max_iter))
    limit = chunk
    while True:
        sts = _batch_chunk(
            sts, sdata, scals, settings, jnp.asarray(limit, jnp.int32)
        )
        done = np.asarray(sts.done)
        if done.all() or limit >= settings.max_iter:
            break
        if _time.perf_counter() - t0 > settings.time_limit:
            sts = sts._replace(
                status=jnp.where(
                    sts.done, sts.status,
                    jnp.asarray(C.QPALM_TIME_LIMIT_REACHED, jnp.int32),
                ),
                done=jnp.ones_like(sts.done),
            )
            break
        limit = min(limit + chunk, settings.max_iter)
    return _batch_finalize(sts, sdata, scals, settings)


def stack_problems(
    problems: Sequence[tuple],
    dtype,
    pad_multiple: int = 8,
    n_pad: Optional[int] = None,
    m_pad: Optional[int] = None,
    host: bool = False,
) -> QPData:
    """Pad each (Q, A, q, bmin, bmax[, c]) tuple to a common shape and stack
    into one batched QPData: device arrays, or numpy arrays with `host`
    (host-side f64 staging for the numpy certification paths)."""
    sizes = [(_densify(p[0]).shape[0], _densify(p[1]).shape[0]) for p in problems]
    if n_pad is None:
        n_pad = _round_up(max(s[0] for s in sizes), pad_multiple)
    if m_pad is None:
        m_pad = _round_up(max(max(s[1] for s in sizes), 1), pad_multiple)
    Qs, As, qs, bls, bus, cs = [], [], [], [], [], []
    for p in problems:
        Q, A, q, bmin, bmax = p[:5]
        c = p[5] if len(p) > 5 else 0.0
        Qp, Ap, qp, bl, bu = pad_problem(
            _densify(Q), _densify(A),
            np.asarray(q, float).ravel(),
            np.asarray(bmin, float).ravel(),
            np.asarray(bmax, float).ravel(),
            n_pad, m_pad, dtype,
        )
        Qs.append(Qp)
        As.append(Ap)
        qs.append(qp)
        bls.append(np.maximum(bl, -_PAD_BOUND))
        bus.append(np.minimum(bu, _PAD_BOUND))
        cs.append(c)
    data = QPData(
        Q=np.stack(Qs), A=np.stack(As), q=np.stack(qs),
        bmin=np.stack(bls), bmax=np.stack(bus), c=np.asarray(cs, dtype),
    )
    return data if host else jax.tree.map(jnp.asarray, data)


def bucket_indices(
    sizes: Sequence[tuple], pad_multiple: int = 8
) -> dict:
    """Group problem indices by padded (n_pad, m_pad) bucket, so a
    heterogeneous sweep compiles one program per bucket instead of per
    problem (the cost model flagged in SURVEY.md §7)."""
    buckets: dict = {}
    for i, (n, m) in enumerate(sizes):
        key = (_round_up(n, pad_multiple), _round_up(max(m, 1), pad_multiple))
        buckets.setdefault(key, []).append(i)
    return buckets


def solve_batch(
    problems: Sequence[tuple],
    settings: Optional[Settings] = None,
    x0: Optional[Sequence] = None,
    y0: Optional[Sequence] = None,
    pad_multiple: int = 8,
    **settings_kw,
) -> BatchResult:
    """Solve a batch of QPs given as (Q, A, q, bmin, bmax[, c]) tuples.

    All problems are padded to one shared shape; warm starts (`x0`, `y0`) are
    all-or-none.  For `Settings(nonconvex=True)` each problem's minimum
    eigenvalue is estimated with a vmapped LOBPCG and gamma is pinned
    per-problem (reference: nonconvex.c:171-183); problems that turn out
    convex keep the default proximal schedule.
    """
    if settings is None:
        settings = Settings(**settings_kw)
    elif settings_kw:
        settings = settings.replace(**settings_kw)
    dtype = np.dtype(settings.dtype)
    data = stack_problems(problems, dtype, pad_multiple)
    B, n_pad = data.q.shape
    m_pad = data.bmin.shape[1]

    has_ws = x0 is not None or y0 is not None
    x_ws = jnp.zeros((B, n_pad), dtype)
    y_ws = jnp.zeros((B, m_pad), dtype)
    if has_ws:
        xs = np.zeros((B, n_pad), dtype)
        ys = np.zeros((B, m_pad), dtype)
        for i, p in enumerate(problems):
            ni = _densify(p[0]).shape[0]
            mi = _densify(p[1]).shape[0]
            if x0 is not None:
                xs[i, :ni] = np.asarray(x0[i], float).ravel()
            if y0 is not None:
                ys[i, :mi] = np.asarray(y0[i], float).ravel()
        x_ws = jnp.asarray(xs)
        y_ws = jnp.asarray(ys)

    gamma_init = gamma_max = None
    if settings.nonconvex:
        # per-problem min-eigenvalue pinning on the scaled Q (vmapped
        # LOBPCG)
        gamma_init, gamma_max = batch_gamma_pins(data, settings)
        settings = settings.replace(proximal=True)

    if settings.nonconvex:
        if settings.time_limit < C.QPALM_INFTY:
            raise NotImplementedError(
                "time_limit is not supported for nonconvex BATCH solves "
                "(the host-chunked enforcement does not carry the per-lane "
                "gamma pins); use per-problem QPALM solves for that"
            )
        return _solve_batch_gi(
            data, x_ws, y_ws, gamma_init, gamma_max, settings, has_ws
        )

    if settings.time_limit < C.QPALM_INFTY:
        return _solve_batch_time_limited(
            data, x_ws, y_ws, settings.replace(verbose=False), has_ws
        )

    gamma = jnp.full((B,), settings.gamma_init, dtype)
    return solve_batch_jit(data, x_ws, y_ws, gamma, settings, has_ws, False)


class ManyResult(NamedTuple):
    """Results of a heterogeneous sweep: every array is rectangular, padded
    to the largest bucket; `n`/`m` carry each problem's true sizes so
    `result.x[i, :result.n[i]]` is problem i's solution."""

    x: np.ndarray  # (B, max_n_pad) zero-padded primal solutions
    y: np.ndarray  # (B, max_m_pad) zero-padded dual solutions
    status: np.ndarray  # (B,) int32
    iterations: np.ndarray  # (B,) int32
    objective: np.ndarray  # (B,)
    pri_res_norm: np.ndarray  # (B,)
    dua_res_norm: np.ndarray  # (B,)
    n: np.ndarray  # (B,) true variable counts
    m: np.ndarray  # (B,) true constraint counts

    @property
    def solved(self) -> np.ndarray:
        return self.status == C.QPALM_SOLVED


def solve_many(
    problems: Sequence[tuple],
    settings: Optional[Settings] = None,
    pad_multiple: int = 8,
    escalate: bool = False,
    **settings_kw,
) -> ManyResult:
    """Solve a heterogeneous problem list: bucket by padded shape, run one
    vmapped batch per bucket (one compile each), scatter results back into
    input order.  The sweep-driver pattern (scripts/run_qps_suite.py) as a
    library call; `escalate=True` adds the f32 -> f64 straggler re-solve.

    Returns a `ManyResult` whose x/y are rectangular arrays padded to the
    largest bucket (with `n`/`m` giving true per-problem sizes) — a stable
    typed contract for heterogeneous sweeps."""
    if settings is None:
        settings = Settings(**settings_kw)
    elif settings_kw:
        settings = settings.replace(**settings_kw)
    sizes = [(_densify(p[0]).shape[0], _densify(p[1]).shape[0])
             for p in problems]
    buckets = bucket_indices(sizes, pad_multiple)
    B = len(problems)
    max_np = max(_round_up(n, pad_multiple) for n, _ in sizes)
    max_mp = max(_round_up(max(m, 1), pad_multiple) for _, m in sizes)
    ns = np.asarray([s[0] for s in sizes], np.int32)
    ms = np.asarray([s[1] for s in sizes], np.int32)
    x = np.zeros((B, max_np))
    y = np.zeros((B, max_mp))
    scal = {
        f: np.zeros((B,), np.int32 if f in ("status", "iterations") else float)
        for f in ("status", "iterations", "objective", "pri_res_norm",
                  "dua_res_norm")
    }
    for idxs in buckets.values():
        sub = [problems[i] for i in idxs]
        if escalate:
            res = solve_batch_escalate(sub, settings,
                                       pad_multiple=pad_multiple)
        else:
            res = solve_batch(sub, settings, pad_multiple=pad_multiple)
        xb = np.asarray(res.x)
        yb = np.asarray(res.y)
        x[idxs, : xb.shape[1]] = xb
        y[idxs, : yb.shape[1]] = yb
        for f in scal:
            scal[f][idxs] = np.asarray(getattr(res, f))
    return ManyResult(x=x, y=y, n=ns, m=ms, **scal)


def solve_batch_escalate(
    problems: Sequence[tuple],
    settings: Optional[Settings] = None,
    fallback_settings: Optional[Settings] = None,
    fallback_device=None,
    pad_multiple: int = 8,
    **settings_kw,
) -> BatchResult:
    """Two-pass batch solve: a fast (typically float32) vmapped pass, then a
    float64 re-solve of any lane that did not reach `solved` — scattered back
    into one BatchResult.

    The answer to the f32 accuracy floor: the bulk runs in f32, the
    stragglers (typically a few percent) get full reference-precision
    treatment in f64, on `fallback_device` if given, else on the default
    device.  No reference equivalent — C-QPALM is all-double.
    """
    if settings is None:
        settings_kw.setdefault("dtype", "float32")
        settings = Settings(**settings_kw)
    elif settings_kw:
        settings = settings.replace(**settings_kw)
    res = solve_batch(problems, settings, pad_multiple=pad_multiple)
    status = np.asarray(res.status)
    bad = [i for i in range(len(problems)) if status[i] != C.QPALM_SOLVED]
    if not bad:
        return res

    if fallback_settings is None:
        fallback_settings = settings.replace(
            dtype="float64",
            max_iter=max(settings.max_iter, 4000),
            refine_fp64=False,
            residuals_fp64=False,
        )
    with jax.default_device(fallback_device):
        res2 = solve_batch([problems[i] for i in bad], fallback_settings)

    merged = {}
    for field in BatchResult._fields:
        a = np.asarray(getattr(res, field)).copy()
        b = np.asarray(getattr(res2, field))
        if a.ndim > 1 and a.shape[1] != b.shape[1]:
            # fallback bucket may pad differently; align on the smaller width
            w = min(a.shape[1], b.shape[1])
            a[bad, :w] = b[:, :w]
        else:
            a[bad] = b
        merged[field] = jnp.asarray(a)
    return BatchResult(**merged)


@functools.partial(jax.jit, static_argnames=("settings", "has_ws"))
def _solve_batch_gi(data, x_ws, y_ws, gamma_init, gamma_max, settings, has_ws):
    """Batch solve with distinct per-problem gamma_init / gamma_max."""
    settings = settings.replace(verbose=False)

    def one(d, xw, yw, gi, gm):
        final, x_sol, y_sol, obj = full_solve(
            d, xw, yw, settings, has_x=has_ws, has_y=has_ws,
            gamma_init=gi, gamma_max=gm,
        )
        return BatchResult(
            x=x_sol, y=y_sol, status=final.status, iterations=final.iter,
            objective=obj, pri_res_norm=final.pri_res_norm,
            dua_res_norm=final.dua_res_norm,
        )

    return jax.vmap(one, in_axes=(_DATA_AXES, 0, 0, 0, 0))(
        data, x_ws, y_ws, gamma_init, gamma_max
    )
