"""Device-resident pipeline for LARGE dense QPs (n >= ~256).

A large QP whose factorization fills (dense-ish Q/A) is a dense-matrix
problem: one masked Schur refactorization M = Q + (sigma_act * A)'A + beta I
is a single (n, m) x (m, n) product plus a dense Cholesky per Newton step,
which the device runs far faster than the host's sparse or dense LDL'.
The host sparse-direct path keeps the genuinely sparse problems.

Pipeline (the headline bench recipe applied to the large-single regime):

1. f32 XLA solve on device (`solver.core` SCHUR loop under
   `default_matmul_precision('highest')`) — the whole P-ALM loop is one
   jitted `lax.while_loop`, so per-iteration dispatch is device-side only.
2. f64 active-set polish on the host (`polish_batch_np`: one compacted
   KKT solve + full KKT check per problem).
3. Warm-started f64 numpy P-ALM finisher for polish failures
   (`finish_np.palm_finish_np`), re-certified by the same KKT check.

Every returned solution is certified at the target eps in f64 on the
unscaled problem or flagged `ok=False` — the same honesty contract as the
headline bench.

Reference semantics anchors: masked Schur refactorization =
`ldlcholQAtsigmaA` (solver_interface.c:372-405) recomputed per Newton
step; the loop itself is qpalm.c:401-736.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence

import numpy as np

from .types import Settings


class LargeResult(NamedTuple):
    """Per-problem results of the large-dense pipeline (leading axis B)."""

    x: np.ndarray          # (B, n) f64 polished primal solutions
    y: np.ndarray          # (B, m) f64 polished dual solutions
    ok: np.ndarray         # (B,) bool — f64 KKT-certified at eps
    status: np.ndarray     # (B,) int32 f32-pass status codes
    iterations: np.ndarray  # (B,) int32 f32-pass iterations
    objective: np.ndarray  # (B,) f64 certified objectives
    t_device_s: float      # f32 device pass wall-clock
    t_polish_s: float      # host polish + finisher wall-clock


def f32_settings(eps_f32: float = 1e-4, max_iter: int = 2000,
                 scaling: int = 10) -> Settings:
    """The f32 device pass's default settings."""
    return Settings(
        dtype="float32", eps_abs=eps_f32, eps_rel=eps_f32,
        max_iter=max_iter, scaling=scaling, max_refine=2, delta=10.0,
        verbose=False,
    )


def solve_large_dense(
    problems: Sequence[tuple],
    eps: float = 1e-6,
    eps_f32: float = 1e-4,
    settings: Optional[Settings] = None,
    max_iter: int = 2000,
    scaling: int = 10,
    device_polish: bool = False,
) -> LargeResult:
    """Solve a (batch of) large dense QP(s) on the device at f32, then
    certify at `eps` in f64 (host polish by default; optional on-device).

    `problems`: sequence of (Q, A, q, bmin, bmax[, c]) tuples, dense or
    scipy-sparse (densified on transfer — this path is for problems whose
    factorization fills anyway; keep genuinely sparse problems on
    `solve_sparse_auto`).

    `device_polish=True` runs the certification solve on the device
    (`polish_device.polish_batch_device`, f64-residual mode — at n >= 512
    the f32 residual floor grows past the 1e-6 thresholds).  Off by
    default: the host polish certifies this regime with compacted
    active-rows systems.  Lanes the device rejects fall back to the host
    polish + finisher tail either way, so the certification contract is
    unchanged.
    """
    import jax

    from .batch import solve_batch, stack_problems
    from .finish_np import palm_finish_np
    from .polish import polish_batch_np

    if settings is None:
        settings = f32_settings(eps_f32, max_iter, scaling)

    t0 = time.perf_counter()
    res = solve_batch(problems, settings)
    xy = np.concatenate([np.asarray(res.x), np.asarray(res.y)], axis=1)
    t_device = time.perf_counter() - t0

    t0 = time.perf_counter()
    d64 = stack_problems(problems, np.float64, host=True)
    n_pad = d64.q.shape[1]
    x32, y32 = xy[:, :n_pad], xy[:, n_pad:]
    if device_polish and jax.default_backend() != "cpu":
        import jax.numpy as jnp

        from .polish_device import polish_batch_device

        d64d = jax.tree.map(jnp.asarray, d64)
        pd = polish_batch_device(
            d64d, jnp.asarray(x32), jnp.asarray(y32),
            eps_abs=eps, eps_rel=eps, refine_iters=4,
            second_round_k=min(16, len(problems)), seed_guard="norm",
        )
        # np.array (not asarray): jax device arrays view as read-only
        ok = np.array(pd.ok)
        x64 = np.array(pd.x)
        y64 = np.array(pd.y)
        obj = np.array(pd.objective)
        bad = np.where(~ok)[0]
        if len(bad):
            # host polish retry for device rejects (full-f64 LU + more
            # active-set rounds), before the finisher tier below
            sub = jax.tree.map(lambda a: a[bad], d64)
            polh = polish_batch_np(sub, x32[bad], y32[bad],
                                   eps_abs=eps, eps_rel=eps, rounds=3)
            ok[bad] = np.asarray(polh.ok)
            x64[bad] = np.asarray(polh.x)
            y64[bad] = np.asarray(polh.y)
            obj[bad] = np.asarray(polh.objective)
    else:
        pol = polish_batch_np(d64, x32, y32, eps_abs=eps, eps_rel=eps,
                              rounds=3)
        ok = np.asarray(pol.ok)
        x64 = np.asarray(pol.x)
        y64 = np.asarray(pol.y)
        obj = np.asarray(pol.objective)
    bad = np.where(~ok)[0]
    if len(bad):
        sub = jax.tree.map(lambda a: a[bad], d64)
        fin = palm_finish_np(sub, x64[bad], y64[bad], eps_abs=eps,
                             eps_rel=eps)
        pol2 = polish_batch_np(sub, fin.x, fin.y, eps_abs=eps, eps_rel=eps,
                               rounds=1, refine_steps=0)
        ok[bad] = np.asarray(pol2.ok)
        x64[bad] = np.asarray(pol2.x)
        y64[bad] = np.asarray(pol2.y)
        obj[bad] = np.asarray(pol2.objective)
    t_polish = time.perf_counter() - t0

    return LargeResult(
        x=x64, y=y64, ok=ok, status=np.asarray(res.status),
        iterations=np.asarray(res.iterations), objective=obj,
        t_device_s=t_device, t_polish_s=t_polish,
    )
