"""Host f64 finisher (qpalm_jax.finish_np): the tail-rescue loop for lanes
whose f32 solution defeats the active-set polish.

Claims tested against independent oracles: the f64 reference solver's
solutions and the polish module's full KKT check — never the finisher's own
termination flag alone.
"""

import numpy as np
import jax
import pytest

from qpalm_jax import QPALM, Settings, constants as C
from qpalm_jax.batch import stack_problems
from qpalm_jax.finish_np import palm_finish_np
from qpalm_jax.polish import polish_batch_np

from helpers import random_convex_qp
from test_polish import _solve_f32_batch


def _host64(probs):
    return jax.tree.map(np.asarray, stack_problems(probs, np.float64))


def test_cold_start_matches_reference_solver():
    probs = [random_convex_qp(24, 36, seed=500 + i, density=0.5)
             for i in range(8)]
    d64 = _host64(probs)
    B, n = d64.q.shape
    m = d64.bmin.shape[1]
    r = palm_finish_np(d64, np.zeros((B, n)), np.zeros((B, m)))
    assert (r.status == C.QPALM_SOLVED).all()
    s64 = Settings(eps_abs=1e-10, eps_rel=1e-10, verbose=False)
    for i in range(4):
        Q, A, q, bl, bu = probs[i]
        ref = QPALM(Q=Q, A=A, q=q, bmin=bl, bmax=bu, settings=s64).solve()
        xt = np.asarray(ref.solution.x)
        assert np.max(np.abs(r.x[i][: len(xt)] - xt)) < 1e-5


def test_warm_start_from_f32_certifies_at_1e6():
    # the bench scenario: a cheap f32 pass seeds the finisher; every lane
    # must come out certifiable by the polish KKT check at 1e-6
    probs = [random_convex_qp(32, 48, seed=600 + i, density=0.5)
             for i in range(12)]
    r32 = _solve_f32_batch(probs, eps=1e-4)
    d64 = _host64(probs)
    r = palm_finish_np(d64, np.asarray(r32.x), np.asarray(r32.y))
    assert (r.status == C.QPALM_SOLVED).all()
    # warm start should finish far inside the cold-start budget
    assert r.iterations.max() < 200
    pol = polish_batch_np(d64, r.x, r.y, eps_abs=1e-6, eps_rel=1e-6,
                          rounds=1, refine_steps=0, threads=2)
    assert np.asarray(pol.ok).all()


def test_equalities_and_infinite_bounds():
    # equality rows (bmin == bmax) and fully-free rows (+-inf) exercise the
    # breakpoint clamping; padded stacking adds huge-bound inactive rows
    rng = np.random.default_rng(11)
    n, m = 12, 18
    Q, A, q, _, _ = random_convex_qp(n, m, seed=700)
    b = 0.1 * rng.standard_normal(m)
    bmin, bmax = b - 0.5, b + 0.5
    bmin[:4] = bmax[:4]                     # equalities
    bmin[4:6] = -np.inf
    bmax[6:8] = np.inf
    probs = [(Q, A, q, bmin, bmax),
             random_convex_qp(10, 14, seed=701)]  # ragged: forces padding
    d64 = _host64(probs)
    B, npad = d64.q.shape
    mpad = d64.bmin.shape[1]
    r = palm_finish_np(d64, np.zeros((B, npad)), np.zeros((B, mpad)))
    assert (r.status == C.QPALM_SOLVED).all()
    assert np.all(np.isfinite(r.x)) and np.all(np.isfinite(r.y))
    Ax = A @ r.x[0][:n]
    np.testing.assert_allclose(Ax[:4], bmax[:4], atol=1e-6)
    pol = polish_batch_np(d64, r.x, r.y, eps_abs=1e-6, eps_rel=1e-6,
                          rounds=1, refine_steps=0, threads=1)
    assert np.asarray(pol.ok).all()


def test_unsolved_lane_reports_max_iter():
    Q, A, q, bl, bu = random_convex_qp(16, 24, seed=800)
    d64 = _host64([(Q, A, q, bl, bu)])
    r = palm_finish_np(d64, np.zeros((1, 16)), np.zeros((1, 24)),
                       max_iter=2)
    assert r.status[0] == C.QPALM_MAX_ITER_REACHED
    assert r.iterations[0] == 2


def test_finisher_sanitizes_nonfinite_warm_start():
    """A lane whose f32 pass NaN'd (ill-conditioned lasso at f32 — the
    pipeline's designed failure mode) must be cold-started by the
    finisher, not poisoned: with the NaN warm start zeroed per-lane the
    finisher solves it, and healthy lanes keep their warm starts."""
    import jax
    import numpy as np

    from qpalm_jax.batch import stack_problems
    from qpalm_jax.finish_np import palm_finish_np
    from qpalm_jax.polish import polish_batch_np
    from qpalm_jax.workloads import lasso

    probs = [lasso(20, seed=60 + i) for i in (21, 165, 0)]
    d64 = jax.tree.map(np.asarray, stack_problems(probs, np.float64))
    B, npad = d64.q.shape
    mpad = d64.bmin.shape[1]
    x0 = np.zeros((B, npad))
    y0 = np.zeros((B, mpad))
    x0[0] = np.nan          # poisoned lane
    y0[1, 3] = np.inf       # poisoned lane (single entry suffices)
    fin = palm_finish_np(d64, x0, y0, eps_abs=1e-6, eps_rel=1e-6)
    pol = polish_batch_np(d64, fin.x, fin.y, eps_abs=1e-6, eps_rel=1e-6,
                          rounds=1, refine_steps=0)
    assert np.asarray(pol.ok).all(), np.asarray(pol.ok)
