"""Batched (vmap) and sharded (mesh) solves must match sequential solves —
the multi-chip tests the reference lacks (SURVEY.md §4 implication (e))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import qpalm_jax
from qpalm_jax import Settings
from qpalm_jax.batch import solve_batch, solve_batch_jit, stack_problems
from qpalm_jax.parallel import (
    default_mesh,
    pad_batch_to_devices,
    solve_batch_sharded,
    solve_constraint_sharded,
)
from qpalm_jax.types import QPData
from qpalm_jax.api import pad_problem

from helpers import kkt_check, random_convex_qp

SETTINGS = Settings(eps_abs=1e-6, eps_rel=1e-6)


def _problems(k, n=6, m=9, seed0=0):
    return [random_convex_qp(n, m, seed=seed0 + i) for i in range(k)]


def test_batch_matches_sequential():
    probs = _problems(6)
    res = solve_batch(probs, SETTINGS)
    assert np.all(np.asarray(res.status) == qpalm_jax.QPALM_SOLVED)
    for i, (Q, A, q, bmin, bmax) in enumerate(probs):
        r = qpalm_jax.solve(Q, A, q, bmin, bmax, settings=SETTINGS)
        # identical compiled math => bit-identical iterates
        np.testing.assert_array_equal(
            np.asarray(res.x)[i][: Q.shape[0]], r.solution.x
        )
        kkt_check(Q, A, q, bmin, bmax, np.asarray(res.x)[i][: Q.shape[0]],
                  np.asarray(res.y)[i][: A.shape[0]])


def test_batch_warm_start():
    probs = _problems(4)
    res = solve_batch(probs, SETTINGS)
    xs = [np.asarray(res.x)[i][:6] for i in range(4)]
    ys = [np.asarray(res.y)[i][:9] for i in range(4)]
    res2 = solve_batch(probs, SETTINGS, x0=xs, y0=ys)
    # warm-started resolves stay under the reference's <12-iteration anchor
    # (reference: tests/src/test_basic_qp.c:202) and match the single-solve
    # path bit-for-bit (0 iters is problem-dependent, not guaranteed)
    assert np.all(np.asarray(res2.status) == qpalm_jax.QPALM_SOLVED)
    assert np.all(np.asarray(res2.iterations) < 12)
    r = qpalm_jax.solve(*probs[1], settings=SETTINGS, x0=xs[1], y0=ys[1])
    assert int(r.info.iter) == int(np.asarray(res2.iterations)[1])


def test_batch_nonconvex():
    rng = np.random.default_rng(3)
    probs = []
    for i in range(3):
        n = 5
        Q = rng.standard_normal((n, n))
        Q = 0.5 * (Q + Q.T) - 1.5 * np.eye(n)  # indefinite
        A = np.eye(n)
        probs.append((Q, A, rng.standard_normal(n), -np.ones(n), np.ones(n)))
    res = solve_batch(probs, Settings(nonconvex=True, eps_abs=1e-6, eps_rel=1e-6))
    assert np.all(np.asarray(res.status) == qpalm_jax.QPALM_SOLVED)
    # stationarity of each solution on the box
    for i, (Q, A, q, bmin, bmax) in enumerate(probs):
        x = np.asarray(res.x)[i][:5]
        g = Q @ x + q
        for j in range(5):
            if x[j] < bmax[j] - 1e-5 and x[j] > bmin[j] + 1e-5:
                assert abs(g[j]) < 1e-4


def test_sharded_batch_matches_vmap():
    probs = _problems(16)
    data = stack_problems(probs, np.float64)
    B, n_pad = data.q.shape
    m_pad = data.bmin.shape[1]
    x_ws = jnp.zeros((B, n_pad))
    y_ws = jnp.zeros((B, m_pad))
    gamma = jnp.full((B,), SETTINGS.gamma_init)
    mesh = default_mesh()
    res, agg = solve_batch_sharded(
        data, x_ws, y_ws, gamma, SETTINGS, False, False, mesh, "qp"
    )
    ref = solve_batch_jit(data, x_ws, y_ws, gamma, SETTINGS, False, False)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))
    assert int(agg["n_solved"]) == 16
    assert int(agg["total_iters"]) == int(np.asarray(ref.iterations).sum())


def test_pad_batch_to_devices():
    probs = _problems(5)
    data = stack_problems(probs, np.float64)
    data2, mask = pad_batch_to_devices(data, 8)
    assert data2.q.shape[0] == 8 and mask.sum() == 5
    B, n_pad = data2.q.shape
    m_pad = data2.bmin.shape[1]
    res = solve_batch_jit(
        data2, jnp.zeros((B, n_pad)), jnp.zeros((B, m_pad)),
        jnp.full((B,), SETTINGS.gamma_init), SETTINGS, False, False,
    )
    # dummy problems solve trivially; real ones match their solo solves
    assert np.all(np.asarray(res.status) == qpalm_jax.QPALM_SOLVED)


def test_constraint_sharded_matches_single():
    n, m = 12, 16
    Q, A, q, bmin, bmax = random_convex_qp(n, m, seed=11)
    Qp, Ap, qp, bl, bu = pad_problem(Q, A, q, bmin, bmax, 16, 16, np.float64)
    d1 = QPData(
        Q=jnp.asarray(Qp), A=jnp.asarray(Ap), q=jnp.asarray(qp),
        bmin=jnp.asarray(bl), bmax=jnp.asarray(bu), c=jnp.zeros(()),
    )
    mesh = default_mesh()
    x, y, status, iters, obj = solve_constraint_sharded(d1, SETTINGS, mesh, "qp")
    r = qpalm_jax.solve(Q, A, q, bmin, bmax, settings=SETTINGS)
    assert int(status) == qpalm_jax.QPALM_SOLVED
    np.testing.assert_allclose(np.asarray(x)[:n], r.solution.x, atol=1e-9)


def test_graft_entry():
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert np.all(np.asarray(out[1]) == qpalm_jax.QPALM_SOLVED)
    g.dryrun_multichip(8)


def test_solve_many_heterogeneous():
    """solve_many buckets heterogeneous shapes, one compile per bucket,
    results scattered back to input order."""
    from qpalm_jax.batch import solve_many

    sizes = [(6, 9), (12, 16), (6, 9), (12, 16), (6, 9)]
    probs = [random_convex_qp(n, m, seed=i) for i, (n, m) in enumerate(sizes)]
    res = solve_many(probs, SETTINGS)
    assert np.all(np.asarray(res.status) == qpalm_jax.QPALM_SOLVED)
    # typed rectangular contract: real 2-D arrays padded to the largest
    # bucket, with true sizes carried per problem
    assert isinstance(res.x, np.ndarray) and res.x.ndim == 2
    assert isinstance(res.y, np.ndarray) and res.y.ndim == 2
    assert list(res.n) == [s[0] for s in sizes]
    assert list(res.m) == [s[1] for s in sizes]
    for i, p in enumerate(probs):
        n, m = sizes[i]
        kkt_check(*p, np.asarray(res.x[i])[:n], np.asarray(res.y[i])[:m],
                  tol=1e-4)
        # must agree with the solo solve (to ULP-level: batched XLA kernels
        # may round differently than batch-of-1)
        r = qpalm_jax.solve(*p, settings=SETTINGS)
        np.testing.assert_allclose(
            np.asarray(res.x[i])[:n], r.solution.x, atol=1e-12
        )


def test_batch_time_limit_and_histogram():
    """settings.time_limit is enforced for batch solves via host chunking
    (reference qpalm.c:680-708 semantics), and BatchResult exposes the
    per-lane iteration histogram (VERDICT r1 item 8)."""
    from qpalm_jax.batch import solve_batch

    probs = [random_convex_qp(12, 18, seed=300 + i) for i in range(6)]
    s = SETTINGS.replace(time_limit=60.0)
    r = solve_batch(probs, s)
    assert np.all(np.asarray(r.status) == qpalm_jax.QPALM_SOLVED)
    counts, edges = r.iteration_histogram(bins=4)
    assert counts.sum() == len(probs)
    # solutions must match the un-limited path
    r0 = solve_batch(probs, SETTINGS)
    np.testing.assert_allclose(np.asarray(r.x), np.asarray(r0.x), atol=1e-10)

    s2 = SETTINGS.replace(eps_abs=1e-14, eps_rel=0.0, max_iter=100000,
                          time_limit=0.1)
    r2 = solve_batch(probs, s2)
    st = np.asarray(r2.status)
    assert np.all((st == qpalm_jax.QPALM_TIME_LIMIT_REACHED)
                  | (st == qpalm_jax.QPALM_SOLVED))


def test_sharded_aggregate_false_matches():
    """aggregate=False returns device-local partials whose host reduction
    equals the collective aggregates (and identical solutions)."""
    probs = _problems(16)
    data = stack_problems(probs, np.float64)
    B, n_pad = data.q.shape
    m_pad = data.bmin.shape[1]
    x_ws = jnp.zeros((B, n_pad))
    y_ws = jnp.zeros((B, m_pad))
    gamma = jnp.full((B,), SETTINGS.gamma_init)
    mesh = default_mesh()
    res, agg = solve_batch_sharded(
        data, x_ws, y_ws, gamma, SETTINGS, False, False, mesh, "qp"
    )
    res2, agg2 = solve_batch_sharded(
        data, x_ws, y_ws, gamma, SETTINGS, False, False, mesh, "qp",
        aggregate=False,
    )
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(res2.x))
    assert int(np.sum(np.asarray(agg2["n_solved"]))) == int(agg["n_solved"])
    assert (int(np.sum(np.asarray(agg2["total_iters"])))
            == int(agg["total_iters"]))
    assert (int(np.max(np.asarray(agg2["max_iters"])))
            == int(agg["max_iters"]))


# --- f32 vmapped batch vs per-problem solves ---------------------------------
#
# The vmapped XLA loop is the batched device path; each lane must do
# exactly what a per-problem solve of the same QP does: same status, same
# iteration count, the same solution to f32 rounding.  Any drift in branch
# logic, sigma/gamma schedules, certificates or the linesearch between the
# batched and the single-problem trace changes iteration counts at once.

_F32 = dict(dtype="float32", eps_abs=1e-4, eps_rel=1e-4, max_iter=100,
            scaling=2, max_refine=0, delta=10.0, verbose=False)


def _dense_probs(seed, n, m, count):
    return [random_convex_qp(n, m, seed=seed + i, density=0.5)
            for i in range(count)]


def _infeasible_probs():
    """Lane 0 primal infeasible, lane 1 dual infeasible, the rest
    ordinary solvable QPs."""
    n, m = 6, 8
    probs = _dense_probs(55, n, m, 8)
    A_p = np.zeros((m, n))
    A_p[0, 0] = A_p[1, 0] = 1.0
    bl_p, bu_p = np.full(m, -20.0), np.full(m, 20.0)
    bl_p[0], bu_p[0] = 1.0, 30.0   # x0 >= 1
    bl_p[1], bu_p[1] = -30.0, 0.0  # x0 <= 0
    probs[0] = (np.eye(n), A_p, np.zeros(n), bl_p, bu_p)
    probs[1] = (np.zeros((n, n)), np.zeros((m, n)), -np.ones(n),
                np.full(m, -np.inf), np.full(m, np.inf))
    return probs


def _nonconvex_probs():
    """Half the lanes indefinite (gamma pinned per lane), half convex."""
    rng = np.random.default_rng(42)
    n = m = 8
    probs = []
    for i in range(8):
        if i % 2 == 0:
            Q = rng.standard_normal((n, n))
            Q = 0.5 * (Q + Q.T) - 1.5 * np.eye(n)
        else:
            M = rng.standard_normal((n, n))
            Q = M @ M.T + 0.1 * np.eye(n)
        probs.append((Q, np.eye(m, n), rng.standard_normal(n),
                      -np.ones(m), np.ones(m)))
    return probs


def _expect_statuses(*codes):
    def check(status, iters):
        assert set(np.unique(status)) == set(codes), status
    return check


def _expect_max_iter(status, iters):
    assert np.all(status == qpalm_jax.QPALM_MAX_ITER_REACHED)
    assert np.all(iters == 7)


# name -> (problems, settings overrides, warm start?, extra check)
_PARITY_CASES = {
    "scaling2": (lambda: _dense_probs(60, 16, 24, 8), {}, False,
                 _expect_statuses(1)),
    "scaling0": (lambda: _dense_probs(60, 16, 24, 8), dict(scaling=0),
                 False, _expect_statuses(1)),
    "warm_start": (lambda: _dense_probs(70, 12, 18, 8), {}, True,
                   _expect_statuses(1)),
    "max_iter": (lambda: _dense_probs(80, 8, 12, 8),
                 dict(eps_abs=1e-12, eps_rel=0.0, max_iter=7), False,
                 _expect_max_iter),
    "infeasible": (_infeasible_probs, dict(max_iter=150), False,
                   lambda st, it: (
                       st[0] == qpalm_jax.QPALM_PRIMAL_INFEASIBLE
                       and st[1] == qpalm_jax.QPALM_DUAL_INFEASIBLE
                       and np.all(st[2:] == qpalm_jax.QPALM_SOLVED))
                   or pytest.fail(f"statuses {st}")),
    "nonconvex": (_nonconvex_probs, dict(nonconvex=True, max_iter=400),
                  False, _expect_statuses(1)),
    "dual_termination": (lambda: _dense_probs(90, 16, 24, 16),
                         dict(enable_dual_termination=True,
                              dual_objective_limit=-1.0), False,
                         _expect_statuses(qpalm_jax.QPALM_SOLVED,
                                          qpalm_jax.QPALM_DUAL_TERMINATED)),
    "stall": (lambda: _dense_probs(40, 14, 20, 8),
              dict(eps_abs=5e-4, eps_rel=5e-4, rho=1e-8), False,
              _expect_statuses(1)),
    "fuzz_7x13": (lambda: _dense_probs(591, 7, 13, 8), {}, False,
                  _expect_statuses(1)),
    "fuzz_24x8": (lambda: _dense_probs(692, 24, 8, 8), {}, False,
                  _expect_statuses(1)),
    "fuzz_9x33": (lambda: _dense_probs(797, 9, 33, 8), {}, False,
                  _expect_statuses(1)),
}


@pytest.mark.parametrize("case", sorted(_PARITY_CASES))
def test_f32_batch_matches_per_problem(case):
    make, overrides, warm, check = _PARITY_CASES[case]
    probs = make()
    s = Settings(**{**_F32, **overrides})
    x0 = y0 = None
    if warm:
        cold = solve_batch(probs, s)
        x0 = [np.asarray(cold.x)[i][: p[0].shape[0]]
              for i, p in enumerate(probs)]
        y0 = [np.asarray(cold.y)[i][: p[1].shape[0]]
              for i, p in enumerate(probs)]
    res = solve_batch(probs, s, x0=x0, y0=y0)
    status = np.asarray(res.status)
    iters = np.asarray(res.iterations)
    for i, p in enumerate(probs):
        r = qpalm_jax.solve(*p, settings=s,
                            x0=None if x0 is None else x0[i],
                            y0=None if y0 is None else y0[i])
        assert int(r.info.status_val) == status[i], (i, status[i])
        assert int(r.info.iter) == iters[i], (i, iters[i])
        if status[i] == qpalm_jax.QPALM_SOLVED:
            np.testing.assert_allclose(
                np.asarray(res.x)[i][: p[0].shape[0]], r.solution.x,
                atol=1e-4)
    check(status, iters)
    if warm:
        assert iters.max() < np.asarray(cold.iterations).max()
