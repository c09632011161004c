"""Active-set polish: f32 solutions upgraded to 1e-6 KKT accuracy in f64.

The polish is the accuracy half of the headline bench protocol (f32 device pass
+ f64 polish), so its claims are tested against an independent
high-accuracy f64 solve, not against itself.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qpalm_jax import QPALM, Settings, constants as C
from qpalm_jax.batch import solve_batch_jit, stack_problems
from qpalm_jax.polish import polish_batch, polish_batch_np

from helpers import random_convex_qp


def _solve_f32_batch(probs, eps=2e-5):
    s32 = Settings(dtype="float32", eps_abs=eps, eps_rel=eps, max_iter=200,
                   scaling=2, max_refine=0, delta=10.0)
    d32 = stack_problems(probs, np.float32)
    B, n_pad = d32.q.shape
    m_pad = d32.bmin.shape[1]
    res = solve_batch_jit(
        d32,
        jnp.zeros((B, n_pad), jnp.float32),
        jnp.zeros((B, m_pad), jnp.float32),
        jnp.full((B,), s32.gamma_init, jnp.float32),
        s32, False, False,
    )
    return res


def test_polish_reaches_1e6_and_matches_reference_solve():
    probs = [random_convex_qp(24, 36, seed=100 + i, density=0.5)
             for i in range(16)]
    r32 = _solve_f32_batch(probs)
    d64 = stack_problems(probs, np.float64)
    pr = polish_batch(d64, r32.x, r32.y)
    ok = np.asarray(pr.ok)
    assert ok.all(), f"polish failed lanes {np.where(~ok)[0]}"
    # polished residuals certify eps 1e-6 (they are what `ok` asserts)
    assert np.asarray(pr.dua_res).max() < 1e-5

    s64 = Settings(eps_abs=1e-10, eps_rel=1e-10, verbose=False)
    for i in range(4):
        Q, A, q, bl, bu = probs[i]
        ref = QPALM(Q=Q, A=A, q=q, bmin=bl, bmax=bu, settings=s64).solve()
        xt = np.asarray(ref.solution.x)
        xp = np.asarray(pr.x)[i][: len(xt)]
        assert np.max(np.abs(xp - xt)) < 1e-7


@pytest.mark.parametrize("rounds,refine_steps", [(1, 0), (2, 2)])
def test_np_matches_jax(rounds, refine_steps):
    # the threaded numpy twin must reproduce the jitted jax polish exactly
    # (same active-set rules, same LAPACK solves) — the bench relies on it
    probs = [random_convex_qp(24, 36, seed=300 + i, density=0.5)
             for i in range(13)]  # odd count: uneven thread chunks
    r32 = _solve_f32_batch(probs)
    d64 = stack_problems(probs, np.float64)
    pj = polish_batch(d64, r32.x, r32.y, rounds=rounds,
                      refine_steps=refine_steps)
    pn = polish_batch_np(
        jax.tree.map(np.asarray, d64), np.asarray(r32.x),
        np.asarray(r32.y), rounds=rounds, refine_steps=refine_steps,
        threads=3, compress=False,
    )
    assert np.array_equal(np.asarray(pj.ok), np.asarray(pn.ok))
    np.testing.assert_allclose(np.asarray(pj.x), pn.x, atol=1e-10, rtol=0)
    np.testing.assert_allclose(np.asarray(pj.y), pn.y, atol=1e-9, rtol=0)
    np.testing.assert_allclose(np.asarray(pj.pri_res), pn.pri_res,
                               atol=1e-12, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(pj.dua_res), pn.dua_res,
                               atol=1e-12, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(pj.objective), pn.objective,
                               rtol=1e-10)


def test_polish_flags_unconverged_inputs():
    # feed the polish a garbage "solution": it must not report ok
    rng = np.random.default_rng(3)
    probs = [random_convex_qp(16, 24, seed=200 + i) for i in range(4)]
    d64 = stack_problems(probs, np.float64)
    B, n_pad = d64.q.shape
    m_pad = d64.bmin.shape[1]
    x_bad = jnp.asarray(rng.standard_normal((B, n_pad)) * 100.0)
    y_bad = jnp.zeros((B, m_pad))
    pr = polish_batch(d64, x_bad, y_bad)
    # from a random far point the detected active set is wrong; the KKT
    # check must catch any lane that did not land at a true solution
    viol = np.maximum(np.asarray(pr.pri_res), 0)
    ok = np.asarray(pr.ok)
    for i in range(B):
        if ok[i]:
            assert viol[i] < 1e-5  # ok lanes really are solutions


def test_polish_handles_equalities_and_narrow_ranges():
    # equality rows (bmin == bmax) and a narrow-range row whose optimum
    # side the polish must pick correctly (the act_tol=eq bug class)
    n, m = 12, 8
    Q, A, q, _, _ = random_convex_qp(n, m, seed=5)
    bmin = -0.5 * np.ones(m)
    bmax = 0.5 * np.ones(m)
    bmin[0] = bmax[0] = 0.3  # equality
    bmin[1], bmax[1] = -2e-5, 3e-5  # narrow range, within act_tol
    s = Settings(eps_abs=1e-10, eps_rel=1e-10, verbose=False)
    ref = QPALM(Q=Q, A=A, q=q, bmin=bmin, bmax=bmax, settings=s).solve()
    assert ref.info.status_val == C.QPALM_SOLVED

    probs = [(Q, A, q, bmin, bmax)]
    r32 = _solve_f32_batch(probs, eps=1e-4)
    d64 = stack_problems(probs, np.float64)
    pr = polish_batch(d64, r32.x, r32.y)
    assert bool(np.asarray(pr.ok)[0])
    xt = np.asarray(ref.solution.x)
    assert np.max(np.abs(np.asarray(pr.x)[0][:n] - xt)) < 1e-6


def test_compressed_matches_full():
    """compress=True removes the decoupled identity rows of the KKT system
    (inactive constraints) behind a symmetric permutation — the solution is
    identical up to LU rounding.  Must agree with the full solve on random
    problems and on the edge cases: all-inactive, all-active, equalities."""
    probs = [random_convex_qp(24, 36, seed=400 + i, density=0.5)
             for i in range(9)]
    # edge: box so wide nothing is active
    Q, A, q, _, _ = random_convex_qp(24, 36, seed=450)
    probs.append((Q, A, q, -1e4 * np.ones(36), 1e4 * np.ones(36)))
    # edge: equalities force every row active
    Q, A, q, _, _ = random_convex_qp(24, 24, seed=451)
    b = 0.01 * np.arange(24.0)
    probs.append((Q, A, q, b, b))
    r32 = _solve_f32_batch(probs, eps=1e-4)
    d64 = jax.tree.map(np.asarray, stack_problems(probs, np.float64))
    x32, y32 = np.asarray(r32.x), np.asarray(r32.y)
    pf = polish_batch_np(d64, x32, y32, rounds=2, compress=False, threads=2)
    pc = polish_batch_np(d64, x32, y32, rounds=2, compress=True, threads=2)
    assert np.array_equal(np.asarray(pf.ok), np.asarray(pc.ok))
    np.testing.assert_allclose(pc.x, pf.x, atol=1e-8, rtol=0)
    np.testing.assert_allclose(pc.y, pf.y, atol=1e-8, rtol=0)
    np.testing.assert_allclose(pc.objective, pf.objective, rtol=1e-9)


def test_device_polish_matches_np():
    """polish_batch_device (the on-device certification pipeline) must agree
    with the host polish: same certified-lane classification on the lanes
    both certify, and matching solutions there.  Runs the f64-residual
    mode AND the residual32 mode (f32 'highest' residuals + margin-gated
    acceptance) — on CPU both modes' f32 matmuls are true f32, which is
    also what 'highest' delivers on a GPU."""
    from qpalm_jax.polish_device import polish_batch_device

    probs = [random_convex_qp(24, 36, seed=500 + i, density=0.5)
             for i in range(32)]
    r32 = _solve_f32_batch(probs, eps=5e-5)
    d64 = jax.tree.map(np.asarray, stack_problems(probs, np.float64))
    x32, y32 = np.asarray(r32.x), np.asarray(r32.y)
    pn = polish_batch_np(d64, x32, y32, rounds=1, refine_steps=0)
    ok_np = np.asarray(pn.ok)
    d64j = jax.tree.map(jnp.asarray, d64)
    for kw in (
        dict(seed_guard="norm", refine_iters=3, second_round_k=8),
        dict(seed_guard="norm", refine_iters=3, second_round_k=8,
             residual32=True, accept_viol=0.5),
        dict(seed_guard=True, refine_iters=4),
    ):
        pd = polish_batch_device(d64j, jnp.asarray(x32), jnp.asarray(y32),
                              **kw)
        ok_dev = np.asarray(pd.ok)
        # the device polish may certify a superset or subset on knife-edge
        # lanes, but must agree on at least ~90% and never mis-certify:
        # every device-ok lane must pass the independent host KKT check
        both = ok_dev & ok_np
        assert both.sum() >= int(0.9 * len(probs)), (kw, both.sum())
        chk = polish_batch_np(
            jax.tree.map(lambda a: a[ok_dev], d64),
            np.asarray(pd.x)[ok_dev], np.asarray(pd.y)[ok_dev],
            rounds=0,
        )
        assert np.asarray(chk.ok).all(), kw
        dx = np.max(np.abs(np.asarray(pd.x)[both] - np.asarray(pn.x)[both]))
        assert dx < 1e-5, (kw, dx)


def test_device_polish_rank_deficient_active_set():
    """The primal form P = Q + A_act'A_act/dh stays SPD under redundant
    (rank-deficient) active rows, where the host KKT LU can go singular —
    the device polish must still solve and certify."""
    from qpalm_jax.polish_device import polish_batch_device

    rng = np.random.default_rng(3)
    n, m = 12, 18
    M = rng.standard_normal((n, n))
    Q = M @ M.T + 0.5 * np.eye(n)
    A1 = rng.standard_normal((m // 2, n))
    A = np.vstack([A1, A1])  # duplicated rows: any active set is deficient
    q = rng.standard_normal(n)
    b = A @ rng.standard_normal(n)
    bmin, bmax = b - 0.1, np.tile(b[: m // 2] + 0.05, 2)  # upper binds
    probs = [(Q, A, q, np.minimum(bmin, bmax - 0.01), bmax)]
    r32 = _solve_f32_batch(probs, eps=5e-5)
    d64 = jax.tree.map(np.asarray, stack_problems(probs, np.float64))
    d64j = jax.tree.map(jnp.asarray, d64)
    pd = polish_batch_device(d64j, jnp.asarray(np.asarray(r32.x)),
                          jnp.asarray(np.asarray(r32.y)),
                          seed_guard="norm", refine_iters=6)
    assert np.isfinite(np.asarray(pd.x)).all()
    chk = polish_batch_np(d64, np.asarray(pd.x), np.asarray(pd.y),
                          rounds=0)
    ok_dev = np.asarray(pd.ok)
    if ok_dev[0]:
        assert bool(np.asarray(chk.ok)[0])
