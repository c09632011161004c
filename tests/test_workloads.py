"""Benchmark workload families solve and pass the KKT oracle
(reference protocols: simulations/randomQP.m, lasso.m, portfolio.m,
chain80w.m)."""

import numpy as np

from qpalm_jax import Settings, solve
from qpalm_jax.workloads import (
    SequentialMPC,
    lasso,
    mpc_chain,
    portfolio,
    random_qp,
)

from helpers import kkt_check

SETTINGS = Settings(eps_abs=1e-6, eps_rel=1e-6)


def test_random_qp():
    prob = random_qp(30, 40, seed=1)
    r = solve(*prob, settings=SETTINGS)
    assert r.info.status == "solved"
    kkt_check(*prob, r.solution.x, r.solution.y, tol=1e-4)


def test_lasso():
    prob = lasso(10, seed=1)
    r = solve(*prob, settings=SETTINGS)
    assert r.info.status == "solved"
    kkt_check(*prob, r.solution.x, r.solution.y, tol=1e-4)


def test_portfolio():
    prob = portfolio(30, seed=1)
    r = solve(*prob, settings=SETTINGS)
    assert r.info.status == "solved"
    kkt_check(*prob, r.solution.x, r.solution.y, tol=1e-4)
    # the budget equality must hold
    n = 30
    assert abs(r.solution.x[:n].sum() - 1.0) < 1e-5


def test_mpc_chain_structure():
    H, A, q, bmin, bmax, meta = mpc_chain(4, 8, seed=0)
    nx, nu, N = meta["nx"], meta["nu"], meta["N"]
    assert H.shape[0] == N * (nx + nu)
    assert A.shape[0] == meta["m_eq"] + N * (nx + nu)
    # dynamics rows are equalities
    np.testing.assert_array_equal(bmin[: meta["m_eq"]], bmax[: meta["m_eq"]])


def test_sequential_mpc_warm_start_speedup():
    mpc = SequentialMPC(n_masses=4, horizon=8, seed=0)
    iters = mpc.run(8)
    # closed loop stays bounded and warm-started resolves get cheaper
    assert np.abs(mpc.x).max() < 4.0
    assert iters[-1] <= iters[0]
    assert max(iters[1:]) < 12 + iters[0]
