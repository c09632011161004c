"""Slow (nightly-tier) Maros-Meszaros L-scale lock-in tests (VERDICT r4
weak #6): the n >= 1e4 results in benchmarks/RESULTS_maros.md were bench
artifacts that could silently rot — these tests parse the committed QPS
files through the real reader and solve them through the auto-routed host
path under the MM protocol, asserting the published optimum (CVXQP2_L)
and an independent f64 KKT certificate (both).

Run with `pytest -m slow` (or `make test-slow`); the default suite
excludes them (pyproject addopts -m 'not slow').  Runtime ~1 min.
"""

import os

import numpy as np
import pytest

from qpalm_jax import Settings
from qpalm_jax.host_sparse import solve_sparse_auto
from qpalm_jax.io import load_qps

_MM_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "qps_mm")

pytestmark = pytest.mark.slow


def _solve_mm(fname):
    p = load_qps(os.path.join(_MM_DIR, fname))
    s = Settings(eps_abs=1e-6, eps_rel=1e-6, scaling=10, max_iter=50000,
                 verbose=False)
    r = solve_sparse_auto(p.Q, p.A, p.q, p.bmin, p.bmax, settings=s, c=p.c)
    return p, r


def _assert_kkt(p, r, eps=1e-6):
    x, y = r.x, r.y
    Ax = p.A @ x
    z = np.clip(Ax, p.bmin, p.bmax)
    pri = np.max(np.abs(Ax - z), initial=0.0)
    Qx = p.Q @ x
    Aty = p.A.T @ y
    dua = np.max(np.abs(Qx + p.q + Aty))
    eps_pri = eps + eps * max(np.max(np.abs(Ax), initial=0.0),
                              np.max(np.abs(z), initial=0.0))
    eps_dua = eps + eps * max(np.max(np.abs(Qx)), np.max(np.abs(p.q)),
                              np.max(np.abs(Aty)))
    assert pri <= eps_pri, (pri, eps_pri)
    assert dua <= eps_dua, (dua, eps_dua)


def test_cvxqp2_l_published_optimum():
    """CVXQP2_L (n=10,000): EXACT regenerated instance — the solved
    objective must reproduce the set's published optimum."""
    p, r = _solve_mm("CVXQP2_L.qps")
    assert p.n == 10000
    assert r.status == 1
    _assert_kkt(p, r)
    published = 8.1842458e07
    assert abs(r.objective - published) <= 1e-5 * published


def test_aug2d_a_certified():
    """AUG2D-A (n=20,200): class analogue at the published scale — must
    solve and pass the independent f64 KKT certificate."""
    p, r = _solve_mm("AUG2D-A.qps")
    assert p.n == 20200
    assert r.status == 1
    _assert_kkt(p, r)
    # lock the committed RESULTS_maros value against silent drift
    assert abs(r.objective - 1.167233e05) <= 1.0
