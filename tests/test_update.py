"""Parametric update + re-solve paths (reference: tests/src/test_update.c,
qpalm_update_settings/bounds/q at qpalm.c:739-871)."""

import numpy as np
import pytest

import qpalm_jax
from qpalm_jax import QPALM, Settings
from qpalm_jax.validate import ValidationError

from helpers import kkt_check, random_convex_qp

S = Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False)


@pytest.fixture
def solver():
    Q, A, q, bmin, bmax = random_convex_qp(5, 8, seed=4)
    return QPALM(Q, A, q, bmin, bmax, settings=S), (Q, A, q, bmin, bmax)


def test_update_bounds_resolve(solver):
    s, (Q, A, q, bmin, bmax) = solver
    r1 = s.solve()
    assert r1.info.status == "solved"
    bmin2, bmax2 = 2 * bmin, 2 * bmax
    s.update_bounds(bmin2, bmax2)
    s.warm_start(r1.solution.x, r1.solution.y)
    r2 = s.solve()
    assert r2.info.status == "solved"
    kkt_check(Q, A, q, bmin2, bmax2, r2.solution.x, r2.solution.y, tol=1e-4)


def test_update_q_resolve(solver):
    s, (Q, A, q, bmin, bmax) = solver
    r1 = s.solve()
    q2 = -q
    s.update_q(q2)
    s.warm_start(r1.solution.x, r1.solution.y)
    r2 = s.solve()
    assert r2.info.status == "solved"
    kkt_check(Q, A, q2, bmin, bmax, r2.solution.x, r2.solution.y, tol=1e-4)


def test_update_settings_tightening(solver):
    s, (Q, A, q, bmin, bmax) = solver
    r1 = s.solve()
    s.update_settings(S.replace(eps_abs=1e-8, eps_rel=1e-8))
    s.warm_start(r1.solution.x, r1.solution.y)
    r2 = s.solve()
    assert r2.info.status == "solved"
    assert float(r2.info.dua_res_norm) <= 1e-7


def test_update_settings_scaling_decrease_rejected(solver):
    s, _ = solver
    with pytest.raises(ValueError):
        s.update_settings(S.replace(scaling=max(S.scaling - 1, 0)))


def test_update_bounds_validation(solver):
    s, (_, _, _, bmin, bmax) = solver
    with pytest.raises(ValueError):
        s.update_bounds(np.full_like(bmin, 2.0), np.full_like(bmax, 1.0))
    with pytest.raises(ValueError):
        s.update_bounds(bmin[:-1], None)


def test_update_q_validation(solver):
    s, _ = solver
    with pytest.raises(ValueError):
        s.update_q(np.zeros(3))


def test_updates_match_fresh_setup(solver):
    """An updated solver must agree with a freshly constructed one
    (reference test_update.c semantics)."""
    s, (Q, A, q, bmin, bmax) = solver
    s.solve()
    q2 = q + 0.5
    bmax2 = bmax + 1.0
    s.update_q(q2)
    s.update_bounds(bmin, bmax2)
    r_upd = s.solve()
    r_fresh = QPALM(Q, A, q2, bmin, bmax2, settings=S).solve()
    np.testing.assert_allclose(
        r_upd.solution.x, r_fresh.solution.x, rtol=1e-5, atol=1e-7
    )
