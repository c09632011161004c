"""Primal/dual infeasibility detection + certificates
(reference: tests/src/test_prim_inf_qp.c, test_dua_inf_qp.c — each run under
the 4 proximal x scaling combinations)."""

import numpy as np
import pytest

import qpalm_jax
from qpalm_jax import Settings, solve

COMBOS = [
    dict(proximal=True, scaling=2),
    dict(proximal=True, scaling=0),
    dict(proximal=False, scaling=2),
    dict(proximal=False, scaling=0),
]


@pytest.mark.parametrize("kw", COMBOS)
def test_primal_infeasible(kw):
    # x >= 1 and x <= 0 simultaneously: no feasible point
    Q = np.eye(1)
    A = np.array([[1.0], [1.0]])
    bmin = np.array([1.0, -1e30])
    bmax = np.array([1e30, 0.0])
    res = solve(Q, A, np.zeros(1), bmin, bmax,
                settings=Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False, **kw))
    assert res.info.status == "primal infeasible"
    dy = res.delta_y
    # certificate (reference termination.c:136-182): A'dy ~ 0 relative to
    # ||dy||, and the support function bmax'max(dy,0) + bmin'min(dy,0) < 0
    # over the finite bounds
    rel = float(np.abs(A.T @ dy).max()) / np.max(np.abs(dy))
    assert rel < 1e-5
    support = bmin[0] * max(dy[0], 0.0) + bmax[1] * min(dy[1], 0.0)
    assert support < 0 or (dy[0] < 0 and dy[1] > 0)
    assert dy[0] * dy[1] < 0  # opposite signs, as the geometry requires


@pytest.mark.parametrize("kw", COMBOS)
def test_dual_infeasible(kw):
    # the reference's own fixture (test_dua_inf_qp.c:23-60): Q = 1e-10 I
    # (tiny PD so the proximal-off Schur matrix stays factorizable), three
    # identical rows x1+x2 with finite bounds, objective descending along
    # the unconstrained direction (-1, 1) — iterates diverge along the
    # feasible ray and the delta_x certificate fires
    Q = 1e-10 * np.eye(2)
    A = np.ones((3, 2))
    q = np.array([1.0, -2.0])
    bmin = np.array([-5.0, -10.0, -20.0])
    bmax = np.array([5.0, 10.0, 20.0])
    res = solve(Q, A, q, bmin, bmax,
                settings=Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False, **kw))
    assert res.info.status == "dual infeasible"
    dx = res.delta_x
    # certificate: descent (q'dx < 0), negligible curvature, A dx bounded
    nrm = np.max(np.abs(dx))
    assert nrm > 0
    assert q @ (dx / nrm) < 0
    assert abs(np.sum(dx)) / nrm < 1e-4  # stays in null(A)


@pytest.mark.parametrize("kw", COMBOS)
def test_dual_infeasible_proximal_zero_hessian(kw):
    # exact-zero Hessian needs the proximal regularization to keep the
    # Newton system nonsingular — proximal combos only
    if not kw["proximal"]:
        pytest.skip("zero Hessian requires proximal regularization")
    Q = np.zeros((1, 1))
    A = np.zeros((1, 1))
    res = solve(Q, A, np.array([-1.0]), np.array([-1e30]), np.array([1e30]),
                settings=Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False, **kw))
    assert res.info.status == "dual infeasible"
    assert res.delta_x[0] > 0


def test_feasible_problem_not_flagged():
    rng = np.random.default_rng(0)
    M = rng.standard_normal((4, 4))
    Q = M @ M.T + 0.5 * np.eye(4)
    A = rng.standard_normal((6, 4))
    res = solve(Q, A, rng.standard_normal(4), -np.ones(6), np.ones(6),
                settings=Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False))
    assert res.info.status == "solved"
