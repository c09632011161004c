"""Reference-binding compat shim + checkpoint/resume utilities."""

import numpy as np
import scipy.sparse as sp

import qpalm_jax
from qpalm_jax import Settings, solve
from qpalm_jax.checkpoint import load_batch, load_solution, save_batch, save_solution
from qpalm_jax.compat import Qpalm

from helpers import random_convex_qp


def test_compat_reference_python_demo():
    """The reference python demo flow (interfaces/python/qpalm_python_demo.py)
    through the compat shim, including its asserted solution and the
    0-iteration warm-started resolve."""
    solver = Qpalm()
    solver._settings.contents.eps_abs = 1e-10
    solver._settings.contents.eps_rel = 1e-10
    solver._settings.contents.verbose = False
    Q = sp.csc_matrix(
        (np.array([1.0, -1.0, -1.0, 2.0]),
         (np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1]))),
        shape=(3, 3),
    )
    A = sp.csc_matrix(
        (np.ones(6),
         (np.array([0, 1, 0, 2, 0, 3]), np.array([0, 0, 1, 1, 2, 2]))),
        shape=(4, 3),
    )
    solver.set_data(Q=Q, A=A, q=np.array([-2.0, -6.0, 1.0]),
                    bmin=np.array([0.5, -10.0, -10.0, -10.0]),
                    bmax=np.array([0.5, 10.0, 10.0, 10.0]))
    solver._solve()
    x = solver._work.solution.x
    assert abs(x[0] - 5.5) < 1e-5
    assert abs(x[1] - 5.0) < 1e-5
    assert abs(x[2] + 10.0) < 1e-5
    solver._warm_start(solver._work.solution.x, solver._work.solution.y)
    solver._solve()
    assert int(solver._work.info.iter) == 0
    # update paths
    solver._update_q(np.array([0.0, -3.0, 2.0]))
    solver._update_bounds(np.array([0.4, -12.0, -12.0, -12.0]),
                          np.array([0.6, 12.0, 12.0, 12.0]))
    solver._solve()
    assert solver._work.info.status == "solved"


def test_checkpoint_roundtrip(tmp_path):
    prob = random_convex_qp(5, 7, seed=9)
    s = Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False)
    res = solve(*prob, settings=s)
    p = str(tmp_path / "ck")
    save_solution(p, res)
    x, y, meta = load_solution(p)
    np.testing.assert_array_equal(x, res.solution.x)
    assert meta["status"] == qpalm_jax.QPALM_SOLVED
    # resume: warm start from the checkpoint solves immediately-ish
    r2 = solve(*prob, settings=s, x0=x, y0=y)
    assert int(r2.info.iter) < 12


def test_batch_checkpoint_roundtrip(tmp_path):
    from qpalm_jax.batch import solve_batch

    probs = [random_convex_qp(5, 7, seed=i) for i in range(3)]
    res = solve_batch(probs, Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False))
    p = str(tmp_path / "batch")
    save_batch(p, res)
    d = load_batch(p)
    np.testing.assert_array_equal(d["x"], np.asarray(res.x))
    assert d["status"].tolist() == [1, 1, 1]
