"""Real Maros-Meszaros instances at the reference protocol.

The reference's headline validation is the Maros-Meszaros convex QP set at
eps 1e-6 (reference: simulations/maros_meszaros/test_maros_meszaros.m:43-106).
The corpus itself isn't fetchable in this environment, so
``benchmarks/maros/`` carries genuinely external instances transcribed from
the published formulations (Hock-Schittkowski problems as they appear in the
set, plus TAME), each validated here against the set's PUBLISHED optimal
objectives — a transcription error and a solver error are both caught by the
same assertion.

HS268 is the set's small ill-conditioned member (cond(Q) ~ 3.7e6): at
eps 1e-6 its KKT point sits 8.5e-4 above the optimum along the flat valley
(any 1e-6-KKT solver lands there); at eps 1e-9 the solve recovers the exact
published minimizer x* = (1, 2, -1, 3, -4), so it is checked at 1e-9.
"""

import glob
import os

import numpy as np
import pytest

from qpalm_jax import QPALM, Settings
from qpalm_jax.io.qps import load_qps_python

from helpers import kkt_check

MAROS_DIR = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                         "maros")

# published optimal objectives from the Maros-Meszaros set's table
PUBLISHED = {
    "HS21": (-9.9960000000e1, 1e-6),
    "HS35": (0.11111111111, 1e-6),
    "HS51": (0.0, 1e-6),
    "HS52": (5.3266475645, 1e-6),
    "HS53": (4.0930232558, 1e-6),
    "HS76": (-4.6818181818, 1e-6),
    "HS118": (664.82045, 1e-6),
    "HS268": (0.0, 1e-9),  # ill-conditioned: see module docstring
    "TAME": (0.0, 1e-6),
}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_maros_instance(name):
    fstar, eps = PUBLISHED[name]
    p = load_qps_python(os.path.join(MAROS_DIR, name + ".qps"))
    s = Settings(eps_abs=eps, eps_rel=eps, verbose=False, max_iter=2000)
    solver = QPALM(p.Q.toarray(), p.A.toarray(), p.q, p.bmin, p.bmax,
                   settings=s)
    res = solver.solve()
    assert res.info.status == "solved", (name, res.info.status)
    obj = float(res.info.objective) + p.c
    # the MM protocol's objective check: relative to max(1, |f*|)
    assert abs(obj - fstar) <= 2e-5 * max(1.0, abs(fstar)), (name, obj, fstar)
    kkt_check(p.Q.toarray(), p.A.toarray(), p.q, p.bmin, p.bmax,
              np.asarray(res.solution.x), np.asarray(res.solution.y),
              tol=max(eps * 100, 1e-5))


def test_maros_parsers_agree():
    """Differential test: the native C++ QPS reader and the python parser
    must produce identical problems on every real MM file."""
    from qpalm_jax.io import qps as qps_mod

    if not getattr(qps_mod, "native_available", lambda: True)():
        pytest.skip("native reader unavailable")
    from qpalm_jax.io.qps import load_qps

    for path in sorted(glob.glob(os.path.join(MAROS_DIR, "*.qps"))):
        pp = load_qps_python(path)
        try:
            pn = load_qps(path, native=True)
        except Exception:
            pytest.skip("native reader not built on this machine")
        np.testing.assert_allclose(pp.Q.toarray(), pn.Q.toarray(), atol=0,
                                   err_msg=path)
        np.testing.assert_allclose(pp.A.toarray(), pn.A.toarray(), atol=0,
                                   err_msg=path)
        np.testing.assert_allclose(pp.q, pn.q, atol=0, err_msg=path)
        np.testing.assert_allclose(pp.bmin, pn.bmin, atol=0, err_msg=path)
        np.testing.assert_allclose(pp.bmax, pn.bmax, atol=0, err_msg=path)
        assert pp.c == pn.c, path


MM_DIR = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                      "qps_mm")

# Published Maros-Meszaros optima for the algorithmically-defined CVXQP
# family (Calamai & More via CUTE).  The committed QPS files are generated
# by scripts/make_mm_suite.py; matching these optima validates BOTH the
# generator's exactness and the solve (a generator error and a solver
# error trip the same assertion).
CVXQP_PUBLISHED = {
    "CVXQP1_S": 1.1590718e4,
    "CVXQP2_S": 8.1209405e3,
    "CVXQP3_S": 1.1943432e4,
    "CVXQP1_M": 1.0875116e6,
    "CVXQP2_M": 8.2015543e5,
    "CVXQP3_M": 1.3628287e6,
}


@pytest.mark.parametrize("name", sorted(CVXQP_PUBLISHED))
def test_cvxqp_published_optimum(name):
    path = os.path.join(MM_DIR, name + ".qps")
    if not os.path.exists(path):
        pytest.skip("MM suite not generated (scripts/make_mm_suite.py)")
    fstar = CVXQP_PUBLISHED[name]
    p = load_qps_python(path)
    from qpalm_jax import solve_sparse_auto

    s = Settings(eps_abs=1e-7, eps_rel=1e-7, verbose=False, max_iter=5000)
    r = solve_sparse_auto(p.Q, p.A, p.q, p.bmin, p.bmax, settings=s, c=p.c)
    assert r.status_str == "solved", (name, r.status_str)
    assert abs(r.objective - fstar) <= 1e-5 * abs(fstar), (
        name, r.objective, fstar)
