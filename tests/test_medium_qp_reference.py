"""The reference's exact n=m=15 medium-QP fixture with its 15-digit stored
solution (reference: tests/src/test_medium_qp.c:14-18,26-128) — direct
numerical parity evidence: the same data must solve to the same solution
within the reference's own per-component relative tolerance of 1e-5
(test_medium_qp.c:160-163)."""

import numpy as np
import scipy.sparse as sp

import qpalm_jax
from qpalm_jax import QPALM, Settings

N = M = 15

SOLUTION = np.array([
    -4.258643191312046e+00, 9.393193922630394e+00, 1.888905966442421e+01,
    -2.469934088388301e+00, 9.628197800226003e+00, 6.034505999261726e+00,
    -8.288652177085156e+00, -9.172613482098816e+00, -4.005465476438092e+01,
    -2.983244126863757e+01, -7.447972191390734e+00, -6.315368738609618e+00,
    4.555205430378418e+00, 6.362674847968517e+00, -2.000000000000000e+00,
])

A_P = [0, 1, 2, 5, 8, 9, 11, 12, 13, 16, 18, 21, 22, 23, 24, 25]
A_I = [8, 2, 1, 4, 14, 1, 4, 13, 5, 0, 7, 10, 6, 1, 4, 14, 0, 7, 1, 4,
       13, 3, 9, 11, 12]
A_X = [3.256021467039615e-01, -2.129201224283822e-01, -3.904780212604003e-02,
       -1.097664622926547e-02, 8.935098531570440e-05, 1.107958814061373e-01,
       -3.941400281255630e-01, -3.422661790473164e-02, -2.077231940491557e-01,
       2.961057917719591e-01, 2.901671645955232e-02, -2.412937540712519e-01,
       2.180403659113273e-01, -7.769757105018442e-02, -2.184140217516474e-02,
       -4.490435862043659e-05, -7.144833411941969e-03, 7.291061197330474e-02,
       1.354927131911815e-02, -4.819953694147238e-02, 2.798798702152373e-01,
       -3.166877632612020e-01, 4.390581348235377e-01, -3.143332085622074e-01,
       -1.000000000000000e+00]

Q_DIAG = [1.000000000000000e+00, 5.179474679231212e-01, 2.682695795279726e-01,
          1.389495494373138e-01, 7.196856730011525e-02, 3.727593720314943e-02,
          1.930697728883252e-02, 1.000000000000001e-02, 5.179474679231217e-03,
          2.682695795279729e-03, 1.389495494373140e-03, 7.196856730011531e-04,
          3.727593720314947e-04, 1.930697728883254e-04, 1.000000000000002e-04]

Q_VEC = [4.258643191312094e+00, -1.270043450597050e+01, -4.852188357430427e+00,
         5.943076168298481e+00, -2.764649066392558e+00, -1.857582885927374e+01,
         4.073081174942876e-01, 2.829701771619900e+00, 6.356121930249937e-01,
         4.334300651115951e+00, 4.228603644876851e+00, 1.299528296551999e+01,
         -1.049793234475067e+01, -1.786411722110915e+01, 8.160430810319180e+00]


def _fixture():
    A = sp.csc_matrix(
        (np.asarray(A_X), np.asarray(A_I), np.asarray(A_P)), shape=(M, N)
    ).toarray()
    Q = np.diag(Q_DIAG)
    q = np.asarray(Q_VEC)
    bmin = np.full(M, -2.0)
    bmax = np.full(M, 2.0)
    return Q, A, q, bmin, bmax


def test_reference_medium_qp_stored_solution():
    Q, A, q, bmin, bmax = _fixture()
    s = Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False)
    res = QPALM(Q, A, q, bmin, bmax, settings=s).solve()
    assert res.info.status == "solved"
    for i in range(N):
        tol = abs(1e-5 * SOLUTION[i])
        assert abs(res.solution.x[i] - SOLUTION[i]) <= tol, (
            i, res.solution.x[i], SOLUTION[i]
        )


def test_reference_medium_qp_all_factorizations():
    """Same stored solution under every factorization backend."""
    from qpalm_jax.constants import (
        FACTORIZE_CG,
        FACTORIZE_KKT,
        FACTORIZE_SCHUR,
    )

    Q, A, q, bmin, bmax = _fixture()
    for method in (FACTORIZE_SCHUR, FACTORIZE_KKT, FACTORIZE_CG):
        s = Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False,
                     factorization_method=method)
        res = QPALM(Q, A, q, bmin, bmax, settings=s,
                    sparse=(method == FACTORIZE_CG)).solve()
        assert res.info.status == "solved", method
        np.testing.assert_allclose(
            res.solution.x, SOLUTION, rtol=1e-4, atol=1e-6
        )
