"""Stage-sharded P-ALM loop: the whole solve distributed over the mesh
(SPIKE Schur reductions per Newton step) must match the sequential solver
on the same MPC problems — now across the FULL settings matrix
(proximal x scaling), with warm starts and infeasibility certificates."""

import jax.numpy as jnp
import numpy as np
import pytest

import qpalm_jax
from qpalm_jax import QPALM, Settings, constants as C
from qpalm_jax.parallel import default_mesh
from qpalm_jax.parallel.mpc_loop import (
    MPCStageData,
    from_mpc_chain,
    solve_mpc_stage_sharded,
)
from qpalm_jax.workloads import mpc_chain, mpc_stage_permutation


def _settings(proximal, scaling):
    # FACTORIZE_SCHUR pinned so the sequential reference uses the same
    # newton semantics the distributed loop implements
    return Settings(
        eps_abs=1e-6, eps_rel=1e-6, proximal=proximal, scaling=scaling,
        verbose=False, factorization_method=C.FACTORIZE_SCHUR,
    )


def _sequential(H, A, q, bmin, bmax, meta, settings, x0=None, y0=None):
    nx, nu, N = meta["nx"], meta["nu"], meta["N"]
    perm = mpc_stage_permutation(nx, nu, N)
    solver = QPALM(H[np.ix_(perm, perm)], A[:, perm], q[perm], bmin, bmax,
                   settings=settings)
    if x0 is not None:
        solver.warm_start(x0, y0)
    return solver.solve()


@pytest.mark.parametrize("proximal,scaling", [
    (False, 0), (True, 0), (False, 2), (True, 2),
])
def test_stage_sharded_matches_sequential_settings_matrix(proximal, scaling):
    H, A, q, bmin, bmax, meta = mpc_chain(4, 16, seed=0)
    data = from_mpc_chain(H, A, q, bmin, bmax, meta)
    mesh = default_mesh(8, axis_name="stage")
    s = _settings(proximal, scaling)
    res = solve_mpc_stage_sharded(data, s, mesh, "stage")
    assert int(res.status) == C.QPALM_SOLVED

    r = _sequential(H, A, q, bmin, bmax, meta, s)
    assert r.info.status == "solved"
    # same algorithm, same data => identical iteration counts and iterates
    assert int(res.iterations) == int(r.info.iter), (
        f"distributed {int(res.iterations)} vs sequential {int(r.info.iter)}"
    )
    np.testing.assert_allclose(
        np.asarray(res.z).reshape(-1), r.solution.x, atol=1e-6
    )


def test_stage_sharded_proximal_small_gamma_matches_sequential():
    """Regression (review finding): the distributed loop's proximal df was
    missing the +z/gamma term; at the default gamma_init=1e7 the error is
    ~1e-7 and invisible to the parity matrix, but at a small gamma the
    semantics diverge.  Parity must hold at gamma_init=100 too."""
    H, A, q, bmin, bmax, meta = mpc_chain(4, 16, seed=1)
    data = from_mpc_chain(H, A, q, bmin, bmax, meta)
    mesh = default_mesh(4, axis_name="stage")
    s = _settings(True, 2).replace(gamma_init=100.0, gamma_max=1e4)
    res = solve_mpc_stage_sharded(data, s, mesh, "stage")
    assert int(res.status) == C.QPALM_SOLVED
    r = _sequential(H, A, q, bmin, bmax, meta, s)
    assert int(res.iterations) == int(r.info.iter)
    np.testing.assert_allclose(
        np.asarray(res.z).reshape(-1), r.solution.x, atol=1e-6
    )


def test_stage_sharded_warm_start():
    H, A, q, bmin, bmax, meta = mpc_chain(3, 8, seed=2)
    data = from_mpc_chain(H, A, q, bmin, bmax, meta)
    mesh = default_mesh(8, axis_name="stage")
    s = _settings(True, 2)
    res = solve_mpc_stage_sharded(data, s, mesh, "stage")
    assert int(res.status) == C.QPALM_SOLVED
    cold_iters = int(res.iterations)

    res2 = solve_mpc_stage_sharded(
        data, s, mesh, "stage",
        z0=np.asarray(res.z),
        y_eq0=np.asarray(res.y_eq),
        y_box0=np.asarray(res.y_box),
    )
    assert int(res2.status) == C.QPALM_SOLVED
    assert int(res2.iterations) < cold_iters
    # two approximate solutions at the same eps agree to conditioning-
    # amplified tolerance, not to eps itself
    np.testing.assert_allclose(
        np.asarray(res2.z).reshape(-1),
        np.asarray(res.z).reshape(-1), atol=1e-4,
    )


def test_stage_sharded_chain80w_scale():
    """The chain80w protocol shape: 240 vars, horizon 80, sharded 8 ways."""
    H, A, q, bmin, bmax, meta = mpc_chain(1, 80, seed=0)
    assert H.shape[0] == 240
    data = from_mpc_chain(H, A, q, bmin, bmax, meta)
    mesh = default_mesh(8, axis_name="stage")
    s = _settings(False, 0)
    res = solve_mpc_stage_sharded(data, s, mesh, "stage")
    assert int(res.status) == C.QPALM_SOLVED

    r = _sequential(H, A, q, bmin, bmax, meta, s)
    np.testing.assert_allclose(
        np.asarray(res.z).reshape(-1), r.solution.x, atol=1e-8
    )


def test_stage_sharded_primal_infeasible_certificate():
    """Dynamics forcing x_1 far outside its box: primal infeasible, with a
    delta_y certificate satisfying the Farkas conditions
    (reference termination.c:136-182)."""
    H, A, q, bmin, bmax, meta = mpc_chain(1, 8, seed=1)
    nx, nu, N = meta["nx"], meta["nu"], meta["N"]
    nb = nx + nu
    data = from_mpc_chain(H, A, q, bmin, bmax, meta)
    # beq_0 demands x_1 ~ 50 while the state box clamps |x| <= ~1
    beq = np.asarray(data.beq).copy()
    beq[0, :] = 50.0
    data = data._replace(beq=jnp.asarray(beq))
    mesh = default_mesh(8, axis_name="stage")
    for proximal, scaling in [(True, 2), (False, 0)]:
        s = _settings(proximal, scaling)
        res = solve_mpc_stage_sharded(data, s, mesh, "stage")
        assert int(res.status) == C.QPALM_PRIMAL_INFEASIBLE, (
            proximal, scaling, int(res.status)
        )
        # Farkas check on the unscaled certificate: A' dy ~ 0.  The box
        # rows of the stage data are per stage-ordered variable, so their
        # A' contribution is just dy_box itself in stage column order.
        dy_eq = np.asarray(res.delta_y_eq).reshape(-1)
        dy_box = np.asarray(res.delta_y_box).reshape(-1)
        perm = mpc_stage_permutation(nx, nu, N)
        m_eq = meta["m_eq"]
        A_eq = np.asarray(A)[:m_eq][:, perm]
        At_dy = A_eq.T @ dy_eq + dy_box
        scale = max(1.0, np.abs(dy_eq).max(), np.abs(dy_box).max())
        assert np.abs(At_dy).max() <= 1e-4 * scale


def test_stage_sharded_dual_infeasible_certificate():
    """Zero Hessian, free boxes, descent direction in the dynamics
    nullspace: dual infeasible (reference termination.c:184-240)."""
    H, A, q, bmin, bmax, meta = mpc_chain(1, 8, seed=3)
    data = from_mpc_chain(H, A, q, bmin, bmax, meta)
    S_, nb = np.asarray(data.q).shape
    data = MPCStageData(
        H=np.zeros_like(np.asarray(data.H)),
        q=-np.ones((S_, nb)),
        beq=np.zeros_like(np.asarray(data.beq)),
        lo=np.full((S_, nb), -np.inf),
        hi=np.full((S_, nb), np.inf),
        Ad=data.Ad, Bd=data.Bd,
    )
    mesh = default_mesh(8, axis_name="stage")
    s = _settings(True, 0)
    res = solve_mpc_stage_sharded(data, s, mesh, "stage")
    assert int(res.status) == C.QPALM_DUAL_INFEASIBLE
    dz = np.asarray(res.delta_z).reshape(-1)
    assert np.abs(dz).max() > 0
    # descent direction: q' dz < 0 and H dz = 0 trivially
    assert float(np.dot(np.full(dz.shape, -1.0), dz)) < 0


def test_stage_data_direct_constructor_matches_dense_route():
    """mpc_chain_stage_data must be bit-identical to the dense
    from_mpc_chain(mpc_chain(...)) route (it exists because the dense
    route's vstack holds ~27 GB of resident pages per process at
    horizon 1536 — the multiproc scaling bench OOMed at 4 processes)."""
    from qpalm_jax.parallel.mpc_loop import mpc_chain_stage_data

    for masses, horizon, seed in ((4, 16, 0), (10, 12, 3), (3, 7, 11)):
        dense = from_mpc_chain(*mpc_chain(masses, horizon, seed=seed))
        direct = mpc_chain_stage_data(masses, horizon, seed=seed)
        for field, a, b in zip(dense._fields, dense, direct):
            assert a.shape == b.shape, (field, a.shape, b.shape)
            assert np.array_equal(np.asarray(a), np.asarray(b)), field
