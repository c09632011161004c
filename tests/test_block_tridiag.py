"""Block-tridiagonal solvers: sequential Thomas, distributed SPIKE, and the
MPC-ladder structure they target (SURVEY §2.4 'Schur-complement reduction of
block-partitioned KKT systems')."""

import jax.numpy as jnp
import numpy as np

from qpalm_jax.parallel import default_mesh
from qpalm_jax.parallel.block_tridiag import (
    block_tridiag_error,
    extract_block_tridiag,
    spike_solve,
    thomas_solve,
)
from qpalm_jax.workloads import mpc_chain, mpc_stage_permutation


def _random_spd_tridiag(S, nb, seed=0):
    rng = np.random.default_rng(seed)
    D = np.zeros((S, nb, nb))
    E = np.zeros((S, nb, nb))
    for k in range(S):
        X = rng.standard_normal((nb, nb))
        D[k] = X @ X.T + 5 * np.eye(nb)
    for k in range(S - 1):
        E[k] = 0.5 * rng.standard_normal((nb, nb))
    M = np.zeros((S * nb, S * nb))
    for k in range(S):
        M[k * nb:(k + 1) * nb, k * nb:(k + 1) * nb] = D[k]
    for k in range(S - 1):
        M[(k + 1) * nb:(k + 2) * nb, k * nb:(k + 1) * nb] = E[k]
        M[k * nb:(k + 1) * nb, (k + 1) * nb:(k + 2) * nb] = E[k].T
    return D, E, M


def test_thomas_matches_dense():
    D, E, M = _random_spd_tridiag(12, 3, seed=1)
    b = np.random.default_rng(2).standard_normal((12, 3))
    x = np.asarray(thomas_solve(jnp.asarray(D), jnp.asarray(E[:-1]), jnp.asarray(b)))
    x_ref = np.linalg.solve(M, b.ravel()).reshape(12, 3)
    np.testing.assert_allclose(x, x_ref, atol=1e-10)


def test_spike_matches_dense_8_devices():
    S, nb = 16, 4
    D, E, M = _random_spd_tridiag(S, nb, seed=3)
    b = np.random.default_rng(4).standard_normal((S, nb))
    mesh = default_mesh(8, axis_name="stage")
    x = np.asarray(spike_solve(
        jnp.asarray(D), jnp.asarray(E), jnp.asarray(b), mesh, "stage"
    ))
    x_ref = np.linalg.solve(M, b.ravel()).reshape(S, nb)
    np.testing.assert_allclose(x, x_ref, atol=1e-10)


def test_factorize_stage_matches_dense_solver():
    """FACTORIZE_STAGE (block-Thomas Newton) inside the full P-ALM loop is
    bit-equivalent to the dense Schur path on a stage-ordered MPC QP."""
    import numpy as np

    from qpalm_jax import QPALM, Settings
    from qpalm_jax.constants import FACTORIZE_STAGE

    H, A, q, bmin, bmax, meta = mpc_chain(4, 10, seed=0)
    nx, nu, N = meta["nx"], meta["nu"], meta["N"]
    nb = nx + nu
    perm = mpc_stage_permutation(nx, nu, N)
    Hp, Ap, qp = H[np.ix_(perm, perm)], A[:, perm], q[perm]
    base = dict(eps_abs=1e-6, eps_rel=1e-6, proximal=False, scaling=2,
                verbose=False)
    r_stage = QPALM(Hp, Ap, qp, bmin, bmax, settings=Settings(
        factorization_method=FACTORIZE_STAGE, stage_block=nb, **base
    )).solve()
    r_dense = QPALM(Hp, Ap, qp, bmin, bmax, settings=Settings(**base)).solve()
    assert r_stage.info.status == "solved"
    np.testing.assert_allclose(
        r_stage.solution.x, r_dense.solution.x, atol=1e-10
    )


def test_sequential_mpc_stage_structured():
    from qpalm_jax.workloads import SequentialMPC
    import numpy as np

    m1 = SequentialMPC(3, 6, seed=1)
    m2 = SequentialMPC(3, 6, seed=1, stage_structured=True)
    i1 = m1.run(5)
    i2 = m2.run(5)
    assert i1 == i2
    np.testing.assert_allclose(m1.x, m2.x, atol=1e-8)


def test_mpc_schur_is_block_tridiagonal():
    """The stage-ordered MPC Schur matrix M = H + A' Sigma A is exactly
    block-tridiagonal, and the partitioned solve matches the dense solve."""
    H, A, q, bmin, bmax, meta = mpc_chain(4, 8, seed=0)
    nx, nu, N = meta["nx"], meta["nu"], meta["N"]
    nb = nx + nu
    perm = mpc_stage_permutation(nx, nu, N)
    Hp = H[np.ix_(perm, perm)]
    Ap = A[:, perm]
    rng = np.random.default_rng(5)
    sigma = 1.0 + rng.random(A.shape[0])
    active = rng.random(A.shape[0]) < 0.7
    M = Hp + Ap.T @ (np.where(active, sigma, 0.0)[:, None] * Ap) \
        + 1e-7 * np.eye(Hp.shape[0])
    assert float(block_tridiag_error(jnp.asarray(M), nb)) == 0.0

    D, E = extract_block_tridiag(jnp.asarray(M), nb)
    b = rng.standard_normal(M.shape[0])
    S = M.shape[0] // nb
    x = np.asarray(thomas_solve(D, E[:-1], jnp.asarray(b.reshape(S, nb))))
    x_ref = np.linalg.solve(M, b).reshape(S, nb)
    np.testing.assert_allclose(x, x_ref, atol=1e-8)

    mesh = default_mesh(8, axis_name="stage")
    x_sp = np.asarray(spike_solve(D, E, jnp.asarray(b.reshape(S, nb)),
                                  mesh, "stage"))
    np.testing.assert_allclose(x_sp, x_ref, atol=1e-8)


def test_spike_cyclic_reduction_nd64():
    """The cyclic-reduction interface solve must hold at nd=64 (the scale
    the round-1 dense-QR interface could not reach).  Runs in a subprocess
    with 64 virtual CPU devices so the main session keeps its 8."""
    import subprocess
    import sys

    code = """
import jax; jax.config.update('jax_platforms', 'cpu')
import numpy as np
import jax.numpy as jnp
from qpalm_jax.parallel import default_mesh
from qpalm_jax.parallel.block_tridiag import spike_solve, thomas_solve

S, nb = 128, 2
rng = np.random.default_rng(0)
D = np.zeros((S, nb, nb)); E = np.zeros((S, nb, nb))
for k in range(S):
    X = rng.standard_normal((nb, nb))
    D[k] = X @ X.T + 5 * np.eye(nb)
for k in range(S - 1):
    E[k] = 0.5 * rng.standard_normal((nb, nb))
b = rng.standard_normal((S, nb))
mesh = default_mesh(64, axis_name='stage')
x = np.asarray(spike_solve(jnp.asarray(D), jnp.asarray(E), jnp.asarray(b),
                           mesh, 'stage'))
x_ref = np.asarray(thomas_solve(jnp.asarray(D), jnp.asarray(E[:-1]),
                                jnp.asarray(b)))
err = np.abs(x - x_ref).max()
assert err < 1e-8, err
print('nd64 ok', err)
"""
    env = dict(
        __import__("os").environ,
        XLA_FLAGS="--xla_force_host_platform_device_count=64",
        JAX_PLATFORMS="cpu",
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "nd64 ok" in r.stdout
