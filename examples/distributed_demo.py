"""Multi-device demo: the three distribution modes over a device mesh.

Runs on CPU with 8 virtual devices so no GPUs are needed — the same
code paths `__graft_entry__.dryrun_multichip` validates and that run on a
real multi-GPU mesh unchanged (XLA_FLAGS below is how the virtual mesh is
created; on real GPUs just drop it).

Run: python examples/distributed_demo.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from qpalm_jax import Settings
from qpalm_jax.api import pad_problem
from qpalm_jax.batch import stack_problems
from qpalm_jax.parallel import (
    default_mesh,
    solve_batch_sharded,
    solve_constraint_sharded,
)
from qpalm_jax.parallel.block_tridiag import spike_solve, thomas_solve
from qpalm_jax.types import QPData

mesh = default_mesh(axis_name="qp")
print(f"mesh: {mesh.shape} over {jax.devices()[0].platform}")
rng = np.random.default_rng(0)
settings = Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False)

# --- 1. data parallel: the batch sharded across devices -------------------
probs = []
for i in range(16):
    M = rng.standard_normal((8, 8))
    probs.append((M @ M.T + 0.5 * np.eye(8), rng.standard_normal((12, 8)),
                  rng.standard_normal(8), -np.ones(12), np.ones(12)))
data = stack_problems(probs, np.float64)
B, n_pad = data.q.shape
m_pad = data.bmin.shape[1]
res, agg = solve_batch_sharded(
    data, jnp.zeros((B, n_pad)), jnp.zeros((B, m_pad)),
    jnp.full((B,), settings.gamma_init), settings, False, False, mesh, "qp",
)
print(f"1. data-parallel batch: {int(agg['n_solved'])}/{B} solved, "
      f"{int(agg['total_iters'])} total iterations (psum over the mesh)")

# --- 2. model parallel: one QP with its constraint dim sharded ------------
n, m = 12, 16
M = rng.standard_normal((n, n))
Q = M @ M.T + 0.5 * np.eye(n)
A = rng.standard_normal((m, n))
Qp, Ap, qp, bl, bu = pad_problem(Q, A, rng.standard_normal(n),
                                 -np.ones(m), np.ones(m), 16, 16, np.float64)
d1 = QPData(Q=jnp.asarray(Qp), A=jnp.asarray(Ap), q=jnp.asarray(qp),
            bmin=jnp.asarray(bl), bmax=jnp.asarray(bu), c=jnp.zeros(()))
x, y, status, iters, obj = solve_constraint_sharded(d1, settings, mesh, "qp")
print(f"2. constraint-sharded single QP: status {int(status)}, "
      f"{int(iters)} iterations (XLA SPMD inserts the psums)")

# --- 3. stage parallel: SPIKE block-tridiagonal Schur reduction -----------
S, nb = 16, 4
D = np.zeros((S, nb, nb))
E = np.zeros((S, nb, nb))
for k in range(S):
    X = rng.standard_normal((nb, nb))
    D[k] = X @ X.T + 5 * np.eye(nb)
for k in range(S - 1):
    E[k] = 0.3 * rng.standard_normal((nb, nb))
b = rng.standard_normal((S, nb))
x_sp = spike_solve(jnp.asarray(D), jnp.asarray(E), jnp.asarray(b), mesh, "qp")
x_seq = thomas_solve(jnp.asarray(D), jnp.asarray(E[:-1]), jnp.asarray(b))
err = float(np.max(np.abs(np.asarray(x_sp) - np.asarray(x_seq))))
print(f"3. SPIKE stage-partitioned solve across the mesh: "
      f"max diff vs sequential Thomas = {err:.2e}")
