"""Intra-QP parallelism: constraint-dimension sharding.

For one large QP, the heavy ops are the Schur assembly
M = Q + A' diag(sigma*active) A  (reference semantics: ldlcholQAtsigmaA,
solver_interface.c:372-405) and the A/A' matvecs — all contractions over the
constraint dimension m.  Sharding A by rows (constraints) across the mesh
makes each of them a local block op + one `psum` across devices:

    A  : (m, n)  sharded P(axis, None)
    Ax : (m,)    sharded P(axis)          (local matvec, no comm)
    A'y: (n,)    replicated               (psum of local A_k' y_k)
    M  : (n, n)  replicated               (psum of local B_k' B_k)

Two entry points:

* `solve_constraint_sharded` — the whole solve jitted with sharding
  constraints on the m-axis; the XLA SPMD partitioner inserts the collectives
  (the scaling-book recipe: pick a mesh, annotate shardings, let XLA do it).
  The solver core is unchanged.
* `sharded_schur_matrix` — the explicit `shard_map` version of the Schur
  assembly, for tests and as the building block of future block-structured
  (MPC-ladder) partitioning.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..precision import full_matmul_precision
from ..solver.core import full_solve
from ..types import QPData, Settings


def sharded_schur_matrix(
    A: jnp.ndarray,
    sqrt_sigma: jnp.ndarray,
    active: jnp.ndarray,
    mesh: Mesh,
    axis_name: str = "con",
) -> jnp.ndarray:
    """A' diag(sigma*active) A with A row-sharded: local B_k'B_k + one psum."""

    def local(a, ss, act):
        w = jnp.where(act, ss, jnp.zeros_like(ss))
        B = a * w[:, None]
        return jax.lax.psum(
            jnp.dot(B.T, B, preferred_element_type=a.dtype), axis_name
        )

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name), P(axis_name)),
        out_specs=P(),
    )(A, sqrt_sigma, active)


@functools.partial(
    jax.jit, static_argnames=("settings", "mesh", "axis_name")
)
@full_matmul_precision
def _solve_sharded_jit(
    data: QPData, settings: Settings, mesh: Mesh, axis_name: str
):
    rep = NamedSharding(mesh, P())
    row = NamedSharding(mesh, P(axis_name))
    rowmat = NamedSharding(mesh, P(axis_name, None))
    data = QPData(
        Q=jax.lax.with_sharding_constraint(data.Q, rep),
        A=jax.lax.with_sharding_constraint(data.A, rowmat),
        q=jax.lax.with_sharding_constraint(data.q, rep),
        bmin=jax.lax.with_sharding_constraint(data.bmin, row),
        bmax=jax.lax.with_sharding_constraint(data.bmax, row),
        c=data.c,
    )
    n, m = data.n, data.m
    dtype = data.Q.dtype
    zeros_n = jnp.zeros((n,), dtype)
    zeros_m = jnp.zeros((m,), dtype)
    settings = settings.replace(verbose=False)  # no host callbacks under SPMD
    final, x_sol, y_sol, obj = full_solve(
        data, zeros_n, zeros_m, settings, has_x=False, has_y=False
    )
    return (
        jax.lax.with_sharding_constraint(x_sol, rep),
        jax.lax.with_sharding_constraint(y_sol, rep),
        final.status,
        final.iter,
        obj,
    )


def solve_constraint_sharded(
    data: QPData,
    settings: Settings,
    mesh: Mesh,
    axis_name: str = "con",
):
    """Solve one QP with its constraint dimension sharded over `mesh`.

    The m-axis of A, bounds and every m-sized iterate is partitioned across
    devices; XLA inserts psum for A'y and the Schur assembly and gathers the
    2m linesearch breakpoints for the (replicated) sort.  m should be a
    multiple of the mesh size (pad with free constraints otherwise).

    Returns (x, y, status, iterations, objective), all replicated.
    """
    return _solve_sharded_jit(data, settings, mesh, axis_name)
