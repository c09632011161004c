"""Multi-device distribution for qpalm_jax.

The reference is strictly single-process (SURVEY.md §2.4); everything here is
net-new design:

* `sharded`   — data-parallel batch solves: the problem batch is sharded over
  a `jax.sharding.Mesh` with `shard_map`; each device runs its own solve loop
  on its local shard (no lockstep), collectives only aggregate metrics.
* `schur`     — intra-QP parallelism: constraint-dimension sharding of the
  Schur assembly A' diag(sigma) A and the m-sized iteration vectors, with
  `psum`/`all_gather` across devices (the model-parallel analogue flagged in
  SURVEY.md §2.4).
* `block_tridiag` — block-Thomas and distributed SPIKE solvers for the
  stage-banded Schur systems of MPC ladders.
* `mpc_loop`  — the whole P-ALM loop stage-sharded across the mesh: halo
  matvecs via ppermute, SPIKE Schur reduction per Newton step, gathered
  linesearch; matches the sequential solver iterate-for-iterate.
"""

from .sharded import (
    default_mesh,
    pad_batch_to_devices,
    solve_batch_sharded,
)
from .schur import solve_constraint_sharded
from .mpc_loop import MPCStageData, from_mpc_chain, solve_mpc_stage_sharded

__all__ = [
    "default_mesh",
    "pad_batch_to_devices",
    "solve_batch_sharded",
    "solve_constraint_sharded",
    "MPCStageData",
    "from_mpc_chain",
    "solve_mpc_stage_sharded",
]
