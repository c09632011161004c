"""qpalm_jax — QPALM in JAX: proximal augmented Lagrangian QP solver.

A from-scratch JAX/XLA implementation of the QPALM algorithm (proximal ALM
with semismooth-Newton inner iterations for convex and nonconvex QPs),
designed for accelerators: fixed shapes, dense batched linear algebra, one
`lax.while_loop` per solve, `vmap` over problem batches, and
`shard_map`/`pjit` across device meshes.

    minimize   0.5 x' Q x + q' x + c
    subject to bmin <= A x <= bmax
"""

import jax as _jax

# The reference solver is all-double (c_float = double, reference
# global_opts.h:21,61); 1e-6 tolerances on ill-conditioned QPs need f64.
# float32 remains available per-solver via Settings(dtype="float32").
_jax.config.update("jax_enable_x64", True)

from . import constants
from .constants import (
    FACTORIZE_CG,
    FACTORIZE_KKT,
    FACTORIZE_KKT_OR_SCHUR,
    FACTORIZE_SCHUR,
    FACTORIZE_STAGE,
    QPALM_DUAL_INFEASIBLE,
    QPALM_DUAL_TERMINATED,
    QPALM_ERROR,
    QPALM_MAX_ITER_REACHED,
    QPALM_PRIMAL_INFEASIBLE,
    QPALM_SOLVED,
    QPALM_TIME_LIMIT_REACHED,
    QPALM_UNSOLVED,
)
from .types import Info, QPData, ScalingInfo, Settings, Solution, SolveResult
from .api import QPALM, solve

__version__ = "0.1.0"

# submodules (imported lazily by attribute access is unnecessary — they are
# lightweight): batch solving, workload generators, IO drivers,
# multi-device distribution, checkpointing, reference-binding compat
from . import batch, checkpoint, compat, diff, host_sparse, io, parallel, workloads  # noqa: E402
from . import polish, polish_device  # noqa: E402  (certification pipeline)
from .host_sparse import (SparseQPALM, solve_sparse_auto,  # noqa: E402
                          solve_sparse_batch, solve_sparse_direct)

__all__ = [
    "QPALM",
    "solve",
    "Settings",
    "batch",
    "checkpoint",
    "compat",
    "diff",
    "io",
    "parallel",
    "workloads",
    "polish",
    "polish_device",
    "host_sparse",
    "solve_sparse_direct",
    "solve_sparse_auto",
    "SparseQPALM",
    "solve_sparse_batch",
    "FACTORIZE_KKT",
    "FACTORIZE_SCHUR",
    "FACTORIZE_KKT_OR_SCHUR",
    "FACTORIZE_CG",
    "FACTORIZE_STAGE",
    "Info",
    "QPData",
    "ScalingInfo",
    "Solution",
    "SolveResult",
    "constants",
    "QPALM_SOLVED",
    "QPALM_DUAL_TERMINATED",
    "QPALM_MAX_ITER_REACHED",
    "QPALM_PRIMAL_INFEASIBLE",
    "QPALM_DUAL_INFEASIBLE",
    "QPALM_TIME_LIMIT_REACHED",
    "QPALM_UNSOLVED",
    "QPALM_ERROR",
]
