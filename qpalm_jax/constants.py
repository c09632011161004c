"""Solver status codes and default parameters.

JAX re-implementation of the reference constants
(reference: include/constants.h:30-110). Values are kept identical so that
termination behaviour, default tolerances and status reporting match the
reference solver exactly.
"""

# ---------------------------------------------------------------------------
# Solver status codes (reference: constants.h:30-37)
# ---------------------------------------------------------------------------
QPALM_SOLVED = 1
QPALM_DUAL_TERMINATED = 2
QPALM_MAX_ITER_REACHED = -2
QPALM_PRIMAL_INFEASIBLE = -3
QPALM_DUAL_INFEASIBLE = -4
QPALM_TIME_LIMIT_REACHED = -5
QPALM_UNSOLVED = -10
QPALM_ERROR = 0

STATUS_STRINGS = {
    QPALM_SOLVED: "solved",
    QPALM_DUAL_TERMINATED: "dual terminated",
    QPALM_MAX_ITER_REACHED: "maximum iterations reached",
    QPALM_PRIMAL_INFEASIBLE: "primal infeasible",
    QPALM_DUAL_INFEASIBLE: "dual infeasible",
    QPALM_TIME_LIMIT_REACHED: "time limit exceeded",
    QPALM_UNSOLVED: "unsolved",
    QPALM_ERROR: "error",
}

# ---------------------------------------------------------------------------
# Numeric constants (reference: constants.h:52-62)
# ---------------------------------------------------------------------------
QPALM_NULL = 0
QPALM_INFTY = 1e20  # bounds beyond this are treated as +-infinity

# ---------------------------------------------------------------------------
# Default settings (reference: constants.h:65-110)
# ---------------------------------------------------------------------------
MAX_ITER = 10000
INNER_MAX_ITER = 100
EPS_ABS = 1e-4
EPS_REL = 1e-4
EPS_ABS_IN = 1.0
EPS_REL_IN = 1.0
RHO = 0.1
EPS_PRIM_INF = 1e-5
EPS_DUAL_INF = 1e-5
THETA = 0.25
DELTA = 100.0
SIGMA_MAX = 1e9
SIGMA_INIT = 2e1
PROXIMAL = True
GAMMA_INIT = 1e7
GAMMA_UPD = 10.0
GAMMA_MAX = 1e7

SCALING = 10
MIN_SCALING = 1e-12
MAX_SCALING = 1e4

NONCONVEX = False
WARM_START = False
VERBOSE = True
PRINT_ITER = 1

RESET_NEWTON_ITER = 10000

ENABLE_DUAL_TERMINATION = False
DUAL_OBJECTIVE_LIMIT = QPALM_INFTY
TIME_LIMIT = QPALM_INFTY

MAX_RANK_UPDATE = 160
MAX_RANK_UPDATE_FRACTION = 0.1

RELATIVE_REFINEMENT_TOLERANCE = 1e-10
ABSOLUTE_REFINEMENT_TOLERANCE = 1e-12
MAX_REFINEMENT_ITERATIONS = 3

# Factorization / linear-system modes (reference: constants.h:105-110).
# On the device both modes are dense: SCHUR factors Q + 1/gamma*I + A' S A via
# (batched) Cholesky; KKT eliminates the quasi-definite (n+m) system's
# diagonal (2,2) block down to the same Schur system.  AUTO selects by shape.
FACTORIZE_KKT = 0
FACTORIZE_SCHUR = 1
FACTORIZE_KKT_OR_SCHUR = 2
# Extension (no reference equivalent): matrix-free Newton via
# Jacobi-preconditioned CG — the large-sparse path (BCOO data, no dense M)
FACTORIZE_CG = 3
# Extension: stage-structured Newton — the Schur matrix of a
# stage-ordered MPC QP is block-tridiagonal; solve it with block Thomas
# (single device) instead of a dense Cholesky.  Requires
# Settings.stage_block = nx + nu.  The distributed variant is
# parallel.block_tridiag.spike_solve.
FACTORIZE_STAGE = 4
FACTORIZATION_METHOD = FACTORIZE_KKT_OR_SCHUR

# CG Newton solve defaults (FACTORIZE_CG mode)
CG_TOL = 1e-8
CG_MAX_ITER = 500

LOBPCG_TOL = 1e-5  # reference: nonconvex.c:24
LOBPCG_MAX_ITER = 1000  # reference: nonconvex.c:111
