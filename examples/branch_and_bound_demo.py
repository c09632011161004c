"""Branch-and-bound mixed-integer QP demo: dual-objective termination +
warm starts doing the job they exist for.

The reference exposes `enable_dual_termination` "useful in branch and
bound" (reference src/qpalm.c:63) but ships no B&B driver.  This demo is
a minimal best-first B&B over binary variables where each node's QP
relaxation is solved by QPALM with:

  * warm starts from the parent node's solution (qpalm_warm_start
    semantics — node solves take a handful of iterations);
  * `dual_objective_limit` set to the incumbent: the dual objective is a
    LOWER bound on the relaxation's optimum, so once it exceeds the
    incumbent the node can never improve it and the solver exits early
    with QPALM_DUAL_TERMINATED instead of polishing a solve nobody needs.

Problem: min 0.5 x'Qx + q'x  s.t.  sum(x) >= k, x_i in {0, 1}.
Branching relaxes x_i in [0, 1] and fixes variables via bound updates.
The result is checked against brute-force enumeration.

Run: python examples/branch_and_bound_demo.py
"""

import heapq
import itertools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from qpalm_jax import QPALM, Settings, constants as C

rng = np.random.default_rng(7)
n, k = 10, 3
M = rng.standard_normal((n, n))
Q = M @ M.T / n + 0.5 * np.eye(n)
q = rng.standard_normal(n) - 0.2

# rows: [sum(x) >= k ; identity boxes for the binaries]
A = np.vstack([np.ones((1, n)), np.eye(n)])


def solve_node(fixed, incumbent, warm):
    """QP relaxation with `fixed` = {i: 0/1}; returns (status, obj, x, y)."""
    lo = np.array([float(k)] + [float(fixed.get(i, 0.0)) for i in range(n)])
    hi = np.array([np.inf] + [float(fixed.get(i, 1.0)) for i in range(n)])
    s = Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False,
                 enable_dual_termination=True,
                 dual_objective_limit=float(incumbent))
    solver = QPALM(Q, A, q, lo, hi, settings=s)
    if warm is not None:
        solver.warm_start(warm[0], warm[1])
    r = solver.solve()
    return (r.info.status_val, float(r.info.objective),
            np.asarray(r.solution.x), np.asarray(r.solution.y),
            int(r.info.iter))


incumbent = np.inf
incumbent_x = None
nodes_solved = 0
nodes_pruned = 0
total_iters = 0
# best-first queue: (parent bound, tiebreak, fixed-assignment, parent warm)
heap = [(-np.inf, 0, {}, None)]
tiebreak = itertools.count(1)

while heap:
    bound, _, fixed, warm = heapq.heappop(heap)
    if bound >= incumbent - 1e-9:
        nodes_pruned += 1
        continue
    status, obj, x, y, iters = solve_node(fixed, incumbent, warm)
    nodes_solved += 1
    total_iters += iters
    if status == C.QPALM_DUAL_TERMINATED:
        # dual objective exceeded the incumbent: provably no improvement
        nodes_pruned += 1
        continue
    if status != C.QPALM_SOLVED or obj >= incumbent - 1e-9:
        nodes_pruned += 1
        continue
    frac = [i for i in range(n) if i not in fixed
            and min(x[i], 1.0 - x[i]) > 1e-6]
    if not frac:
        incumbent = obj
        incumbent_x = np.round(x).astype(int)
        continue
    # branch on the most fractional variable, children warm-started here
    i = max(frac, key=lambda j: min(x[j], 1.0 - x[j]))
    for v in (0.0, 1.0):
        child = dict(fixed)
        child[i] = v
        heapq.heappush(heap, (obj, next(tiebreak), child, (x, y)))

# brute-force oracle
best = np.inf
best_x = None
for bits in itertools.product((0, 1), repeat=n):
    xv = np.array(bits, float)
    if xv.sum() < k:
        continue
    val = 0.5 * xv @ Q @ xv + q @ xv
    if val < best:
        best, best_x = val, np.array(bits, int)

assert incumbent_x is not None
# the incumbent is the QP relaxation's objective at eps 1e-6, so it can
# differ from the exact binary objective by ~1e-6
assert abs(incumbent - best) < 1e-5, (incumbent, best)
assert (incumbent_x == best_x).all()
print(f"optimal MIQP objective {incumbent:.6f} (matches brute force)")
print(f"nodes solved: {nodes_solved}, pruned: {nodes_pruned}, "
      f"total QP iterations: {total_iters} "
      f"(of {2 ** n} enumerations)")
