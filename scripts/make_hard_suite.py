#!/usr/bin/env python
"""Generate the committed HARD QPS suite (benchmarks/qps_hard/).

Round-1 feedback: the mini suite's 12 solver-generated synthetics have
near-zero evidential value about hard instances.  This suite adds the
stress classes the Maros-Meszaros tail is made of (reference protocol
simulations/maros_meszaros/test_maros_meszaros.m:43-106):

  * ILLCOND* — condition numbers 1e8..1e12 (diagonal spread, Laplacian^2
    coupling, near-parallel constraint rows)
  * DEGEN*   — rank-deficient (PSD-singular) Hessians
  * PINF* / DINF* — primal- / dual-infeasible instances (the expected
    status is encoded in the name; the runner scores them as correct only
    when the matching certificate status is returned)
  * NARROW*  — near-degenerate ranges (bmax - bmin ~ 1e-7)
  * BIGRAND* — the reference randomQP protocol at n=300/m=450 and beyond
  * OLDFMT*  — old fixed-column-format files (exercises the converter,
    reference interfaces/qps/src/qps_conversion.c)

plus the mini suite's 12 family problems, for >= 32 total.
"""

import os
import shutil
import sys

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from qpalm_jax.io.qps import save_qps
from qpalm_jax.workloads import lasso, mpc_chain, portfolio, random_qp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "benchmarks", "qps_hard")
MINI = os.path.join(ROOT, "benchmarks", "qps_mini")

def _old_line(section, *fields):
    """Format one old fixed-column MPS body line (converter slices:
    ROWS [1:3][3:13]; COLUMNS/RHS [1:13][13:23][23:38][38:49][49:62];
    BOUNDS [1:4][4:13][13:23][23:38])."""
    if section == "ROWS":
        t, name = fields
        return " " + t.ljust(2) + name.ljust(10)
    if section == "BOUNDS":
        t, bnd, var = fields[:3]
        line = " " + t.ljust(3) + bnd.ljust(9) + var.ljust(10)
        if len(fields) > 3:
            line += fields[3].ljust(15)
        return line
    # COLUMNS / RHS / QUADOBJ
    name1, name2, val = fields[:3]
    line = " " + name1.ljust(12) + name2.ljust(10) + val.ljust(15)
    if len(fields) > 3:
        line += fields[3].ljust(11) + fields[4].ljust(13)
    return line


def _oldfmt0():
    # 2-variable QP, one L row; names contain spaces (the old-format
    # hallmark the converter strips)
    L = _old_line
    return "\n".join([
        "NAME          OLDFMT0",
        "ROWS",
        L("ROWS", "N", "COST"),
        L("ROWS", "L", "LIM ONE"),
        "COLUMNS",
        L("COLUMNS", "X ONE", "COST", "1.0", "LIM ONE", "1.0"),
        L("COLUMNS", "X TWO", "COST", "2.0", "LIM ONE", "1.0"),
        "RHS",
        L("RHS", "RHS", "LIM ONE", "4.0"),
        "BOUNDS",
        L("BOUNDS", "FR", "BND", "X ONE"),
        L("BOUNDS", "FR", "BND", "X TWO"),
        "QUADOBJ",
        L("QUADOBJ", "X ONE", "X ONE", "2.0"),
        L("QUADOBJ", "X TWO", "X TWO", "2.0"),
        "ENDATA",
    ]) + "\n"


def _oldfmt1():
    L = _old_line
    return "\n".join([
        "NAME          OLDFMT1",
        "ROWS",
        L("ROWS", "N", "OBJ ROW"),
        L("ROWS", "G", "CON A"),
        L("ROWS", "L", "CON B"),
        "COLUMNS",
        L("COLUMNS", "VAR 1", "OBJ ROW", "-1.0", "CON A", "1.0"),
        L("COLUMNS", "VAR 1", "CON B", "1.0"),
        L("COLUMNS", "VAR 2", "OBJ ROW", "-1.0", "CON A", "1.0"),
        L("COLUMNS", "VAR 2", "CON B", "2.0"),
        "RHS",
        L("RHS", "RHS", "CON A", "1.0", "CON B", "6.0"),
        "BOUNDS",
        L("BOUNDS", "FR", "BND", "VAR 1"),
        L("BOUNDS", "FR", "BND", "VAR 2"),
        "QUADOBJ",
        L("QUADOBJ", "VAR 1", "VAR 1", "1.0"),
        L("QUADOBJ", "VAR 2", "VAR 2", "4.0"),
        "ENDATA",
    ]) + "\n"


def main():
    os.makedirs(OUT, exist_ok=True)
    rng = np.random.default_rng(1234)
    problems = {}

    # ---- ill-conditioned -------------------------------------------------
    # diagonal spread: cond(Q) = 1e8
    n = 120
    d = 10.0 ** np.linspace(-4, 4, n)
    M = rng.standard_normal((n, n))
    Qo, _ = np.linalg.qr(M)
    Q = (Qo * d) @ Qo.T
    A = rng.standard_normal((n + 40, n))
    u = 1 + rng.random(n + 40)
    problems["ILLCOND0"] = (Q, A, rng.standard_normal(n), -u, u)

    # Laplacian^2 coupling (cond ~ 1e9 at this size), banded constraints
    n = 300
    L = sp.diags([2 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
                 [0, 1, -1])
    Q = (L @ L + 1e-6 * sp.eye(n)).toarray()
    m = 120
    A = sp.diags([np.ones(m), 0.5 * np.ones(m)], [0, 1],
                 shape=(m, n)).toarray()
    u = 1 + rng.random(m)
    problems["ILLCOND1"] = (Q, A, rng.standard_normal(n), -u, u)

    # near-parallel constraint rows (Gram matrix nearly singular)
    n, m = 60, 90
    base = rng.standard_normal(n)
    A = np.tile(base, (m, 1)) + 1e-5 * rng.standard_normal((m, n))
    M2 = rng.standard_normal((n, n))
    Q = M2 @ M2.T / n + 0.01 * np.eye(n)
    u = 1 + rng.random(m)
    problems["ILLCOND2"] = (Q, A, rng.standard_normal(n), -u, u)

    # widely-scaled rows AND columns (Ruiz stress)
    n, m = 80, 120
    rs = 10.0 ** rng.uniform(-5, 5, m)
    cs = 10.0 ** rng.uniform(-5, 5, n)
    A = rs[:, None] * rng.standard_normal((m, n)) * cs[None, :]
    M3 = rng.standard_normal((n, n))
    Q = cs[:, None] * (M3 @ M3.T / n + 0.1 * np.eye(n)) * cs[None, :]
    u = rs * (1 + rng.random(m))
    problems["ILLCOND3"] = (Q, A, cs * rng.standard_normal(n), -u, u)

    # ---- degenerate Hessians ----------------------------------------------
    for i, (n, rank) in enumerate([(60, 10), (100, 0), (80, 40)]):
        m = n + 20
        if rank:
            G = rng.standard_normal((n, rank))
            Q = G @ G.T  # PSD, rank-deficient
        else:
            Q = np.zeros((n, n))  # an LP
        A = rng.standard_normal((m, n))
        u = 1 + rng.random(m)
        problems[f"DEGEN{i}"] = (Q, A, rng.standard_normal(n), -u, u)

    # ---- infeasible -------------------------------------------------------
    # primal: contradictory rows
    n = 30
    A = np.vstack([np.eye(n), np.eye(n)])
    bmin = np.concatenate([np.ones(n), -np.full(n, np.inf)])
    bmax = np.concatenate([np.full(n, np.inf), -np.ones(n)])
    problems["PINF0"] = (np.eye(n), A, np.zeros(n), bmin, bmax)

    n, m = 40, 60
    A = rng.standard_normal((m, n))
    x_any = rng.standard_normal(n)
    b = A @ x_any
    bmin = b + 1.0  # row set demanding Ax >= b+1 AND Ax <= b-1
    bmax = b + 2.0
    A2 = np.vstack([A, A])
    bmin2 = np.concatenate([bmin, b - 2.0])
    bmax2 = np.concatenate([bmax, b - 1.0])
    M4 = rng.standard_normal((n, n))
    problems["PINF1"] = (M4 @ M4.T / n + 0.1 * np.eye(n), A2,
                         rng.standard_normal(n), bmin2, bmax2)

    # dual: unbounded below
    n = 25
    problems["DINF0"] = (np.zeros((n, n)), np.zeros((1, n)),
                         -np.ones(n), np.array([-np.inf]),
                         np.array([np.inf]))
    n, m = 30, 10
    G = rng.standard_normal((n, 5))
    problems["DINF1"] = (G @ G.T, rng.standard_normal((m, n)),
                         -np.ones(n), -np.full(m, np.inf),
                         np.full(m, np.inf))

    # ---- near-degenerate ranges --------------------------------------------
    n, m = 50, 75
    M5 = rng.standard_normal((n, n))
    Q = M5 @ M5.T / n + 0.1 * np.eye(n)
    A = rng.standard_normal((m, n))
    x_feas = rng.standard_normal(n) * 0.1
    mid = A @ x_feas  # consistent: the band contains A x_feas exactly
    problems["NARROW0"] = (Q, A, rng.standard_normal(n),
                           mid - 5e-8, mid + 5e-8)

    # ---- the reference randomQP protocol at scale --------------------------
    for i, (n, m, dens) in enumerate([(300, 450, 0.15), (200, 300, 0.5),
                                      (400, 200, 0.1), (500, 750, 0.05)]):
        problems[f"BIGRAND{i}"] = random_qp(n, m, density=dens,
                                            seed=100 + i)

    for i, n in enumerate([120]):
        problems[f"BIGLASSO{i}"] = lasso(n, gamma=2.0, seed=50 + i)
    for i, n in enumerate([150]):
        problems[f"BIGPORTF{i}"] = portfolio(n, gamma=1.0, seed=60 + i)
    H, A_, q_, bl_, bu_, _ = mpc_chain(2, 40, seed=70)
    problems["BIGMPC0"] = (H, A_, q_, bl_, bu_)

    for name, (Q, A, q, bmin, bmax) in problems.items():
        save_qps(os.path.join(OUT, f"{name}.qps"), Q, A, q, bmin, bmax,
                 name=name)
        print("wrote", name)

    # old fixed-column format files
    for name, text in (("OLDFMT0", _oldfmt0()), ("OLDFMT1", _oldfmt1())):
        with open(os.path.join(OUT, f"{name}.qps"), "w") as f:
            f.write(text)
        print("wrote", name)

    # fold in the mini-suite family problems
    if os.path.isdir(MINI):
        for f in sorted(os.listdir(MINI)):
            if f.endswith(".qps"):
                shutil.copy(os.path.join(MINI, f), os.path.join(OUT, f))
        print("copied mini suite")


if __name__ == "__main__":
    main()
