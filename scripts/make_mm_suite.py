#!/usr/bin/env python
"""Generate the committed Maros-Meszaros-scale QPS suite (benchmarks/qps_mm/).

The reference's headline protocol runs the full Maros-Meszaros set, whose
bulk members are n ~ 1e3-1e4 (reference
simulations/maros_meszaros/test_maros_meszaros.m:50-74).  The corpus data
files are not fetchable in this zero-egress environment, but several
families are *algorithmically defined* in the literature and can be
regenerated exactly.  Two exactness classes, marked per instance:

EXACT — the generator reproduces the published instance bit-for-data:
  * CVXQP1/2/3 {S,M,L} (Calamai & More via CUTE): for i = 1..n the
    objective group i is (x_i + x_{(2i-1 mod n)+1} + x_{(3i-1 mod n)+1})
    squared with weight i/2; constraint rows i = 1..m are
    x_i + 2 x_{(4i-1 mod n)+1} + 3 x_{(5i-1 mod n)+1} = 6; bounds
    0.1 <= x <= 10.  m = n/2, n/4, 3n/4 for families 1/2/3; n = 100 (S),
    1000 (M), 10000 (L).  Validated: solved objectives at S size match the
    set's published optima to 8-9 digits (1.1590718e4 / 8.1209405e3 /
    1.1943432e4), see tests/test_maros.py.
  * POWELL20 (n = m = 10000): min 0.5 sum x_i^2 subject to the cyclic
    constraints x_{i+1} - x_i >= -0.5 + (-1)^i i.  Validated: converges to
    the published optimum 5.2089583e10 (rel 4e-9 at tight tolerance).

ANALOGUE — the published *problem class* at the published scale, with data
vectors chosen deterministically here because the original data files are
not recallable from their formulations alone:
  * LISWET1A/2A/3A (n = 10002, m = 10000): the Li & Swetits k-convex
    data-smoothing QP with the exact published structure (Q = I, A = the
    second-difference operator, one-sided constraints >= 0); the data
    is c_i = g(t_i) + 0.1 sin(i), t_i = (i-1)/(n-1), with g = sqrt(t),
    |t - 1/2|, sin(pi t) for the three variants.
  * AUG2D-A (n = 20200, m = 10000): the expanded-system 2-D grid QP class
    at AUG2D's exact dimensions — edge variables on a 100x100 cell grid,
    one discrete-divergence equality per cell, separable quadratic
    objective pulling edges to a smooth target field.
  * CONT-050A / CONT-100A: elliptic PDE control at the CONT-* scale —
    5-point Laplacian equality constraints on a K x K interior grid
    (m = (K-1)^2), state variables + boundary controls with box bounds,
    tracking objective 0.5 h^2 ||y - yd||^2 + 0.5 alpha ||u||^2.

Run `python scripts/run_qps_suite.py benchmarks/qps_mm --route auto` for
the MM protocol sweep (results: benchmarks/RESULTS_maros.md).
"""

import os
import sys

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from qpalm_jax.io.qps import save_qps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "benchmarks", "qps_mm")


def cvxqp(n: int, family: int):
    """EXACT CVXQP{family} instance (see module docstring)."""
    m = {1: n // 2, 2: n // 4, 3: 3 * n // 4}[family]
    i = np.arange(1, n + 1)
    rows = np.repeat(np.arange(n), 3)
    cols = np.stack([(i - 1) % n, (2 * i - 1) % n, (3 * i - 1) % n],
                    axis=1).ravel()
    P = sp.coo_matrix((np.ones(3 * n), (rows, cols)), shape=(n, n)).tocsr()
    # objective sum_i (i/2) (p_i'x)^2  ==  0.5 x'Qx with Q = P' diag(i) P
    Q = (P.T @ sp.diags(i.astype(float)) @ P).tocsc()
    ic = np.arange(1, m + 1)
    rows = np.repeat(np.arange(m), 3)
    cols = np.stack([(ic - 1) % n, (4 * ic - 1) % n, (5 * ic - 1) % n],
                    axis=1).ravel()
    vals = np.tile(np.array([1.0, 2.0, 3.0]), m)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsc()
    beq = np.full(m, 6.0)
    return dict(Q=Q, A=A, q=np.zeros(n), bmin=beq, bmax=beq,
                lvar=np.full(n, 0.1), uvar=np.full(n, 10.0))


def powell20(n: int = 10000):
    """EXACT POWELL20: min 0.5||x||^2, x_{i+1} - x_i >= -0.5 + (-1)^i i."""
    i = np.arange(1, n + 1, dtype=float)
    rhs = -0.5 + ((-1.0) ** i) * i
    rows = np.concatenate([np.arange(n), np.arange(n)])
    cols = np.concatenate([(np.arange(n) + 1) % n, np.arange(n)])
    vals = np.concatenate([np.ones(n), -np.ones(n)])
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsc()
    return dict(Q=sp.eye(n, format="csc"), A=A, q=np.zeros(n),
                bmin=rhs, bmax=np.full(n, np.inf))


def liswet(g, n_data: int = 10000, k: int = 2):
    """ANALOGUE LISWET: min 0.5 sum (x_i - c_i)^2 s.t. D2 x >= 0."""
    n = n_data + k
    t = (np.arange(1, n + 1) - 1) / (n - 1)
    c = g(t) + 0.1 * np.sin(np.arange(1, n + 1, dtype=float))
    rows = np.repeat(np.arange(n_data), 3)
    cols = (np.arange(n_data)[:, None] + np.array([0, 1, 2])[None]).ravel()
    vals = np.tile(np.array([1.0, -2.0, 1.0]), n_data)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n_data, n)).tocsc()
    # 0.5||x - c||^2 = 0.5 x'x - c'x + const; fold the constant into c0
    return dict(Q=sp.eye(n, format="csc"), A=A, q=-c,
                bmin=np.zeros(n_data), bmax=np.full(n_data, np.inf),
                c=0.5 * float(c @ c))


def aug2d_analogue(M: int = 100, N: int = 100):
    """ANALOGUE AUG2D: edge flows on an MxN cell grid, one divergence
    equality per cell; objective pulls edges to a smooth target field."""
    nh = M * (N + 1)          # horizontal edges x(i,j), i=1..M, j=1..N+1
    nv = (M + 1) * N          # vertical edges   y(i,j), i=1..M+1, j=1..N
    n = nh + nv

    def hx(i, j):             # 0-based (i in 0..M-1, j in 0..N)
        return i * (N + 1) + j

    def vx(i, j):             # 0-based (i in 0..M, j in 0..N-1)
        return nh + i * N + j

    rows, cols, vals = [], [], []
    m = M * N
    for i in range(M):
        for j in range(N):
            r = i * N + j
            rows += [r, r, r, r]
            cols += [hx(i, j + 1), hx(i, j), vx(i + 1, j), vx(i, j)]
            vals += [1.0, -1.0, 1.0, -1.0]
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsc()
    ii, jj = np.meshgrid(np.arange(M), np.arange(N), indexing="ij")
    b = (np.sin(2 * np.pi * (ii + 0.5) / M)
         * np.cos(2 * np.pi * (jj + 0.5) / N)).ravel()
    # target field: smooth ramp over the grid
    th = np.fromiter((np.cos(np.pi * i / M) + np.sin(np.pi * j / (N + 1))
                      for i in range(M) for j in range(N + 1)), float, nh)
    tv = np.fromiter((np.sin(np.pi * i / (M + 1)) + np.cos(np.pi * j / N)
                      for i in range(M + 1) for j in range(N)), float, nv)
    tgt = np.concatenate([th, tv])
    return dict(Q=sp.eye(n, format="csc"), A=A, q=-tgt, bmin=b, bmax=b,
                c=0.5 * float(tgt @ tgt))


def cont_analogue(K: int):
    """ANALOGUE CONT-*: elliptic control.  State y on the (K-1)^2 interior
    nodes of a (K+1)x(K+1) grid (h = 1/K), controls u on the K-1 interior
    bottom-boundary nodes (other boundaries zero).  Constraints: the 5-point
    Laplacian at each interior node.  Objective: 0.5 h^2 ||y - yd||^2 +
    0.5 alpha ||u||^2, controls bounded in [-2, 2], states in [-30, 30]."""
    h = 1.0 / K
    ny = (K - 1) ** 2
    nu = K - 1
    n = ny + nu

    def yx(i, j):             # i, j in 1..K-1 -> index
        return (i - 1) * (K - 1) + (j - 1)

    rows, cols, vals = [], [], []
    for i in range(1, K):
        for j in range(1, K):
            r = yx(i, j)
            rows.append(r); cols.append(yx(i, j)); vals.append(4.0)
            for (ii, jj) in ((i - 1, j), (i + 1, j), (i, j - 1), (i, j + 1)):
                if 1 <= ii <= K - 1 and 1 <= jj <= K - 1:
                    rows.append(r); cols.append(yx(ii, jj)); vals.append(-1.0)
                elif ii == 0 and 1 <= jj <= K - 1:
                    # bottom boundary y(0, j) = u_j couples into the stencil
                    rows.append(r); cols.append(ny + jj - 1); vals.append(-1.0)
                # other boundaries are fixed at zero: no entry
    A = sp.coo_matrix((vals, (rows, cols)), shape=(ny, n)).tocsc()
    xg, yg = np.meshgrid(np.arange(1, K) * h, np.arange(1, K) * h,
                         indexing="ij")
    yd = (np.sin(2 * np.pi * xg) * np.sin(np.pi * yg)).ravel()
    alpha = 0.01
    Q = sp.diags(np.concatenate([np.full(ny, h * h),
                                 np.full(nu, alpha)])).tocsc()
    q = np.concatenate([-h * h * yd, np.zeros(nu)])
    lvar = np.concatenate([np.full(ny, -30.0), np.full(nu, -2.0)])
    uvar = np.concatenate([np.full(ny, 30.0), np.full(nu, 2.0)])
    return dict(Q=Q, A=A, q=q, bmin=np.zeros(ny), bmax=np.zeros(ny),
                c=0.5 * h * h * float(yd @ yd), lvar=lvar, uvar=uvar)


def main():
    os.makedirs(OUT, exist_ok=True)
    suite = []
    for fam in (1, 2, 3):
        for tag, n in (("S", 100), ("M", 1000), ("L", 10000)):
            suite.append((f"CVXQP{fam}_{tag}", cvxqp(n, fam)))
    suite.append(("POWELL20", powell20()))
    suite.append(("LISWET1A", liswet(np.sqrt)))
    suite.append(("LISWET2A", liswet(lambda t: np.abs(t - 0.5))))
    suite.append(("LISWET3A", liswet(lambda t: np.sin(np.pi * t))))
    suite.append(("AUG2D-A", aug2d_analogue()))
    suite.append(("CONT-050A", cont_analogue(50)))
    suite.append(("CONT-100A", cont_analogue(100)))
    for name, p in suite:
        path = os.path.join(OUT, f"{name}.qps")
        save_qps(path, p["Q"], p["A"], p["q"], p["bmin"], p["bmax"],
                 c=p.get("c", 0.0), name=name, lvar=p.get("lvar"),
                 uvar=p.get("uvar"))
        nnz = p["Q"].nnz + p["A"].nnz
        print(f"{name:<12} n={p['Q'].shape[0]:>6} m={p['A'].shape[0]:>6} "
              f"nnz={nnz:>7} -> {os.path.getsize(path)/1e6:.2f} MB")


if __name__ == "__main__":
    main()
