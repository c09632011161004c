#!/usr/bin/env python
"""Micro-profiler for the solver's component ops.

Equivalent of the reference's micro-benchmarks (reference:
profiling/profile.c:47-61 — 1000x mat_tpose_vec timing loops).  Each op is
timed inside a device-side fori_loop (default 50 reps per measurement), so
one dispatch's launch cost is spread over the reps.

Usage: python scripts/profile_ops.py [--batch 512] [--n 64] [--m 96]
       [--platform cpu|gpu] [--reps 50]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from qpalm_jax.io.cli import PLATFORMS, use_platform  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--m", type=int, default=96)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--platform", choices=PLATFORMS, default=None,
                    help="JAX backend (default: JAX's default backend)")
    ap.add_argument("--dtype", default="float32")
    args = ap.parse_args(argv)

    use_platform(args.platform)
    import jax
    import jax.numpy as jnp
    from jax.scipy.linalg import solve_triangular

    B, n, m, reps = args.batch, args.n, args.m, args.reps
    dt = jnp.dtype(args.dtype)
    rng = np.random.default_rng(0)
    Mx = rng.standard_normal((B, n, n)).astype(dt)
    Q = jnp.asarray(Mx @ np.transpose(Mx, (0, 2, 1)) / n + 0.5 * np.eye(n, dtype=dt))
    A = jnp.asarray(rng.standard_normal((B, m, n)).astype(dt))
    x = jnp.asarray(rng.standard_normal((B, n)).astype(dt))
    w = jnp.asarray(rng.random((B, m)).astype(dt))
    bp = jnp.asarray(rng.standard_normal((B, 2 * m)).astype(dt))

    def timeit(name, make_body):
        @jax.jit
        def looped(*arrays):
            def body(i, c):
                out = make_body(i, c, *arrays)
                return c + out * jnp.asarray(1e-9, dt)
            return jax.lax.fori_loop(0, reps, body, jnp.zeros((B,), dt))

        arrays = (Q, A, x, w, bp)
        o = looped(*arrays)
        jax.block_until_ready(o)
        np.asarray(o)
        ts = []
        for k in range(3):
            pert = tuple(a * (1 + 1e-7 * (k + 1)) for a in arrays)
            t0 = time.perf_counter()
            o = looped(*pert)
            jax.block_until_ready(o)
            np.asarray(o)
            ts.append(time.perf_counter() - t0)
        print(f"{name:<34} {min(ts)/reps*1e3:8.3f} ms/op  "
              f"({B} lanes, n={n}, m={m})")

    timeit("noop (loop-iteration floor)",
           lambda i, c, Q, A, x, w, bp: c * jnp.asarray(1.000001, dt))
    timeit("matvec A@x",
           lambda i, c, Q, A, x, w, bp:
           jnp.einsum('bmn,bn->bm', A, x + c[:, None] * 1e-12)[:, 0])
    timeit("matvec A'w",
           lambda i, c, Q, A, x, w, bp:
           jnp.einsum('bmn,bm->bn', A, w + c[:, None] * 1e-12)[:, 0])
    timeit("schur assembly Q + A'SA",
           lambda i, c, Q, A, x, w, bp:
           (Q + jnp.einsum('bmn,bmk->bnk', A * w[:, :, None], A))[:, 0, 0])

    def chol_op(i, c, Q, A, x, w, bp):
        L = jnp.linalg.cholesky(Q + c[:, None, None] * 1e-12)
        return L[:, 0, 0]
    timeit("cholesky", chol_op)

    def solve_op(i, c, Q, A, x, w, bp):
        L = jnp.linalg.cholesky(Q)
        y = solve_triangular(L, (x + c[:, None] * 1e-12)[..., None], lower=True)
        return solve_triangular(L, y, lower=True, trans=1)[:, 0, 0]
    timeit("cholesky + 2 trisolves", solve_op)

    timeit("linesearch sort (2m breakpoints)",
           lambda i, c, Q, A, x, w, bp:
           jnp.sort(bp + c[:, None] * 1e-12, axis=-1)[:, 0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
