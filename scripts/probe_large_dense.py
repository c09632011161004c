#!/usr/bin/env python
"""Primitive-level probe for the n >= 512 device-resident single-QP path.

Measures what XLA's own primitives cost on the device at the shapes of
the n >= 512 single-QP regime (single QP, f32):

  * Schur assembly  M = Q + (w * A)' A + beta I      (one dense product)
  * cholesky(M)                                       (XLA blocked)
  * two triangular solves with ONE rhs vector         (latency-bound?)
  * the composed Newton step

Timed with a lax.fori_loop of REPS inside one jit with a carry-dependent
input, so no two reps see the same operands.  Prints per-op ms and
GFLOP/s.  Compare against the host sparse-direct numbers on the same
shapes (scripts/bench_large_single.py).
"""
import json
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

REPS = 20


def time_fn(fn, *args):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / REPS


def probe(n, m, seed=0):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n)).astype(np.float32)
    Q = jnp.asarray(G @ G.T / n + 2.0 * np.eye(n, dtype=np.float32))
    A = jnp.asarray(rng.standard_normal((m, n)).astype(np.float32))
    g = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    w0 = jnp.asarray(rng.random(m).astype(np.float32) + 0.5)

    with jax.default_matmul_precision("highest"):

        @jax.jit
        def assemble(w0):
            def body(i, carry):
                w, acc = carry
                M = Q + (w[:, None] * A).T @ A
                return (w + 1e-6, acc + M[0, 0])
            return jax.lax.fori_loop(0, REPS, body, (w0, jnp.float32(0)))[1]

        @jax.jit
        def chol(w0):
            M = Q + (w0[:, None] * A).T @ A
            def body(i, carry):
                Mi, acc = carry
                L = jnp.linalg.cholesky(Mi)
                return (Mi + 1e-6, acc + L[0, 0])
            return jax.lax.fori_loop(0, REPS, body, (M, jnp.float32(0)))[1]

        @jax.jit
        def trisolve(w0):
            M = Q + (w0[:, None] * A).T @ A
            L = jnp.linalg.cholesky(M)
            def body(i, carry):
                gi, acc = carry
                z = jax.scipy.linalg.solve_triangular(L, gi, lower=True)
                d = jax.scipy.linalg.solve_triangular(L.T, z, lower=False)
                return (gi + 1e-6, acc + d[0])
            return jax.lax.fori_loop(0, REPS, body, (g, jnp.float32(0)))[1]

        @jax.jit
        def newton(w0):
            def body(i, carry):
                w, acc = carry
                M = Q + (w[:, None] * A).T @ A
                L = jnp.linalg.cholesky(M)
                z = jax.scipy.linalg.solve_triangular(L, g, lower=True)
                d = jax.scipy.linalg.solve_triangular(L.T, z, lower=False)
                return (w + 1e-6, acc + d[0])
            return jax.lax.fori_loop(0, REPS, body, (w0, jnp.float32(0)))[1]

    r = {}
    r["assemble_ms"] = time_fn(assemble, w0) * 1e3
    r["chol_ms"] = time_fn(chol, w0) * 1e3
    r["trisolve_ms"] = time_fn(trisolve, w0) * 1e3
    r["newton_ms"] = time_fn(newton, w0) * 1e3
    flops = 2.0 * n * n * m + n ** 3 / 3.0 + 2.0 * n * n
    r["newton_gflops"] = flops / (r["newton_ms"] / 1e3) / 1e9
    return r


def main():
    print(f"backend: {jax.default_backend()}  {jax.devices()}")
    for n in (256, 512, 1024, 2048):
        m = (3 * n) // 2
        r = probe(n, m)
        print(json.dumps({"n": n, "m": m,
                          **{k: round(v, 3) for k, v in r.items()}}),
              flush=True)


if __name__ == "__main__":
    main()
