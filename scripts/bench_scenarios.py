#!/usr/bin/env python
"""The 10k-scenario config from BASELINE.md's north-star list: 10,240
vmapped scenario QPs (n=16, m=24, f32, eps 1e-4) on one device through
the vmapped XLA solve loop; asserts the 99.9% solved bar and reports the
median of 3 distinct perturbed repetitions, plus a tier certified at 1e-6
by the device polish.

Usage: timeout 1800 python scripts/bench_scenarios.py
"""
import json
import statistics
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

B, N, M = 10240, 16, 24


def make(k):
    rng = np.random.default_rng(11)
    base = []
    for _ in range(B):
        Mx = rng.standard_normal((N, N)) * (rng.random((N, N)) < 0.5)
        Q = Mx @ Mx.T / N + 0.1 * np.eye(N)
        A = rng.standard_normal((M, N))
        q = rng.standard_normal(N)
        u = 2 * rng.random(M)
        base.append((Q, A, q, -u, u))
    return [(Q, A, q * (1.0 + 1e-6 * k), lo, hi)
            for (Q, A, q, lo, hi) in base]


def main():
    from qpalm_jax.batch import solve_batch_jit, stack_problems
    from qpalm_jax.compile_cache import enable_compile_cache
    from qpalm_jax.polish import polish_batch_np
    from qpalm_jax.polish_device import polish_batch_device
    from qpalm_jax.types import Settings

    enable_compile_cache()
    dev = jax.devices()[0]
    s = Settings(dtype="float32", eps_abs=1e-4, eps_rel=1e-4, max_iter=320,
                 scaling=2, max_refine=0, delta=10.0)
    problems = [make(k) for k in range(4)]
    datas = [stack_problems(p, np.float32) for p in problems]
    zx = jnp.zeros(datas[0].q.shape, jnp.float32)
    zy = jnp.zeros(datas[0].bmin.shape, jnp.float32)
    gamma = jnp.full((B,), s.gamma_init, jnp.float32)

    def solve(k):
        return solve_batch_jit(datas[k], zx, zy, gamma, s, False, False)

    r = solve(0)  # compile + warm
    st = np.asarray(r.status)
    times = []
    for k in (1, 2, 3):
        t0 = time.perf_counter()
        r = solve(k)
        st = np.asarray(r.status)  # forces the fetch inside the timed region
        times.append(time.perf_counter() - t0)
    solved = int((st == 1).sum())
    dt = statistics.median(times)

    # ---- certified tier: the same batch CERTIFIED at 1e-6 ----
    # f32 pass + on-device polish (qpalm_jax.polish_device, margin-gated
    # f32-'highest' check) in the timed region; an untimed native-f64
    # host referee re-checks every certified lane of the last rep.
    datas64h = [stack_problems(p, np.float64, host=True) for p in problems]
    datas64d = [jax.tree.map(jnp.asarray, d) for d in datas64h]

    def run_cert(k):
        r = solve(k)
        pd = polish_batch_device(datas64d[k], r.x, r.y,
                              eps_abs=1e-6, eps_rel=1e-6, refine_iters=3,
                              second_round_k=256, seed_guard="norm",
                              residual32=True, accept_viol=0.5)
        return np.asarray(pd.ok), pd

    run_cert(0)  # compile + warm (untimed)
    cert_times, n_cert = [], 0
    for k in (1, 2, 3):
        t0 = time.perf_counter()
        ok, pd = run_cert(k)
        cert_times.append(time.perf_counter() - t0)
        n_cert = int(ok.sum())
    cdt = statistics.median(cert_times)
    # untimed host referee on the last rep's certified lanes
    chk = polish_batch_np(
        jax.tree.map(lambda a: a[ok], datas64h[3]),
        np.asarray(pd.x)[ok], np.asarray(pd.y)[ok],
        eps_abs=1e-6, eps_rel=1e-6, rounds=0)
    ref_agree = int(np.asarray(chk.ok).sum())

    out = {
        "metric": "scenario_qps_per_sec_10k_batch",
        "value": round(B / dt, 1),
        "unit": "solves/s",
        "detail": {
            "B": B, "n": N, "m": M, "eps": 1e-4,
            "solved_last_rep": solved,
            "rep_s": [round(t, 4) for t in times],
            "device": {"platform": dev.platform,
                       "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "certified_1e-6": {
                "solves_per_s": round(n_cert / cdt, 1),
                "certified_last_rep": n_cert, "of": B,
                "rep_s": [round(t, 4) for t in cert_times],
                "referee_agree": ref_agree, "referee_checked": n_cert,
            },
        },
    }
    print(json.dumps(out))
    # a knife-edge f32 lane per ~10k is expected (the batch API's f64
    # escalation exists for exactly that tail); the bar is 99.9%
    assert solved >= B - max(1, B // 1000), solved
    assert n_cert >= int(0.99 * B), n_cert
    assert ref_agree == n_cert, (ref_agree, n_cert)
    return 0


if __name__ == "__main__":
    sys.exit(main())
