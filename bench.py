#!/usr/bin/env python
"""Headline benchmark: certified batched QP solves/s on one GPU at eps 1e-6.

    python bench.py        # prints one JSON result line; exit 0 on success

Protocol (north star in BASELINE.md: beat C-QPALM wall-clock at matched
tolerance, eps 1e-6, against a C-comparable baseline):

* K rounds x B random strictly-convex QPs (n=64, m=96, 50%-dense — the
  protocol of reference simulations/randomQP.m scaled up), all distinct.
* Pipelined certified solve, all wall-clock charged:
    - device pass: the vmapped XLA solve loop (`batch.solve_batch_jit`) in
      float32 at eps 5e-5 (delta=10 keeps the Schur conditioning inside
      f32 range);
    - device polish (`polish_device.polish_batch_device`): active-set KKT
      solve + f64 KKT check on the device, with a worst-64 second-chance
      round;
    - host leg per round: the failing lanes get a fresh native C/LAPACK
      f64 solve (+ numpy P-ALM fallback) in a background rescue thread,
      re-certified by the host polish KKT check.
  Rounds run one after another: the vmapped while_loop's host-side trip
  control blocks the dispatching thread for the whole solve, so deeper
  dispatch does not overlap rounds (measured on an H100: depth 2 was no
  faster than depth 1).  The rescue thread overlaps the next rounds.
* Every reported solve is certified at 1e-6 on the *unscaled* problem;
  every device-certified lane of the median rep is re-checked on the host
  in native f64 (detail.referee) and dropped from the count on
  disagreement.
* Baseline: the native single-threaded C/LAPACK solver
  (native/qpalm_baseline.cpp) on the same problems at eps 1e-6.
* The headline `value` is the MEDIAN of the timed repetitions; every rep
  is disclosed in detail.pipeline_s_reps.

The benchmark runs in one process on JAX's default backend.  Where that is
not a GPU it exits nonzero and prints no result line: a number from
another device is never reported under this metric.  Every result names
the platform, device kind, device count, and the card's name and power
limit.
"""

import json
import os
import statistics
import sys
import time

import numpy as np

from qpalm_jax.certify import (EPS_F32, EPS_TARGET, card_name_power,
                               device_summary, f32_settings, lockstep_iters,
                               make_problems, polish_round, referee,
                               require_gpu, rescue_lanes)

K_ROUNDS = int(os.environ.get("QPALM_BENCH_K", "8"))
REPS = int(os.environ.get("QPALM_BENCH_REPS", "5"))
B = int(os.environ.get("QPALM_BENCH_B", "512"))
N_DIM = 64
M_DIM = 96
EPS_F32 = float(os.environ.get("QPALM_BENCH_EPS32", str(EPS_F32)))
SAMPLE_BASELINE = 32

# Published peaks, keyed by jax `device_kind`.  The solver runs f32 at
# matmul precision 'highest' (qpalm_jax.precision), i.e. outside the
# tensor cores, so the f32 rate is its compute roof.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp32_flops_per_s": 67e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 data sheet, SXM: 67 TFLOP/s FP32 (non-"
                  "tensor-core), 3.35 TB/s HBM3, at 700 W",
    },
}


def peak_for(device_kind: str) -> dict:
    """The PEAKS entry of `device_kind`; an unknown kind is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peak for device kind "
                       f"{device_kind!r}; add it to bench.PEAKS") from None


def flops_per_lockstep_iter(n, m):
    """FLOPs one vmapped solver iteration executes per lane.  Under vmap
    every branch of the iteration switch runs, so the Schur refactorization
    (assembly + Cholesky) is charged every iteration:
      assembly A'SA: 2nnm   gershgorin: ~n^2    cholesky: n^3/3
      2 triangular solves: 2n^2    residual A'yh: 2nm
      linesearch Qd: 2n^2, Ad: 2nm  (sort not counted as FLOPs)
    """
    return (
        2.0 * n * n * m
        + n * n
        + n ** 3 / 3.0
        + 2.0 * n * n
        + 2.0 * n * m
        + 2.0 * n * m
        + 2.0 * n * n
    )


def measure_baseline(probs, deltas=(100.0, 10.0, 100.0, 10.0)):
    """Sequential native C/LAPACK at eps 1e-6 (the honest C-QPALM
    stand-in), repeated passes because the host jitters.

    Returns (best_throughput, per_pass_throughputs): the headline divisor
    is best-of-passes (the direction that *understates* our multiplier),
    and every pass is disclosed."""
    from qpalm_jax import baseline_c

    baseline_c.solve(*probs[0], eps_abs=EPS_TARGET, eps_rel=EPS_TARGET,
                     scaling=2, delta=100.0)  # warm up lib load
    best, reps = 0.0, []
    for delta in deltas:
        t0 = time.perf_counter()
        nb = 0
        for p in probs:
            r = baseline_c.solve(*p, eps_abs=EPS_TARGET, eps_rel=EPS_TARGET,
                                 scaling=2, delta=delta)
            nb += r["status"] == 1
        dt = (time.perf_counter() - t0) / len(probs)
        if nb == len(probs):
            reps.append(1.0 / dt)
            best = max(best, 1.0 / dt)
    return best, reps


def main():
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp

    from qpalm_jax import baseline_c
    from qpalm_jax.batch import solve_batch_jit, stack_problems
    from qpalm_jax.compile_cache import enable_compile_cache

    dev = require_gpu()
    enable_compile_cache()
    peak = peak_for(dev.device_kind)
    card = card_name_power()
    baseline_c.require_library()  # the rescue tier needs it: fail loudly

    rounds = [make_problems(B, N_DIM, M_DIM, seed=7 + 1000 * k)
              for k in range(REPS * K_ROUNDS)]
    s32 = f32_settings(EPS_F32)
    # ---- stage data: f32 + f64 stacks on the device, f64 on the host -----
    datas = [stack_problems(p, np.float32) for p in rounds]
    Bp, n_pad = datas[0].q.shape
    m_pad = datas[0].bmin.shape[1]
    zx = jnp.zeros((Bp, n_pad), jnp.float32)
    zy = jnp.zeros((Bp, m_pad), jnp.float32)
    gamma = jnp.full((Bp,), s32.gamma_init, jnp.float32)
    datas64 = [stack_problems(p, np.float64, host=True) for p in rounds]
    datas64d = [jax.tree.map(jnp.asarray, d) for d in datas64]

    def device_round(k):
        """f32 solve + device polish of round k; host (x, y, ok, iters)."""
        r = solve_batch_jit(datas[k], zx, zy, gamma, s32, False, False)
        pol = polish_round(datas64d[k], r.x, r.y)
        return jax.device_get((pol.x, pol.y, pol.ok, r.iterations))

    def rescue_round(k, idxs, x, y):
        sub = jax.tree.map(lambda a: a[idxs], datas64[k])
        return idxs, rescue_lanes(sub, x[idxs], y[idxs])[2]

    # ---- warm-up / compile (untimed) --------------------------------------
    t0 = time.perf_counter()
    device_round(0)
    compile_s = time.perf_counter() - t0

    phase_log = {"device": [], "host": [], "rescue": []}
    rescue_pool = ThreadPoolExecutor(max_workers=1)

    def run_pipeline(base):
        t0 = time.perf_counter()
        oks, results, rescue_futs = [], [], []
        for k in range(K_ROUNDS):
            td = time.perf_counter()
            x, y, ok, iters = device_round(base + k)
            tp = time.perf_counter()
            bad = np.where(~ok)[0]
            if len(bad):
                rescue_futs.append((k, rescue_pool.submit(
                    rescue_round, base + k, bad, x, y)))
            oks.append(ok)
            results.append((x, y, ok, iters))
            phase_log["device"].append(tp - td)
            phase_log["host"].append(time.perf_counter() - tp)
        tr = time.perf_counter()
        n_rescued = 0
        for k, fut in rescue_futs:
            idxs, ok2 = fut.result()
            oks[k] = oks[k].copy()
            oks[k][idxs] = ok2
            n_rescued += len(idxs)
        phase_log["rescue"].append(time.perf_counter() - tr)
        return time.perf_counter() - t0, oks, results, n_rescued

    reps = [run_pipeline(r * K_ROUNDS) for r in range(REPS)]
    rep_times = [r[0] for r in reps]
    total_time = statistics.median(rep_times)
    med_idx = min(range(REPS), key=lambda i: abs(rep_times[i] - total_time))
    _, oks, results, n_rescued = reps[med_idx]

    # ---- untimed host referee of the median rep ---------------------------
    ref_checked = ref_agree = 0
    for k_local, (x, y, dev_ok, _) in enumerate(results):
        host_ok = referee(datas64[med_idx * K_ROUNDS + k_local], x, y,
                          dev_ok)
        ref_checked += int(dev_ok.sum())
        ref_agree += int(host_ok.sum())
        if not host_ok.all():
            oks[k_local] = oks[k_local].copy()
            oks[k_local][np.where(dev_ok)[0][~host_ok]] = False

    n_total = K_ROUNDS * B
    n_solved = sum(int(ok.sum()) for ok in oks)
    n_solved_all = sum(int(ok.sum()) for r in reps for ok in r[1])
    throughput = n_solved / total_time

    # ---- FLOP accounting (lockstep: B x max iterations per round) ---------
    executed = sum(lockstep_iters(r[3]) for r in results)
    flops = executed * flops_per_lockstep_iter(n_pad, m_pad)
    flops_per_s = flops / total_time

    if os.environ.get("QPALM_BENCH_SKIP_BASELINE"):
        baseline_throughput, baseline_reps = 0.0, []
    else:
        baseline_throughput, baseline_reps = measure_baseline(
            rounds[0][:SAMPLE_BASELINE])

    out = {
        "metric": "qp_solves_per_sec_per_chip_at_1e-6",
        "value": round(throughput, 2),
        "unit": "solves/s",
        "vs_baseline": round(throughput / baseline_throughput, 2)
        if baseline_throughput else None,
        "device": device_summary(),
        "card": card,
        "detail": {
            "rounds": K_ROUNDS, "batch": B, "n": N_DIM, "m": M_DIM,
            "eps_certified": EPS_TARGET, "eps_f32_pass": EPS_F32,
            "solved": n_solved, "total": n_total,
            "solved_all_reps": n_solved_all,
            "total_all_reps": REPS * n_total,
            "pipeline_s": round(total_time, 4),
            "pipeline_s_reps": [round(t, 4) for t in rep_times],
            "headline_estimator": "median_of_reps",
            "compile_s": round(compile_s, 2),
            "rescued_lanes": n_rescued,
            "lockstep_lane_iters": executed,
            "referee": {"checked": ref_checked, "agree": ref_agree},
            # per-round medians / p90 across all reps (ms): device = f32
            # solve + device polish + fetch; host = queueing the rescue;
            # rescue = join wait on the rescue thread at rep end
            "phase_ms_median": {
                k: round(1e3 * statistics.median(v), 2)
                for k, v in phase_log.items() if v
            },
            "phase_ms_p90": {
                k: round(1e3 * sorted(v)[int(0.9 * (len(v) - 1))], 2)
                for k, v in phase_log.items() if v
            },
            # solver FLOPs of the f32 pass over the whole pipeline time
            # (not kernel time): an end-to-end rate
            "solver_flops_per_s_e2e": round(flops_per_s, 1),
            "fp32_peak_share_e2e": round(
                flops_per_s / peak["fp32_flops_per_s"], 6),
            "peak_source": peak["source"],
            "baseline": "native C/LAPACK single-thread (qpalm_baseline.cpp)",
            "baseline_solves_per_s": round(baseline_throughput, 2),
            "baseline_reps": [round(b, 2) for b in baseline_reps],
            "baseline_estimator": "best_of_reps (conservative divisor)",
        },
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # no result line on failure
        print(f"bench failed: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
