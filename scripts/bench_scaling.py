#!/usr/bin/env python
"""Scaling report: solver throughput at 1/2/4/8 mesh devices.

The BASELINE.md north-star list asks for "iterations/s at 1 chip, 1 host,
N>=2 hosts".  This script measures the two sharded programs on
a virtual CPU mesh — the same programs the driver's multi-chip dryrun
compiles — and reports *relative* scaling:

  * DP weak scaling: `parallel.sharded.solve_batch_sharded` with a fixed
    per-device batch, mesh sizes 1/2/4/8.  Ideal weak scaling = flat time,
    solves/s proportional to devices.
  * Stage-sharded distribution overhead: `solve_mpc_stage_sharded` on a
    fixed chain-of-masses horizon split over 1/2/4/8 stage shards.  On
    virtual devices every collective is synthetic overhead (no real interconnect, and the
    1-device run already uses all host cores), so true strong scaling
    CANNOT appear here; the table reports the overhead factor of the
    distributed program at matched iterates — the price the SPIKE/cyclic-
    reduction structure pays, to be amortized by real per-chip compute.

CAVEAT (printed in the output): the "devices" are XLA host-platform virtual
devices on a 4-core CPU — beyond 4 devices the cores are oversubscribed, so
efficiency numbers are a LOWER bound on what real devices with a real interconnect deliver;
collective correctness is asserted against the sequential solver elsewhere
(tests/test_mpc_loop.py, tests/test_sharded.py equivalents).

Writes benchmarks/RESULTS_scaling.md and prints one JSON line.
"""

import json
import os
import sys
import time

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402


def median_time(fn, reps=3):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from qpalm_jax import Settings, constants as C
    from qpalm_jax.batch import stack_problems
    from qpalm_jax.parallel.sharded import default_mesh, solve_batch_sharded
    from qpalm_jax.parallel.mpc_loop import (
        from_mpc_chain, solve_mpc_stage_sharded,
    )
    from qpalm_jax.workloads import mpc_chain, random_qp

    sizes = [1, 2, 4, 8]
    assert len(jax.devices()) >= 8, jax.devices()

    # ---- DP weak scaling ---------------------------------------------------
    B_PER_DEV, N, M = 48, 32, 48
    s = Settings(eps_abs=1e-4, eps_rel=1e-4, max_iter=200, scaling=2,
                 verbose=False)
    dp_rows = []
    for nd in sizes:
        B = B_PER_DEV * nd
        probs = [random_qp(N, M, seed=100 + i) for i in range(B)]
        data = stack_problems(probs, np.float64)
        n_pad = data.q.shape[1]
        m_pad = data.bmin.shape[1]
        mesh = default_mesh(nd)
        gam = jnp.full((B,), s.gamma_init)
        zx = jnp.zeros((B, n_pad))
        zy = jnp.zeros((B, m_pad))

        def run():
            res, agg = solve_batch_sharded(
                data, zx, zy, gam, s, False, False, mesh
            )
            jax.block_until_ready(res.x)
            return agg

        agg = run()  # compile + correctness
        n_solved = int(agg["n_solved"])
        total_iters = int(agg["total_iters"])
        assert n_solved == B, (nd, n_solved)
        t = median_time(run)
        dp_rows.append({
            "devices": nd, "batch": B, "time_s": round(t, 4),
            "solves_per_s": round(B / t, 1),
            "iters_per_s": round(int(total_iters) / t, 1),
        })

    base = dp_rows[0]["solves_per_s"]
    for r in dp_rows:
        r["weak_efficiency"] = round(
            r["solves_per_s"] / (base * r["devices"]), 3)

    # ---- stage-sharded strong scaling --------------------------------------
    H, A, q, bmin, bmax, meta = mpc_chain(10, 128, seed=3)
    sdata = from_mpc_chain(H, A, q, bmin, bmax, meta)
    ss = Settings(eps_abs=1e-6, eps_rel=1e-6, max_iter=500, scaling=2,
                  verbose=False)
    st_rows = []
    for nd in sizes:
        mesh = default_mesh(nd, axis_name="stage")

        def run():
            res = solve_mpc_stage_sharded(sdata, ss, mesh, "stage")
            jax.block_until_ready(res.z)
            return res

        res = run()
        assert int(res.status) == C.QPALM_SOLVED, (nd, int(res.status))
        iters = int(res.iterations)
        t = median_time(run)
        st_rows.append({
            "devices": nd, "time_s": round(t, 4), "iterations": iters,
            "iters_per_s": round(iters / t, 1),
        })
    base_t = st_rows[0]["time_s"]
    for r in st_rows:
        r["overhead_factor"] = round(r["time_s"] / base_t, 3)

    # ---- report ------------------------------------------------------------
    lines = [
        "# Scaling report (virtual CPU mesh)",
        "",
        "Generated by `python scripts/bench_scaling.py`.  Devices are XLA",
        "host-platform virtual devices on a 4-core CPU: beyond 4 devices the",
        "cores are oversubscribed, so these efficiencies are a LOWER bound",
        "for real devices with a real interconnect.  The same sharded programs compile and run",
        "on real meshes via `__graft_entry__.dryrun_multichip`.",
        "",
        "## DP weak scaling (solve_batch_sharded, "
        f"{B_PER_DEV} QPs/device, n={N}, m={M})",
        "",
        "| devices | batch | time (s) | solves/s | weak efficiency |",
        "|---|---|---|---|---|",
    ]
    for r in dp_rows:
        lines.append(f"| {r['devices']} | {r['batch']} | {r['time_s']} | "
                     f"{r['solves_per_s']} | {r['weak_efficiency']} |")
    lines += [
        "",
        "## Stage-sharded distribution overhead (solve_mpc_stage_sharded, "
        "chain of 10 masses, horizon 128)",
        "",
        "Identical iterates at every mesh size (asserted); the overhead",
        "factor is the whole price of distribution on a virtual mesh —",
        "real chips add per-device compute that this mesh cannot.",
        "",
        "| devices | time (s) | P-ALM iterations | iters/s | overhead "
        "factor |",
        "|---|---|---|---|---|",
    ]
    for r in st_rows:
        lines.append(f"| {r['devices']} | {r['time_s']} | "
                     f"{r['iterations']} | {r['iters_per_s']} | "
                     f"{r['overhead_factor']} |")
    lines.append("")
    out_path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks", "RESULTS_scaling.md")
    with open(out_path, "w") as f:
        f.write("\n".join(lines))
    print(json.dumps({"dp": dp_rows, "stage": st_rows, "report": out_path}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
