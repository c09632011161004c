#!/usr/bin/env python
"""On-card smoke test: the solver's main paths at real sizes, each checked
against a plain reference.

    python chip_smoke.py               # one GPU: the single-card regimes
    python chip_smoke.py --four        # four GPUs: the multi-device paths
    python chip_smoke.py --trace DIR   # also profile one warm fleet solve

One GPU, through the public entry points:
  cholesky  one f32 Newton step of the solver's own jitted entries (the
            batched chunk at B=512, n=64; the single-problem chunk at
            n=1024), each refactoring its Schur matrix at the precision
            the library sets: ||L L' - M||_F / ||M||_F <= 1e-5 against M
            rebuilt in f64 (a TF32 product would miss this by ~100x);
  fleet     the certified pipeline: B=512 QPs (n=64, m=96) through
            `solve_batch` in f32 at eps 5e-5, the device polish at eps
            1e-6 on device f64 data, the host rescue and the host f64
            referee; every lane certified at 1e-6, the referee agreeing on
            every device-certified lane, and 32 objectives within
            1e-5 (1 + |f|) of the native f64 C solver;
  scenario  B=10240 QPs (n=16, m=24) in f32 at eps 1e-4: >= 99.9% solved,
            `solve_batch_escalate` finishing the rest, 64 lanes re-checked
            on the host in f64;
  large     `solve_large_dense` on random_qp(1024), every solution
            certified, re-checked on the host;
  api       the `QPALM` lifecycle in f64 (solve, warm_start,
            update_bounds, update_q, solve) against the same run on the
            CPU device: equal statuses, x within 1e-5 (1 + |x|_inf),
            iteration counts within 2;
  cli       `python -m qpalm_jax.io.cli benchmarks/maros/HS21.qps`, in
            this process.
Four GPUs (`--four`), each against its single-device run:
  dp        B=4x512 fleet sharded over the mesh: identical statuses;
  con       random_qp(1024, m=1024) with its constraints sharded, f64:
            same status, x within 1e-6 relative;
  stage     mpc_chain at horizon 80 stage-sharded, f64, against the
            sequential solve: same status, x within 1e-6 relative.

Each phase prints one JSON line: its compile and warm times, the memory
analysis of its main jitted step, the device's peak bytes in use so far,
and its checks.  The last line is `{"ok": true, "device": {...}}` only when
every phase passed; a failed check raises and the exit code is nonzero.
With no GPU the script exits nonzero before any phase.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import os
import sys
import time

import numpy as np

from qpalm_jax import certify

CHOL_TOL = 1e-5
OBJ_TOL = 1e-5
API_TOL = 1e-5
SHARD_TOL = 1e-6
MIN_SCENARIO_SOLVED = 0.999


class SmokeFailure(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def timed(fn, *args, **kw):
    """(fn(*args, **kw), wall seconds) with the result's device work done."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kw))
    return out, time.perf_counter() - t0


def warm_time(fn, *args, reps=3, **kw) -> float:
    return float(np.median([timed(fn, *args, **kw)[1] for _ in range(reps)]))


def memory_analysis(jitted, *args, **kw) -> dict:
    """Byte counts of `jitted`'s compiled program for these arguments."""
    ma = jitted.lower(*args, **kw).compile().memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes")
    return {f: int(getattr(ma, f)) for f in fields if hasattr(ma, f)}


def peak_bytes():
    import jax

    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


def _objective(prob, x):
    Q, _, q = prob[:3]
    x = x[: Q.shape[0]]
    return 0.5 * x @ Q @ x + q @ x


# ---------------------------------------------------------------------------
# one-GPU phases
# ---------------------------------------------------------------------------

def _active_state(st, data, rng):
    """`st` (a fresh solver state, batched or not) with penalties spread
    over three decades and about half of the real rows pushed past a bound
    through y, so the next Newton step factors a Schur matrix with a full
    A' S A term.  The inner tolerances are tightened so that the step is an
    inner (Newton) one and not an outer update."""
    import jax.numpy as jnp

    sigma = 10 ** rng.uniform(0, 3, st.sigma.shape)
    bmax = np.asarray(data.bmax, np.float64)
    push = (rng.random(sigma.shape) < 0.5) & (bmax < 1e3)
    y = np.where(push, sigma * (bmax + 1.0), 0.0)
    dt = st.sigma.dtype
    return st._replace(sigma=jnp.asarray(sigma, dt),
                       sqrt_sigma=jnp.sqrt(jnp.asarray(sigma, dt)),
                       sigma_inv=1.0 / jnp.asarray(sigma, dt),
                       y=jnp.asarray(y, dt),
                       eps_abs_in=jnp.full_like(st.eps_abs_in, 1e-12),
                       eps_rel_in=jnp.full_like(st.eps_rel_in, 1e-12))


def _schur_check(st, data, proximal):
    """||L L' - M||_F / ||M||_F of the solver's factor `st.L` against the
    Schur matrix M = Q + A' diag(sigma active) A [+ I/gamma] rebuilt in
    f64 from the same state, and L's relative distance from numpy's
    Cholesky of M; also the active fraction the step factored."""
    Q = np.asarray(data.Q, np.float64)
    A = np.asarray(data.A, np.float64)
    w = np.where(np.asarray(st.active),
                 np.asarray(st.sqrt_sigma, np.float64) ** 2, 0.0)
    M = Q + A.T @ (w[:, None] * A)
    if proximal:
        M += np.eye(M.shape[0]) / float(st.gamma)
    L = np.asarray(st.L, np.float64)
    Ln = np.linalg.cholesky(M)
    return (np.linalg.norm(L @ L.T - M) / np.linalg.norm(M),
            np.linalg.norm(L - Ln) / np.linalg.norm(Ln),
            float(np.asarray(st.active).mean()))


def phase_cholesky(B=512, n=64, n_big=1024, seed=0):
    """One Newton step of the solver's own jitted entries in f32: the
    batched chunk (`batch._batch_chunk`, B problems of size n) and the
    single-problem chunk (`api._solve_chunk`, n_big).  Each factors its
    Schur matrix in the refactor branch of `solver/core.py`, under the
    precision the library sets itself; the factor is checked against the
    same matrix in f64."""
    import jax
    import jax.numpy as jnp

    from qpalm_jax.api import _setup_and_init, _solve_chunk
    from qpalm_jax.batch import _batch_chunk, _batch_init, stack_problems
    from qpalm_jax.workloads import random_qp

    rng = np.random.default_rng(seed)
    s = certify.f32_settings().replace(verbose=False)
    data = stack_problems(certify.make_problems(B, n, 3 * n // 2, seed=seed),
                          np.float32)
    Bp, n_pad = data.q.shape
    zx = jnp.zeros((Bp, n_pad), jnp.float32)
    zy = jnp.zeros((Bp, data.bmin.shape[1]), jnp.float32)
    sts, sdata, scals = _batch_init(data, zx, zy, s, False)
    sts = _active_state(sts, sdata, rng)
    args = (sts, sdata, scals, s, 1)
    out, first_s = timed(_batch_chunk, *args)
    warm_s = warm_time(_batch_chunk, *args)
    mem = memory_analysis(_batch_chunk, *args)
    check(bool(np.asarray(out.factor_valid).all()), "no Newton step taken")
    res = [_schur_check(jax.tree.map(lambda a: a[i], out),
                        jax.tree.map(lambda a: a[i], sdata), s.proximal)
           for i in range(B)]
    resid = max(r[0] for r in res)
    diff = max(r[1] for r in res)
    active = float(np.mean([r[2] for r in res]))

    big = jax.tree.map(lambda a: a[0], stack_problems(
        [random_qp(n_big, seed=seed)], np.float32))
    st, sd, sc = _setup_and_init(big, jnp.zeros_like(big.q),
                                 jnp.zeros_like(big.bmin), s, False, False)
    st = _active_state(st, sd, rng)
    final = _solve_chunk(st, sd, sc, s, 1)[0]
    check(bool(final.factor_valid), "n_big: no Newton step taken")
    resid_big, diff_big, active_big = _schur_check(final, sd, s.proximal)
    check(min(active, active_big) >= 0.25,
          f"active fractions {active:.2f}, {active_big:.2f}: too few rows "
          "in A' S A")
    check(resid <= CHOL_TOL, f"batched cholesky residual {resid:.3e}")
    check(resid_big <= CHOL_TOL, f"n={n_big} cholesky residual "
                                 f"{resid_big:.3e}")
    return {"compile_s": first_s - warm_s, "warm_s": warm_s,
            "memory": mem, "batch": B, "n": n, "max_resid": resid,
            "max_rel_diff_vs_numpy": diff, "active_fraction": active,
            "n_big": n_big, "resid_big": resid_big,
            "rel_diff_big_vs_numpy": diff_big,
            "active_fraction_big": active_big, "tol": CHOL_TOL}


def trace_summary(logdir: str) -> dict:
    """Device time per kernel name from the newest profiler trace under
    `logdir`: busy time (union of kernel intervals over the window), the
    top kernels, and the Cholesky factorization's share of busy time."""
    import jax

    path = sorted(glob.glob(os.path.join(
        logdir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    per_name, spans = {}, []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        # kernels sit on the "Stream #..." lines; the module and op lines
        # repeat the same time at coarser grain
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                per_name[ev.name] = per_name.get(ev.name, 0) + ev.duration_ns
                spans.append((ev.start_ns, ev.end_ns))
    spans.sort()
    busy, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (max(e for _, e in spans) - spans[0][0]) if spans else 0
    chol = sum(v for k, v in per_name.items()
               if "potrf" in k.lower() or "cholesky" in k.lower())
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:12]
    return {"window_ns": window, "busy_ns": busy,
            "cholesky_ns": chol,
            "cholesky_share_of_busy": chol / busy if busy else None,
            "top_kernels_ns": top}


def phase_fleet(B=512, n=64, m=96, seed=7, n_ref=32, trace_dir=None):
    import jax
    import jax.numpy as jnp

    from qpalm_jax import baseline_c
    from qpalm_jax.batch import solve_batch, solve_batch_jit, stack_problems

    s32 = certify.f32_settings()
    probs = certify.make_problems(B, n, m, seed=seed)
    res, first_s = timed(solve_batch, probs, s32)
    data = stack_problems(probs, np.float32)
    Bp, n_pad = data.q.shape
    zx = jnp.zeros((Bp, n_pad), jnp.float32)
    zy = jnp.zeros((Bp, data.bmin.shape[1]), jnp.float32)
    g = jnp.full((Bp,), s32.gamma_init, jnp.float32)
    step_args = (data, zx, zy, g, s32, False, False)
    warm_s = warm_time(solve_batch_jit, *step_args)
    mem = memory_analysis(solve_batch_jit, *step_args)
    iters = np.asarray(res.iterations)
    out = {"compile_s": first_s - warm_s, "warm_s": warm_s, "memory": mem,
           "batch": B, "n": n, "m": m,
           "f32_solved": int((np.asarray(res.status) == 1).sum()),
           "max_iters": int(iters.max()), "mean_iters": float(iters.mean()),
           "lockstep_lane_iters": certify.lockstep_iters(iters),
           "ms_per_lockstep_iter": 1e3 * warm_s / max(int(iters.max()), 1)}
    if trace_dir:
        with jax.profiler.trace(trace_dir):
            timed(solve_batch_jit, *step_args)
        out["trace"] = trace_summary(trace_dir)

    d64 = stack_problems(probs, np.float64, host=True)
    d64d = jax.tree.map(jnp.asarray, d64)
    pol, pol_first = timed(certify.polish_round, d64d, res.x, res.y)
    pol_warm = warm_time(certify.polish_round, d64d, res.x, res.y)
    x, y = np.array(pol.x), np.array(pol.y)
    dev_ok = np.array(pol.ok)
    ok = dev_ok.copy()
    bad = np.where(~dev_ok)[0]
    t0 = time.perf_counter()
    if len(bad):
        sub = jax.tree.map(lambda a: a[bad], d64)
        x[bad], y[bad], ok[bad] = certify.rescue_lanes(sub, x[bad], y[bad])
    rescue_s = time.perf_counter() - t0
    host_ok = certify.referee(d64, x, y, dev_ok)

    baseline_c.require_library()
    obj_err = 0.0
    for i in range(min(n_ref, B)):
        r = baseline_c.solve(*probs[i], eps_abs=certify.EPS_TARGET,
                             eps_rel=certify.EPS_TARGET, scaling=2,
                             delta=100.0)
        check(r["status"] == 1, f"C baseline lane {i}: status {r['status']}")
        f_ref = _objective(probs[i], r["x"])
        obj_err = max(obj_err, abs(_objective(probs[i], x[i]) - f_ref)
                      / (1 + abs(f_ref)))
    out.update({
        "polish_compile_s": pol_first - pol_warm, "polish_warm_s": pol_warm,
        "device_certified": int(dev_ok.sum()), "rescued": len(bad),
        "rescue_s": rescue_s, "certified": int(ok.sum()),
        "referee_checked": int(dev_ok.sum()),
        "referee_agree": int(host_ok.sum()),
        "baseline_lanes": min(n_ref, B), "max_obj_rel_err": obj_err,
    })
    check(ok.all(), f"fleet: {int((~ok).sum())} lanes not certified")
    check(host_ok.all(), f"referee rejects {int((~host_ok).sum())} "
                         "device-certified lanes")
    check(obj_err <= OBJ_TOL, f"objective vs C baseline {obj_err:.3e}")
    return out


def phase_scenario(B=10240, n=16, m=24, seed=3, n_check=64):
    import jax.numpy as jnp

    from qpalm_jax import Settings
    from qpalm_jax.batch import (solve_batch, solve_batch_escalate,
                                 solve_batch_jit, stack_problems)
    from qpalm_jax.polish import polish_batch_np

    eps = 1e-4
    s = Settings(dtype="float32", eps_abs=eps, eps_rel=eps, scaling=2,
                 max_refine=0, delta=10.0)
    probs = certify.make_problems(B, n, m, seed=seed)
    res, first_s = timed(solve_batch, probs, s)
    data = stack_problems(probs, np.float32)
    Bp, n_pad = data.q.shape
    step_args = (data, jnp.zeros((Bp, n_pad), jnp.float32),
                 jnp.zeros((Bp, data.bmin.shape[1]), jnp.float32),
                 jnp.full((Bp,), s.gamma_init, jnp.float32), s, False, False)
    warm_s = warm_time(solve_batch_jit, *step_args)
    mem = memory_analysis(solve_batch_jit, *step_args)
    solved = np.asarray(res.status) == 1
    frac = float(solved.mean())
    check(frac >= MIN_SCENARIO_SOLVED, f"scenario solved fraction {frac}")
    # the unsolved lanes go through the f32 -> f64 escalation; with none,
    # a cut iteration budget forces it on a few lanes
    bad = np.where(~solved)[0]
    esc_idx = bad if len(bad) else np.arange(min(16, B))
    s_esc = s if len(bad) else s.replace(max_iter=3)
    esc, esc_s = timed(solve_batch_escalate,
                       [probs[i] for i in esc_idx], s_esc)
    check((np.asarray(esc.status) == 1).all(), "escalation left lanes")
    rng = np.random.default_rng(seed)
    sample = rng.choice(np.where(solved)[0], min(n_check, int(solved.sum())),
                        replace=False)
    d64 = stack_problems([probs[i] for i in sample], np.float64, host=True)
    chk = polish_batch_np(d64, np.asarray(res.x, np.float64)[sample],
                          np.asarray(res.y, np.float64)[sample],
                          eps_abs=eps, eps_rel=eps, rounds=0)
    host_ok = np.asarray(chk.ok)
    check(host_ok.all(), f"scenario host check rejects "
                         f"{int((~host_ok).sum())}/{len(sample)}")
    iters = np.asarray(res.iterations)
    return {"compile_s": first_s - warm_s, "warm_s": warm_s, "memory": mem,
            "batch": B, "n": n, "m": m, "solved_fraction": frac,
            "unsolved": len(bad), "escalated": len(esc_idx),
            "escalate_s": esc_s, "max_iters": int(iters.max()),
            "lockstep_lane_iters": certify.lockstep_iters(iters),
            "host_checked": len(sample), "host_ok": int(host_ok.sum())}


def phase_large(n=1024, seed=0):
    import jax.numpy as jnp

    from qpalm_jax.batch import solve_batch_jit, stack_problems
    from qpalm_jax.large import f32_settings, solve_large_dense
    from qpalm_jax.polish import polish_batch_np
    from qpalm_jax.workloads import random_qp

    prob = random_qp(n, seed=seed)
    res, first_s = timed(solve_large_dense, [prob])
    res2, warm_s = timed(solve_large_dense, [prob])
    s = f32_settings()
    data = stack_problems([prob], np.float32)
    mem = memory_analysis(
        solve_batch_jit, data, jnp.zeros_like(data.q),
        jnp.zeros_like(data.bmin), jnp.full((1,), s.gamma_init, jnp.float32),
        s, False, False)
    d64 = stack_problems([prob], np.float64, host=True)
    chk = polish_batch_np(d64, res.x, res.y, eps_abs=1e-6, eps_rel=1e-6,
                          rounds=0)
    check(res.ok.all(), "large dense: solution not certified")
    check(np.asarray(chk.ok).all(), "large dense: host check rejects")
    return {"compile_s": first_s - warm_s, "warm_s": warm_s, "memory": mem,
            "n": n, "m": n, "iterations": int(res.iterations[0]),
            "t_device_s": res2.t_device_s, "t_polish_s": res2.t_polish_s,
            "certified": int(res.ok.sum()),
            "host_ok": int(np.asarray(chk.ok).sum())}


def _lifecycle(prob, settings, seed):
    """solve; warm_start; update_bounds + update_q; solve."""
    from qpalm_jax import QPALM

    Q, A, q, bmin, bmax = prob
    rng = np.random.default_rng(seed)
    solver = QPALM(Q, A, q, bmin, bmax, settings=settings)
    r1 = solver.solve()
    solver.warm_start(r1.solution.x, r1.solution.y)
    solver.update_bounds(1.1 * bmin, 1.1 * bmax)
    solver.update_q(q + 0.1 * rng.standard_normal(q.shape))
    r2 = solver.solve()
    return solver, [r1, r2]


def phase_api(n=128, m=192, seed=5):
    import jax
    import jax.numpy as jnp

    from qpalm_jax import Settings
    from qpalm_jax.api import _setup_and_solve
    from qpalm_jax.workloads import random_qp

    prob = random_qp(n, m, seed=seed)
    s = Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False)
    t0 = time.perf_counter()
    solver, runs = _lifecycle(prob, s, seed)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _lifecycle(prob, s, seed)
    warm_s = time.perf_counter() - t0
    mem = memory_analysis(
        _setup_and_solve, solver._data, jnp.zeros_like(solver._data.q),
        jnp.zeros_like(solver._data.bmin), s, True, True)
    with jax.default_device(jax.devices("cpu")[0]):
        _, ref = _lifecycle(prob, s, seed)
    out = {"compile_s": first_s - warm_s, "warm_s": warm_s, "memory": mem,
           "n": n, "m": m, "solves": []}
    for k, (r, rr) in enumerate(zip(runs, ref)):
        dx = np.max(np.abs(r.solution.x - rr.solution.x)) / (
            1 + np.max(np.abs(rr.solution.x)))
        it, it_ref = int(r.info.iter), int(rr.info.iter)
        out["solves"].append({"status": r.info.status, "iter": it,
                              "iter_cpu": it_ref, "x_rel_diff": float(dx)})
        check(r.info.status == rr.info.status == "solved",
              f"api solve {k}: {r.info.status} vs cpu {rr.info.status}")
        check(dx <= API_TOL, f"api solve {k}: x differs {dx:.3e}")
        check(abs(it - it_ref) <= 2, f"api solve {k}: iter {it} vs {it_ref}")
    return out


HS21 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "benchmarks", "maros", "HS21.qps")
HS21_OBJECTIVE = -99.96  # published Maros-Meszaros optimum


def phase_cli(path=HS21, objective=HS21_OBJECTIVE):
    from qpalm_jax.io import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([path])
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    fields = dict(line.split(": ", 1) for line in text.splitlines()
                  if ": " in line)
    check(rc == 0, f"cli exit code {rc}")
    check(fields.get("Status") == "solved", f"cli status {fields}")
    obj = float(fields["Objective"])
    check(abs(obj - objective) <= 1e-4 * (1 + abs(objective)),
          f"cli objective {obj}")
    return {"wall_s": wall, "status": fields["Status"], "objective": obj,
            "iter": int(fields["Iter"])}


# ---------------------------------------------------------------------------
# four-GPU phases
# ---------------------------------------------------------------------------

def _spans(arr, ndev, what):
    n = len(arr.sharding.device_set)
    check(n == ndev, f"{what}: output on {n} devices, expected {ndev}")
    return n


def phase_dp(ndev=4, B_per=512, n=64, m=96, seed=11):
    import jax.numpy as jnp

    from qpalm_jax.batch import solve_batch_jit, stack_problems
    from qpalm_jax.parallel import default_mesh, solve_batch_sharded

    s32 = certify.f32_settings()
    data = stack_problems(certify.make_problems(ndev * B_per, n, m, seed=seed),
                          np.float32)
    Bp, n_pad = data.q.shape
    args = (data, jnp.zeros((Bp, n_pad), jnp.float32),
            jnp.zeros((Bp, data.bmin.shape[1]), jnp.float32),
            jnp.full((Bp,), s32.gamma_init, jnp.float32), s32, False, False)
    mesh = default_mesh(ndev)
    (res, agg), first_s = timed(solve_batch_sharded, *args, mesh, "qp")
    warm_s = warm_time(solve_batch_sharded, *args, mesh, "qp")
    ref = solve_batch_jit(*args)
    spans = _spans(res.status, ndev, "dp status")
    same = np.array_equal(np.asarray(res.status), np.asarray(ref.status))
    check(same, "dp: statuses differ from the single-device batch")
    return {"compile_s": first_s - warm_s, "warm_s": warm_s,
            "batch": ndev * B_per, "n": n, "m": m, "devices": spans,
            "solved": int(agg["n_solved"]), "statuses_identical": same}


def _rel(x, x_ref):
    return float(np.max(np.abs(x - x_ref)) / max(1.0, np.max(np.abs(x_ref))))


def phase_constraint_sharded(ndev=4, n=1024, m=1024, seed=0):
    import jax.numpy as jnp

    import qpalm_jax
    from qpalm_jax import Settings
    from qpalm_jax.api import pad_problem
    from qpalm_jax.parallel import default_mesh, solve_constraint_sharded
    from qpalm_jax.types import QPData
    from qpalm_jax.workloads import random_qp

    Q, A, q, bmin, bmax = random_qp(n, m, seed=seed)
    s = Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False)
    m_pad = -(-m // ndev) * ndev
    Qp, Ap, qp, bl, bu = pad_problem(Q, A, q, bmin, bmax, n, m_pad,
                                     np.float64)
    d = QPData(Q=jnp.asarray(Qp), A=jnp.asarray(Ap), q=jnp.asarray(qp),
               bmin=jnp.asarray(bl), bmax=jnp.asarray(bu), c=jnp.zeros(()))
    mesh = default_mesh(ndev)
    out, first_s = timed(solve_constraint_sharded, d, s, mesh, "qp")
    warm_s = warm_time(solve_constraint_sharded, d, s, mesh, "qp")
    x, status = out[0], int(out[2])
    ref = qpalm_jax.solve(Q, A, q, bmin, bmax, settings=s)
    spans = _spans(x, ndev, "constraint-sharded x")
    dx = _rel(np.asarray(x)[:n], ref.solution.x)
    check(status == int(ref.info.status_val) == 1,
          f"constraint-sharded status {status} vs {int(ref.info.status_val)}")
    check(dx <= SHARD_TOL, f"constraint-sharded x differs {dx:.3e}")
    return {"compile_s": first_s - warm_s, "warm_s": warm_s, "n": n,
            "m": m, "devices": spans, "iter": int(out[3]),
            "iter_single": int(ref.info.iter), "x_rel_diff": dx}


def phase_stage_sharded(ndev=4, horizon=80, n_masses=1, seed=0):
    from qpalm_jax import QPALM, Settings, constants as C
    from qpalm_jax.parallel import default_mesh
    from qpalm_jax.parallel.mpc_loop import (from_mpc_chain,
                                             solve_mpc_stage_sharded)
    from qpalm_jax.workloads import mpc_chain, mpc_stage_permutation

    H, A, q, bmin, bmax, meta = mpc_chain(n_masses, horizon, seed=seed)
    data = from_mpc_chain(H, A, q, bmin, bmax, meta)
    s = Settings(eps_abs=1e-6, eps_rel=1e-6, proximal=True, scaling=2,
                 factorization_method=C.FACTORIZE_SCHUR, verbose=False)
    mesh = default_mesh(ndev, axis_name="stage")
    res, first_s = timed(solve_mpc_stage_sharded, data, s, mesh, "stage")
    warm_s = warm_time(solve_mpc_stage_sharded, data, s, mesh, "stage")
    perm = mpc_stage_permutation(meta["nx"], meta["nu"], meta["N"])
    ref = QPALM(H[np.ix_(perm, perm)], A[:, perm], q[perm], bmin, bmax,
                settings=s).solve()
    spans = _spans(res.z, ndev, "stage-sharded z")
    dx = _rel(np.asarray(res.z).reshape(-1), ref.solution.x)
    check(int(res.status) == int(ref.info.status_val) == 1,
          f"stage-sharded status {int(res.status)} vs "
          f"{int(ref.info.status_val)}")
    check(dx <= SHARD_TOL, f"stage-sharded x differs {dx:.3e}")
    return {"compile_s": first_s - warm_s, "warm_s": warm_s,
            "horizon": horizon, "n": int(H.shape[0]), "devices": spans,
            "iter": int(res.iterations), "iter_single": int(ref.info.iter),
            "x_rel_diff": dx}


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the multi-device paths on four GPUs")
    ap.add_argument("--trace", metavar="DIR",
                    help="profile one warm fleet solve into DIR")
    args = ap.parse_args(argv)

    import jax

    # the api phase's reference runs on the CPU device: keep that backend
    # where JAX_PLATFORMS names only the GPU (read when a backend starts)
    platforms = jax.config.jax_platforms
    if platforms and "cpu" not in platforms.split(","):
        jax.config.update("jax_platforms", platforms + ",cpu")

    try:
        certify.require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    from qpalm_jax.compile_cache import enable_compile_cache

    enable_compile_cache()
    print(f"card: {certify.card_name_power()}")
    print(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}")
    if args.four:
        ndev = 4
        check(len(jax.devices()) >= ndev,
              f"--four needs {ndev} GPUs, found {len(jax.devices())}")
        phases = [("dp", lambda: phase_dp(ndev)),
                  ("con", lambda: phase_constraint_sharded(ndev)),
                  ("stage", lambda: phase_stage_sharded(ndev))]
    else:
        phases = [("cholesky", phase_cholesky),
                  ("fleet", lambda: phase_fleet(trace_dir=args.trace)),
                  ("scenario", phase_scenario),
                  ("large", phase_large),
                  ("api", phase_api),
                  ("cli", phase_cli)]
    for name, fn in phases:
        t0 = time.perf_counter()
        out = fn()
        out = {"phase": name, "wall_s": time.perf_counter() - t0, **out,
               "peak_bytes_in_use": peak_bytes()}
        print(json.dumps(out, default=str), flush=True)
    print(json.dumps({"ok": True, "device": certify.device_summary()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
