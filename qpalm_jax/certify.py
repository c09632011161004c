"""The certified batched pipeline and the device report shared by
`bench.py` and `chip_smoke.py`.

A fleet of QPs is certified at `EPS_TARGET` on the unscaled problem in four
steps:

  1. `batch.solve_batch_jit` in float32 at `EPS_F32` (`f32_settings`);
  2. `polish_round`: the device polish in f64 on device-resident data;
  3. `rescue_lanes`: a fresh host f64 solve of the lanes the polish did not
     certify (native C solver, then the numpy P-ALM finisher);
  4. `referee`: the host f64 KKT check of every device-certified lane.

`require_gpu`, `device_summary` and `card_name_power` name the device a
result was measured on; `require_gpu` refuses to run anywhere but a GPU.
"""

from __future__ import annotations

import subprocess

import numpy as np

EPS_TARGET = 1e-6
# the f32 pass only seeds the device polish: tighter iterates give the
# polish better active sets; much tighter sends stragglers past max_iter
EPS_F32 = 5e-5


def make_problems(batch, n, m, seed=7):
    """`batch` random strictly convex QPs (n, m), Q 50% dense: the
    protocol of the reference's simulations/randomQP.m, scaled up."""
    rng = np.random.default_rng(seed)
    probs = []
    for _ in range(batch):
        M = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.5)
        Q = M @ M.T / n + 0.1 * np.eye(n)
        A = rng.standard_normal((m, n))
        q = rng.standard_normal(n)
        u = 2 * rng.random(m)
        probs.append((Q, A, q, -u, u))
    return probs


def f32_settings(eps=EPS_F32):
    """Settings of the f32 pass (delta=10 keeps the Schur conditioning
    inside f32 range)."""
    from .types import Settings

    # max_iter=96 covers the observed tail with margin; stragglers go
    # through the polish / rescue tiers
    return Settings(
        dtype="float32", eps_abs=eps, eps_rel=eps, max_iter=96,
        scaling=2, max_refine=0, delta=10.0,
    )


def lockstep_iters(iterations) -> int:
    """Lane-iterations a vmapped batch solve executes: the loop runs every
    lane until the slowest one finishes, so B x the batch's max count."""
    it = np.asarray(iterations)
    return int(it.size * it.max()) if it.size else 0


def polish_round(d64, x32, y32):
    """The device polish of one round (f64 data on the device)."""
    from .polish_device import polish_batch_device

    # refine_iters=2 with the eps-5e-5 seeds; seed_guard="norm" hands
    # failing lanes an intact warm start; the worst-64 second-chance round
    # retries misdetected active sets; residual32 + accept_viol margin
    # evaluate residuals in f32 with a margin, and the host referee
    # re-checks every certified lane in f64
    return polish_batch_device(
        d64, x32, y32, eps_abs=EPS_TARGET, eps_rel=EPS_TARGET,
        refine_iters=2, second_round_k=64, seed_guard="norm",
        residual32=True, accept_viol=0.5,
    )


def rescue_lanes(sub64, x0, y0):
    """Fresh f64 solve of lanes the polish did not certify: the native
    C/LAPACK solver, then the warm-started numpy P-ALM finisher for any
    lane still failing; each result re-certified by the host polish KKT
    check.  `sub64` is host (numpy) f64 data of those lanes.  Returns
    (x, y, ok)."""
    import jax

    from . import baseline_c
    from .finish_np import palm_finish_np
    from .polish import polish_batch_np

    nbad, n_pad = sub64.q.shape
    xs = np.zeros((nbad, n_pad))
    ys = np.zeros_like(sub64.bmin)
    for j in range(nbad):
        r = baseline_c.solve(
            sub64.Q[j], sub64.A[j], sub64.q[j], sub64.bmin[j],
            sub64.bmax[j], eps_abs=0.5 * EPS_TARGET,
            eps_rel=0.5 * EPS_TARGET, scaling=2, delta=10.0,
        )
        xs[j], ys[j] = r["x"], r["y"]
    pol = polish_batch_np(sub64, xs, ys, eps_abs=EPS_TARGET,
                          eps_rel=EPS_TARGET, rounds=1)
    x, y, ok = np.array(pol.x), np.array(pol.y), np.array(pol.ok)
    still = np.where(~ok)[0]
    if len(still):
        sub2 = jax.tree.map(lambda a: a[still], sub64)
        fin = palm_finish_np(sub2, x[still], y[still],
                             eps_abs=EPS_TARGET, eps_rel=EPS_TARGET)
        pol2 = polish_batch_np(sub2, fin.x, fin.y, eps_abs=EPS_TARGET,
                               eps_rel=EPS_TARGET, rounds=1, refine_steps=0)
        x[still], y[still] = np.asarray(pol2.x), np.asarray(pol2.y)
        ok[still] = np.asarray(pol2.ok)
    return x, y, ok


def referee(d64, x, y, dev_ok):
    """Native host f64 KKT check (polish_batch_np rounds=0, a pure check)
    of the lanes the device certified; returns their host verdicts."""
    import jax

    from .polish import polish_batch_np

    if not dev_ok.any():
        return np.zeros(0, bool)
    chk = polish_batch_np(
        jax.tree.map(lambda a: a[dev_ok], d64), x[dev_ok], y[dev_ok],
        eps_abs=EPS_TARGET, eps_rel=EPS_TARGET, rounds=0,
    )
    return np.asarray(chk.ok)


def require_gpu():
    """The first device of JAX's default backend; RuntimeError unless it is
    a GPU (no fallback to another backend)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's default backend is "
                           f"{dev.platform!r} ({dev.device_kind})")
    return dev


def device_summary() -> dict:
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_name_power() -> str:
    """`name, power.limit` of each card, from nvidia-smi (a child process
    that stays off JAX)."""
    p = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return p.stdout.strip()
