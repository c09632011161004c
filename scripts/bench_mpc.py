#!/usr/bin/env python
"""Sequential warm-started MPC benchmark (the chain80w protocol).

Reference: simulations/chain80w — 101 warm-started QPs, 240 vars,
709 constraints, horizon 80 (info.txt:16-24), eps 1e-6, scaling 2,
proximal off.  Here: the oscillating-masses ladder at matched scale,
reporting closed-loop solves/sec and iteration statistics for both the
dense and the stage-structured (block-Thomas) Newton paths.

Usage: python scripts/bench_mpc.py [--masses 6] [--horizon 20] [--steps 25]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from qpalm_jax.io.cli import PLATFORMS, use_platform


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--masses", type=int, default=6)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--platform", choices=PLATFORMS, default=None,
                    help="JAX backend (default: JAX's default backend)")
    args = ap.parse_args(argv)

    use_platform(args.platform)

    from qpalm_jax.workloads import SequentialMPC, mpc_chain

    H, A, _, _, _, meta = mpc_chain(args.masses, args.horizon)
    print(f"MPC ladder: {H.shape[0]} vars, {A.shape[0]} constraints, "
          f"horizon {args.horizon} (chain80w protocol: 240/709/80)")

    configs = [("dense-cholesky", {}),
               ("stage-thomas", {"stage_structured": True}),
               ("sparse-ldl", {"backend": "sparse"})]
    for label, kw in configs:
        mpc = SequentialMPC(args.masses, args.horizon, seed=0, **kw)
        mpc.step()  # compile/symbolic + first (cold) solve excluded
        t0 = time.perf_counter()
        iters = mpc.run(args.steps)
        dt = time.perf_counter() - t0
        print(f"{label:>15}: {args.steps/dt:6.1f} solves/s  "
              f"iters p50={np.median(iters):.0f} max={max(iters)}  "
              f"|x|={np.abs(mpc.x).max():.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
