#!/usr/bin/env python
"""Two-process multi-host dryrun: DP batch sharding and the SPIKE
stage-sharded solve across a process (DCN-like) boundary.

SURVEY §5 requires the distributed-communication design to cover the device interconnect *and*
DCN; single-process virtual meshes only exercise the former.  This script
runs the same collectives across two OS processes (2 "hosts" x 4 devices,
gloo CPU collectives, `jax.distributed.initialize`), and asserts the
results match a single-process reference bit-for-bit-level.

Usage:
  python scripts/multihost_dryrun.py            # parent: spawns 2 workers
  python scripts/multihost_dryrun.py WORKER I N PORT   # internal
"""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def worker(pid: int, nproc: int, port: int) -> None:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import qpalm_jax  # noqa: F401  (enables x64)
    from qpalm_jax import Settings
    from qpalm_jax.batch import solve_batch_jit, stack_problems
    from qpalm_jax.parallel import default_mesh, solve_batch_sharded
    from qpalm_jax.parallel.block_tridiag import spike_solve, thomas_solve

    assert len(jax.devices()) == 8, len(jax.devices())
    assert jax.process_count() == nproc

    mesh = default_mesh(8, axis_name="qp")

    def make_global(arr):
        """Replicate identical host data into a batch-sharded global array
        (every process holds the full numpy copy, so the callback can serve
        any requested shard)."""
        arr = np.asarray(arr)
        sh = NamedSharding(mesh, P("qp", *([None] * (arr.ndim - 1))))
        return jax.make_array_from_callback(
            arr.shape, sh, lambda idx: arr[idx]
        )

    # ---- DP batch sharding across the process boundary -------------------
    rng = np.random.default_rng(0)
    probs = []
    for _ in range(16):
        M = rng.standard_normal((8, 8))
        Q = M @ M.T + 0.5 * np.eye(8)
        A = rng.standard_normal((8, 8))
        probs.append((Q, A, rng.standard_normal(8),
                      -0.5 * np.ones(8), 0.5 * np.ones(8)))
    settings = Settings(dtype="float32", eps_abs=1e-3, eps_rel=1e-3,
                        max_iter=200, scaling=2)
    data = stack_problems(probs, np.float32)
    B, n_pad = data.q.shape
    m_pad = data.bmin.shape[1]
    gdata = jax.tree.map(make_global, data)
    gx = make_global(np.zeros((B, n_pad), np.float32))
    gy = make_global(np.zeros((B, m_pad), np.float32))
    gg = make_global(np.full((B,), settings.gamma_init, np.float32))
    res, agg = solve_batch_sharded(
        gdata, gx, gy, gg, settings, False, False, mesh, "qp"
    )
    n_solved = int(agg["n_solved"])
    assert n_solved == B, f"multihost dp: {n_solved}/{B}"

    # single-process reference on the same problems (local devices only)
    ref = solve_batch_jit(
        data, jnp.zeros((B, n_pad), jnp.float32),
        jnp.zeros((B, m_pad), jnp.float32),
        jnp.full((B,), settings.gamma_init, jnp.float32),
        settings, False, False,
    )
    # compare the locally-addressable shards of the sharded result against
    # the single-process reference rows
    local_rows = []
    for shard in res.x.addressable_shards:
        local_rows.append((shard.index[0].start or 0, np.asarray(shard.data)))
    for start, rows in local_rows:
        refs = np.asarray(ref.x)[start:start + rows.shape[0]]
        assert np.allclose(rows, refs, atol=5e-4), (
            np.abs(rows - refs).max()
        )

    # ---- SPIKE stage partitioning across the process boundary ------------
    S, nb = 16, 4
    rng2 = np.random.default_rng(2)
    D = np.zeros((S, nb, nb), np.float64)
    E = np.zeros((S, nb, nb), np.float64)
    for k in range(S):
        X = rng2.standard_normal((nb, nb))
        D[k] = X @ X.T + 5 * np.eye(nb)
    for k in range(S - 1):
        E[k] = 0.3 * rng2.standard_normal((nb, nb))
    bb = rng2.standard_normal((S, nb))
    mesh_s = default_mesh(8, axis_name="stage")

    def make_stage(arr):
        arr = np.asarray(arr)
        sh = NamedSharding(mesh_s, P("stage", *([None] * (arr.ndim - 1))))
        return jax.make_array_from_callback(
            arr.shape, sh, lambda idx: arr[idx]
        )

    x_sp = spike_solve(make_stage(D), make_stage(E), make_stage(bb),
                       mesh_s, "stage")
    x_ref = np.asarray(thomas_solve(jnp.asarray(D), jnp.asarray(E[:-1]),
                                    jnp.asarray(bb)))
    for shard in x_sp.addressable_shards:
        start = shard.index[0].start or 0
        rows = np.asarray(shard.data)
        assert np.allclose(rows, x_ref[start:start + rows.shape[0]],
                           atol=1e-8)

    print(f"MULTIHOST_OK pid={pid}", flush=True)
    jax.distributed.shutdown()


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "WORKER":
        worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
        return 0

    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "WORKER",
             str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        for i in range(2)
    ]
    ok = True
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            p.kill()
            out = "(timeout)"
            ok = False
        if f"MULTIHOST_OK pid={i}" not in (out or ""):
            ok = False
            print(f"--- worker {i} output ---\n{out}")
    print("multihost dryrun:", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
