"""Data-parallel batch solves over a device mesh.

The reference's batch workloads are host loops over independent problems
(reference: simulations/maros_meszaros/test_maros_meszaros.m:50-74); the
design here shards the problem batch across devices with `shard_map`,
so every device runs its *own* `lax.while_loop` over its local problems —
no lockstep between shards, collectives only at the end for aggregate
metrics (`psum` of solved counts / iteration totals).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .. import constants as C
from ..batch import BatchResult, _DATA_AXES, _solve_one
from ..precision import full_matmul_precision
from ..types import QPData, Settings


def default_mesh(n_devices: Optional[int] = None, axis_name: str = "qp") -> Mesh:
    """A 1-D mesh over the first `n_devices` devices (all by default)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def pad_batch_to_devices(data: QPData, n_devices: int):
    """Pad the batch axis up to a multiple of the mesh size with neutral
    dummy problems (unit Hessian, no constraints). Returns (data, valid_mask).
    """
    B = data.q.shape[0]
    B_pad = ((B + n_devices - 1) // n_devices) * n_devices
    if B_pad == B:
        return data, np.ones((B,), bool)
    k = B_pad - B
    n_pad = data.q.shape[1]
    m_pad = data.bmin.shape[1]
    dtype = data.Q.dtype

    eye = jnp.broadcast_to(jnp.eye(n_pad, dtype=dtype), (k, n_pad, n_pad))
    data = QPData(
        Q=jnp.concatenate([data.Q, eye]),
        A=jnp.concatenate([data.A, jnp.zeros((k, m_pad, n_pad), dtype)]),
        q=jnp.concatenate([data.q, jnp.zeros((k, n_pad), dtype)]),
        bmin=jnp.concatenate(
            [data.bmin, jnp.full((k, m_pad), -1e21, dtype)]
        ),
        bmax=jnp.concatenate([data.bmax, jnp.full((k, m_pad), 1e21, dtype)]),
        c=jnp.concatenate([data.c, jnp.zeros((k,), dtype)]),
    )
    mask = np.zeros((B_pad,), bool)
    mask[:B] = True
    return data, mask


@functools.partial(
    jax.jit,
    static_argnames=("settings", "has_ws", "has_gamma", "mesh", "axis_name",
                     "aggregate"),
)
@full_matmul_precision
def solve_batch_sharded(
    data: QPData,
    x_ws: jnp.ndarray,
    y_ws: jnp.ndarray,
    gamma: jnp.ndarray,
    settings: Settings,
    has_ws: bool,
    has_gamma: bool,
    mesh: Mesh,
    axis_name: str = "qp",
    aggregate: bool = True,
):
    """Shard the problem batch over `mesh` and solve.

    Returns (BatchResult with batch-sharded leaves, aggregate dict with
    replicated scalars: n_solved, total_iters, max_iters) — the aggregates
    ride one `psum`/`pmax` across devices.

    `aggregate=False` skips the cross-device reductions and the dict holds
    device-local partials sharded like the batch (shape (n_devices,)):
    the caller reduces on host after fetching — the right mode when the
    collectives' latency is visible (gloo/DCN meshes) or when aggregates
    are only consumed occasionally.  Semantically identical totals.
    """
    spec = P(axis_name)

    def local_solve(d, xw, yw, g):
        res = jax.vmap(
            _solve_one, in_axes=(_DATA_AXES, 0, 0, 0, None, None, None)
        )(d, xw, yw, g, settings, has_ws, has_gamma)
        n_solved = jnp.sum(
            (res.status == C.QPALM_SOLVED).astype(jnp.int32)
        )
        total_iters = jnp.sum(res.iterations)
        max_iters = jnp.max(res.iterations)
        if aggregate:
            # ONE collective for all three aggregates: pack the two sums
            # plus a one-hot-by-device-slot encoding of the local max into
            # a (2 + n_devices,) vector and psum it once — the global max
            # is then the max over the summed slots (exact, since each
            # device writes only its own slot).  Separate psum/psum/pmax
            # calls cost one collective latency each; on gloo-localhost
            # that was ~40 ms of the 4-process DP gap
            # (benchmarks/RESULTS_scaling_multiproc.md).
            nd = mesh.shape[axis_name]
            slot = jax.lax.axis_index(axis_name)
            # pack in the widest participating dtype: down-casting x64
            # iteration sums through int32 could silently overflow on very
            # large per-device batches (the one-hot max itself is exact)
            pdt = jnp.promote_types(total_iters.dtype, jnp.int32)
            onehot_max = jnp.where(
                jnp.arange(nd, dtype=pdt) == slot,
                max_iters.astype(pdt), jnp.zeros((), pdt))
            packed = jnp.concatenate([
                jnp.stack([n_solved.astype(pdt), total_iters.astype(pdt)]),
                onehot_max,
            ])
            packed = jax.lax.psum(packed, axis_name)
            n_solved = packed[0].astype(jnp.int32)
            total_iters = packed[1].astype(total_iters.dtype)
            max_iters = jnp.max(packed[2:]).astype(max_iters.dtype)
        else:
            # device-local partials, one scalar per shard
            n_solved = n_solved[None]
            total_iters = total_iters[None]
            max_iters = max_iters[None]
        return res, n_solved, total_iters, max_iters

    data_specs = QPData(Q=spec, A=spec, q=spec, bmin=spec, bmax=spec, c=spec)
    out_res_specs = BatchResult(
        x=spec, y=spec, status=spec, iterations=spec,
        objective=spec, pri_res_norm=spec, dua_res_norm=spec,
    )
    agg_spec = P() if aggregate else spec
    res, n_solved, total_iters, max_iters = jax.shard_map(
        local_solve,
        mesh=mesh,
        in_specs=(data_specs, spec, spec, spec),
        out_specs=(out_res_specs, agg_spec, agg_spec, agg_spec),
        # the solver mixes shard-constant and shard-varying values inside
        # lax.cond branches (factor-cache reuse), which the varying-manual-axes
        # type checker rejects; replication tracking is unnecessary here
        check_vma=False,
    )(data, x_ws, y_ws, gamma)
    return res, {
        "n_solved": n_solved,
        "total_iters": total_iters,
        "max_iters": max_iters,
    }
