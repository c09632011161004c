"""The P-ALM solve loop running stage-sharded across a device mesh.

SURVEY §2.4's "intra-QP partitioning": for stage-structured MPC QPs
(variables z_k = [x_k; u_k], dynamics coupling adjacent stages, box rows
diagonal — the chain80w ladder, simulations/chain80w/info.txt:20-24), the
*entire* solve loop lives inside one `shard_map` with the horizon sharded
over the mesh:

  * A / A' matvecs are stage-local plus one `ppermute` halo exchange,
  * the Schur matrix is assembled block-locally (it is exactly
    block-tridiagonal in this ordering) and every Newton system is solved
    by the distributed SPIKE reduction — per-chunk block-Thomas
    factorization, one `all_gather` interface solve across devices, local
    back-substitution (`block_tridiag.spike_solve_local`),
  * linesearch breakpoints are built locally and `all_gather`ed for the
    replicated sort-and-scan,
  * all norms/counters reduce with `pmax` / `psum`.

Full solver parity (round 2): proximal with the gamma schedule and the
settled-active-set gamma *boost* (reference qpalm.c:612-630,
iteration.c:158-205, with the Gershgorin bound computed distributed from
the block-tridiagonal assembly), Ruiz scaling (distributed equilibration
producing per-stage scaled dynamics matrices, reference scaling.c:34-113),
warm starts (qpalm.c:322-399), and both infeasibility certificates
(termination.c:136-240) with their delta_y / delta_x vectors returned
stage-sharded.  Out of scope: nonconvex (a distributed LOBPCG has no
reference analogue; pin gamma via Settings externally if needed).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .. import constants as C
from ..constants import MIN_SCALING
from ..precision import full_matmul_precision
from ..solver.linesearch import linesearch_from_breakpoints
from ..types import Settings
from .block_tridiag import spike_solve_local


class MPCStageData(NamedTuple):
    """Stage-sharded MPC QP data (leading axis = stage, shardable).

    Stage variables z_k = [x_{k+1}; u_k]; the dynamics row of stage k is

        G z_k - Aprev z_{k-1} = beq_k,   G = [I  -Bd],  Aprev = [Ad  0]

    (x_{k+1} and u_k live in the SAME stage; x_k in the previous one; the
    k=0 row has no z_{-1} term — the initial state is folded into beq_0),
    followed by nb box rows  lo_k <= z_k <= hi_k.
    """

    H: jnp.ndarray   # (S, nb, nb) stage Hessian blocks
    q: jnp.ndarray   # (S, nb)
    beq: jnp.ndarray  # (S, nx)
    lo: jnp.ndarray   # (S, nb)
    hi: jnp.ndarray   # (S, nb)
    Ad: jnp.ndarray   # (nx, nx) shared dynamics (replicated)
    Bd: jnp.ndarray   # (nx, nu)


class StageScaled(NamedTuple):
    """Scaled stage data with per-stage constraint matrices (identity
    scaling produces broadcast copies of the shared G / Aprev and unit box
    weights)."""

    H: jnp.ndarray    # (S, nb, nb)
    q: jnp.ndarray    # (S, nb)
    beq: jnp.ndarray  # (S, nx)
    lo: jnp.ndarray   # (S, nb)
    hi: jnp.ndarray   # (S, nb)
    G: jnp.ndarray    # (S, nx, nb) scaled dynamics row block (own stage)
    Ap: jnp.ndarray   # (S, nx, nb) scaled coupling to the previous stage
    W: jnp.ndarray    # (S, nb) scaled box-row diagonal weights


class StageScaling(NamedTuple):
    D: jnp.ndarray     # (S, nb) column scaling
    Eeq: jnp.ndarray   # (S, nx) equality row scaling
    Ebox: jnp.ndarray  # (S, nb) box row scaling
    c: jnp.ndarray     # () cost scaling


class MPCResult(NamedTuple):
    z: jnp.ndarray        # (S, nb) stage-sharded primal solution (unscaled)
    y_eq: jnp.ndarray     # (S, nx) equality multipliers (unscaled)
    y_box: jnp.ndarray    # (S, nb) box multipliers (unscaled)
    status: jnp.ndarray   # () int32
    iterations: jnp.ndarray  # () int32
    pri_res_norm: jnp.ndarray  # ()
    dua_res_norm: jnp.ndarray  # ()
    delta_y_eq: jnp.ndarray   # (S, nx) primal-infeasibility certificate
    delta_y_box: jnp.ndarray  # (S, nb)
    delta_z: jnp.ndarray      # (S, nb) dual-infeasibility certificate


def from_mpc_chain(H, A, q, bmin, bmax, meta):
    """Convert a `workloads.mpc_chain` problem (z = [x_1..x_N | u_0..]) to
    stage-sharded MPCStageData (stage-interleaved)."""
    from ..workloads import mpc_stage_permutation

    nx, nu, N = meta["nx"], meta["nu"], meta["N"]
    nb = nx + nu
    perm = mpc_stage_permutation(nx, nu, N)
    Hp = np.asarray(H)[np.ix_(perm, perm)]
    qp = np.asarray(q)[perm]
    H_blocks = np.stack([Hp[k * nb:(k + 1) * nb, k * nb:(k + 1) * nb]
                         for k in range(N)])
    q_blocks = qp.reshape(N, nb)
    m_eq = meta["m_eq"]
    beq = np.asarray(bmin)[:m_eq].reshape(N, nx)
    # box rows of mpc_chain are eye(nz) in the ORIGINAL ordering — permute
    lo = np.asarray(bmin)[m_eq:][perm].reshape(N, nb)
    hi = np.asarray(bmax)[m_eq:][perm].reshape(N, nb)
    return MPCStageData(
        H=jnp.asarray(H_blocks), q=jnp.asarray(q_blocks),
        beq=jnp.asarray(beq), lo=jnp.asarray(lo), hi=jnp.asarray(hi),
        Ad=jnp.asarray(meta["Ad"]), Bd=jnp.asarray(meta["Bd"]),
    )


def mpc_chain_stage_data(n_masses: int = 6, horizon: int = 10, x0=None,
                         seed: int = 0) -> MPCStageData:
    """Build the chain MPC's MPCStageData DIRECTLY in stage-block form.

    Bit-identical to `from_mpc_chain(*workloads.mpc_chain(...))` (asserted
    in tests/test_mpc_loop.py) but O(S * nb^2) memory instead of the dense
    route's O((S*nb)^2): at horizon 1536 / nb 29 the dense intermediates
    (`np.vstack` of the (m, nz) constraint matrix) are ~27 GB of resident
    pages PER PROCESS — the multiproc scaling bench at 4 processes OOM-kills
    a 125 GB box building four copies of a matrix whose stage blocks total
    ~10 MB.  Long-horizon workloads must use this constructor.
    """
    from ..workloads import _chain_dynamics

    rng = np.random.default_rng(seed)
    Ad, Bd = _chain_dynamics(n_masses)
    nx, nu = Bd.shape
    nb = nx + nu
    N = horizon
    if x0 is None:
        x0 = 0.5 * rng.standard_normal(nx)
    x0 = np.asarray(x0, float)

    # stage Hessian blockdiag(Qw=I_nx, Rw=0.1 I_nu) — identical all stages
    Hb = np.eye(nb)
    Hb[nx:, nx:] *= 0.1
    H_blocks = np.broadcast_to(Hb, (N, nb, nb)).copy()
    q_blocks = np.zeros((N, nb))
    beq = np.zeros((N, nx))
    beq[0] = Ad @ x0
    lohi = np.concatenate([4.0 * np.ones(nx), 0.5 * np.ones(nu)])
    lo = np.broadcast_to(-lohi, (N, nb)).copy()
    hi = np.broadcast_to(lohi, (N, nb)).copy()
    return MPCStageData(
        H=jnp.asarray(H_blocks), q=jnp.asarray(q_blocks),
        beq=jnp.asarray(beq), lo=jnp.asarray(lo), hi=jnp.asarray(hi),
        Ad=jnp.asarray(Ad), Bd=jnp.asarray(Bd),
    )


def _limit(v):
    return jnp.where(v < MIN_SCALING, jnp.ones_like(v), v)


def scale_stage_data(data: MPCStageData, iters: int):
    """Distributed Ruiz equilibration of the stage-structured constraint
    matrix + symmetric H scaling + cost scaling (reference scaling.c:34-113
    — identical math to qpalm_jax.scaling.scale_data, evaluated on the
    stage-block structure; runs on globally-viewed (sharded) arrays, XLA
    inserts the halo collectives).

    The constraint rows of stage k are [G z_k - Ap z_{k-1} = beq_k] and the
    identity box block; after scaling these become per-stage matrices
    G_k / Ap_k and diagonal box weights W_k.
    """
    S, nb = data.q.shape
    nx = data.beq.shape[-1]
    dtype = data.H.dtype
    G0 = jnp.concatenate([jnp.eye(nx, dtype=dtype), -data.Bd], axis=1)
    Ap0 = jnp.concatenate(
        [data.Ad, jnp.zeros((nx, nb - nx), dtype)], axis=1
    )
    G = jnp.broadcast_to(G0, (S, nx, nb))
    Ap_first_zero = jnp.concatenate(
        [jnp.zeros((1, nx, nb), dtype),
         jnp.broadcast_to(Ap0, (S - 1, nx, nb))], axis=0
    )  # stage 0 has no z_{-1} coupling
    Ap = Ap_first_zero
    W = jnp.ones((S, nb), dtype)
    D = jnp.ones((S, nb), dtype)
    Eeq = jnp.ones((S, nx), dtype)
    Ebox = jnp.ones((S, nb), dtype)
    for _ in range(iters):
        # column inf-norms of stage k's variables: |G_k| columns,
        # |Ap_{k+1}| columns (the next stage's coupling), and the box weight
        ap_next = jnp.concatenate(
            [jnp.abs(Ap[1:]).max(axis=1),
             jnp.zeros((1, nb), dtype)], axis=0
        )
        col = jnp.maximum(
            jnp.abs(G).max(axis=1), jnp.maximum(ap_next, jnp.abs(W))
        )
        # row inf-norms
        row_eq = jnp.maximum(
            jnp.abs(G).max(axis=2), jnp.abs(Ap).max(axis=2)
        )
        row_box = jnp.abs(W)
        Dt = 1.0 / jnp.sqrt(_limit(col))
        Et_eq = 1.0 / jnp.sqrt(_limit(row_eq))
        Et_box = 1.0 / jnp.sqrt(_limit(row_box))
        Dt_prev = jnp.concatenate(
            [jnp.ones((1, nb), dtype), Dt[:-1]], axis=0
        )
        G = Et_eq[:, :, None] * G * Dt[:, None, :]
        Ap = Et_eq[:, :, None] * Ap * Dt_prev[:, None, :]
        W = Et_box * W * Dt
        D = D * Dt
        Eeq = Eeq * Et_eq
        Ebox = Ebox * Et_box

    q = D * data.q
    c = 1.0 / jnp.maximum(1.0, jnp.max(jnp.abs(q)))
    q = c * q
    H = c * (D[:, :, None] * data.H * D[:, None, :])
    beq = Eeq * data.beq
    lo = jnp.where(data.lo > -C.QPALM_INFTY, Ebox * data.lo, data.lo)
    hi = jnp.where(data.hi < C.QPALM_INFTY, Ebox * data.hi, data.hi)
    return (
        StageScaled(H=H, q=q, beq=beq, lo=lo, hi=hi, G=G, Ap=Ap, W=W),
        StageScaling(D=D, Eeq=Eeq, Ebox=Ebox, c=c),
    )


def identity_stage_scaling(data: MPCStageData):
    S, nb = data.q.shape
    nx = data.beq.shape[-1]
    dtype = data.H.dtype
    G0 = jnp.concatenate([jnp.eye(nx, dtype=dtype), -data.Bd], axis=1)
    Ap0 = jnp.concatenate(
        [data.Ad, jnp.zeros((nx, nb - nx), dtype)], axis=1
    )
    Ap = jnp.concatenate(
        [jnp.zeros((1, nx, nb), dtype),
         jnp.broadcast_to(Ap0, (S - 1, nx, nb))], axis=0
    )
    return (
        StageScaled(
            H=data.H, q=data.q, beq=data.beq, lo=data.lo, hi=data.hi,
            G=jnp.broadcast_to(G0, (S, nx, nb)), Ap=Ap,
            W=jnp.ones((S, nb), dtype),
        ),
        StageScaling(
            D=jnp.ones((S, nb), dtype), Eeq=jnp.ones((S, nx), dtype),
            Ebox=jnp.ones((S, nb), dtype), c=jnp.ones((), dtype),
        ),
    )


def _loop_body(d: StageScaled, scal: StageScaling, settings: Settings,
               nd: int, axis: str):
    """Build the per-iteration function for the stage-sharded loop.
    All (S_loc, ...) arrays are shard-local; scalars are replicated."""
    nb = d.H.shape[-1]
    dtype = d.H.dtype
    idx = jax.lax.axis_index(axis)
    is_first = idx == 0
    is_last = idx == nd - 1
    prox = settings.proximal
    cfac = scal.c if settings.scaling else jnp.ones((), dtype)

    def halo_left(v_last):
        """Each device receives the LEFT neighbor's per-stage tail value."""
        got = jax.lax.ppermute(v_last, axis,
                               [(i, (i + 1) % nd) for i in range(nd)])
        return jnp.where(is_first, jnp.zeros_like(got), got)

    def halo_right(v_first):
        got = jax.lax.ppermute(v_first, axis,
                               [(i, (i - 1) % nd) for i in range(nd)])
        return jnp.where(is_last, jnp.zeros_like(got), got)

    def pmax(v):
        return jax.lax.pmax(jnp.max(v), axis)

    def psum(v):
        return jax.lax.psum(jnp.sum(v), axis)

    # fused reductions: one latency-bound collective for a STACK of
    # scalars instead of one per scalar.  On gloo-localhost each scalar
    # collective costs ~0.3-1 ms; the unfused iteration issued ~30 of
    # them, which alone explains the measured 2.7-4x stage-sharded
    # overhead (benchmarks/RESULTS_scaling_multiproc.md).  max/sum are
    # applied per-component, so the arithmetic is IDENTICAL to the
    # scalar collectives (the full-parity tests assert this).
    def pmax_vec(vals):
        return jax.lax.pmax(jnp.stack(vals), axis)

    def psum_vec(vals):
        return jax.lax.psum(jnp.stack(vals), axis)

    def a_matvec(z):
        """(eq (S_loc, nx), box (S_loc, nb)) rows of A z."""
        z_prev = jnp.concatenate([halo_left(z[-1])[None], z[:-1]], axis=0)
        eq = jnp.einsum("sij,sj->si", d.G, z) - jnp.einsum(
            "sij,sj->si", d.Ap, z_prev
        )
        return eq, d.W * z

    # loop-invariant halo of the A' stage coupling: computed once (a
    # ppermute inside the while-loop body would otherwise run every
    # iteration — XLA does not hoist collectives out of while loops)
    Ap_next_const = jnp.concatenate(
        [d.Ap[1:], halo_right(d.Ap[0])[None]], axis=0
    )

    def at_matvec(w_eq, w_box):
        """A' w for stage-split w."""
        w_next = jnp.concatenate(
            [w_eq[1:], halo_right(w_eq[0])[None]], axis=0
        )
        return (
            jnp.einsum("sij,si->sj", d.G, w_eq)
            - jnp.einsum("sij,si->sj", Ap_next_const, w_next)
            + d.W * w_box
        )

    def h_matvec(z):
        return jnp.einsum("sij,sj->si", d.H, z)

    def assemble_blocks(sig_eq, sig_box_act, gamma):
        """Block-tridiagonal (D, E) of M = H + A' Sigma_act A (+ I/gamma),
        plus the Gershgorin bound of A' Sigma_act A (distributed,
        reference nonconvex.c:185-210 semantics for iteration.c:158-205)."""
        sig_eq_next = jnp.concatenate(
            [sig_eq[1:], halo_right(sig_eq[0])[None]], axis=0
        )
        Ap_next = Ap_next_const
        GtSG = jnp.einsum("sri,sr,srj->sij", d.G, sig_eq, d.G)
        ApSAp = jnp.einsum("sri,sr,srj->sij", Ap_next, sig_eq_next, Ap_next)
        ats_D = GtSG + ApSAp + jnp.einsum(
            "si,ij->sij", sig_box_act * d.W * d.W, jnp.eye(nb, dtype=dtype)
        )
        # off-diagonal block (k, k-1): -G_k' Sigma_k Ap_k (local), shifted
        # so E[s] sits at block (s+1, s) as spike_solve_local expects
        t_loc = -jnp.einsum("sri,sr,srj->sij", d.G, sig_eq, d.Ap)
        E = jnp.concatenate([t_loc[1:], halo_right(t_loc[0])[None]], axis=0)
        # Gershgorin: row block k couples to k-1 via t_k and to k+1 via
        # t_{k+1}' (column sums of the halo-shifted block)
        t_next = E
        rowsum = (
            jnp.sum(jnp.abs(ats_D), axis=2)
            + jnp.sum(jnp.abs(t_loc), axis=2)
            + jnp.sum(jnp.abs(t_next), axis=1)
        )
        gersh = pmax(rowsum)
        Dblk = d.H + ats_D
        if prox:
            Dblk = Dblk + jnp.eye(nb, dtype=dtype)[None] / gamma
        return Dblk, E, gersh

    def iteration(st):
        (z, z0, z_prev, y_eq, y_box, sig_eq, sig_box, pri_in_eq,
         pri_in_box, eps_abs_in, eps_rel_in, active_old, gamma,
         gamma_maxed, gersh_c, nb_changed, no_change, it, it_out, prev_it,
         done, status, Hd_t, Ad_eq_t, Ad_box_t, dz_cert_eq, dz_cert_box,
         dx_cert, pri_norm_out, dua_norm_out) = st

        # ---- residuals (iteration.c:24-48) -------------------------------
        Aeq, Abox = a_matvec(z)
        Axys_eq = Aeq + y_eq / sig_eq
        Axys_box = Abox + y_box / sig_box
        zcl_eq = d.beq  # equality rows clamp to beq
        zcl_box = jnp.clip(Axys_box, d.lo, d.hi)
        pri_eq = Aeq - zcl_eq
        pri_box = Abox - zcl_box
        yh_eq = y_eq + sig_eq * pri_eq
        yh_box = y_box + sig_box * pri_box
        Hz = h_matvec(z)
        df = Hz + d.q
        if prox:
            # core.py's Qx state carries x/gamma, so its df = Qx + q -
            # x0/gamma expands to H x + q + (x - x0)/gamma — both terms
            # are needed here where h_matvec is the pure product
            df = df + (z - z0) / gamma
        Atyh = at_matvec(yh_eq, yh_box)
        dphi = df + Atyh

        # ---- termination (termination.c:44-129, scaled norms) ------------
        # every per-iteration scalar reduction rides ONE fused pmax and
        # ONE fused psum (identical arithmetic; see pmax_vec)
        Eeqi = 1.0 / scal.Eeq
        Eboxi = 1.0 / scal.Ebox
        Di = 1.0 / scal.D
        cinv = 1.0 / cfac
        if prox:
            dd_full = dphi - (z - z0) / gamma
        else:
            dd_full = dphi
        Hz_prox = Hz + z / gamma if prox else Hz
        dy_eq = yh_eq - y_eq
        dy_box = yh_box - y_box
        At_dy = Di * at_matvec(dy_eq, dy_box)
        has_lb = d.lo > -C.QPALM_INFTY
        has_ub = d.hi < C.QPALM_INFTY
        dz = z - z_prev
        Ddz = scal.D * dz
        active_box = (Axys_box <= d.lo) | (Axys_box >= d.hi)
        ninf = jnp.asarray(-jnp.inf, dtype)
        mx = pmax_vec([
            jnp.max(jnp.abs(Eeqi * pri_eq)),          # 0
            jnp.max(jnp.abs(Eboxi * pri_box)),        # 1
            jnp.max(jnp.abs(Di * dd_full)),           # 2
            jnp.max(jnp.abs(Di * dphi)),              # 3
            jnp.max(jnp.abs(Eeqi * Aeq)),             # 4
            jnp.max(jnp.abs(Eboxi * Abox)),           # 5
            jnp.max(jnp.abs(Eeqi * zcl_eq)),          # 6
            jnp.max(jnp.abs(Eboxi * zcl_box)),        # 7
            jnp.max(jnp.abs(Di * Hz_prox)),           # 8
            jnp.max(jnp.abs(Di * d.q)),               # 9
            jnp.max(jnp.abs(Di * Atyh)),              # 10
            jnp.max(jnp.abs(scal.Eeq * dy_eq)),       # 11
            jnp.max(jnp.abs(scal.Ebox * dy_box)),     # 12
            jnp.max(jnp.abs(At_dy)),                  # 13
            jnp.max(jnp.abs(Ddz)),                    # 14
            jnp.max(jnp.abs(pri_eq)),                 # 15 (unscaled)
            jnp.max(jnp.abs(pri_box)),                # 16
            jnp.max(jnp.abs(Eeqi * Ad_eq_t)),         # 17
            jnp.max(jnp.where(has_ub, Eboxi * Ad_box_t, ninf)),   # 18
            jnp.max(jnp.where(has_lb, -(Eboxi * Ad_box_t), ninf)),  # 19
        ])
        el_cnt = jnp.sum((active_box != active_old).astype(dtype))
        sm = psum_vec([
            jnp.sum(d.beq * dy_eq)
            + jnp.sum(
                jnp.where(has_ub, d.hi * jnp.maximum(dy_box, 0.0), 0.0)
                + jnp.where(has_lb, d.lo * jnp.minimum(dy_box, 0.0), 0.0)
            ),                                        # 0: oob
            jnp.sum(Ddz * Ddz),                       # 1
            jnp.sum(dz * Hd_t),                       # 2
            jnp.sum(d.q * dz),                        # 3
            el_cnt,                                   # 4
        ])

        pri_norm = jnp.maximum(mx[0], mx[1])
        dua_norm = mx[2] * cinv
        dua2_norm = mx[3] * cinv
        eps_pri = settings.eps_abs + settings.eps_rel * jnp.maximum(
            jnp.maximum(mx[4], mx[5]), jnp.maximum(mx[6], mx[7])
        )
        max_norm = jnp.maximum(mx[8], jnp.maximum(mx[9], mx[10])) * cinv
        eps_dua = settings.eps_abs + settings.eps_rel * max_norm
        eps_dua_in = eps_abs_in + eps_rel_in * max_norm

        solved = (pri_norm < eps_pri) & (dua_norm < eps_dua)

        # ---- infeasibility certificates (termination.c:136-240) ----------
        eps_pinf_norm = settings.eps_prim_inf * jnp.maximum(mx[11], mx[12])
        oob = sm[0]
        pinf = (
            (eps_pinf_norm > 0)
            & (mx[13] <= eps_pinf_norm)
            & (oob <= -eps_pinf_norm)
        )

        eps_dinf_norm = settings.eps_dual_inf * mx[14]
        dzdz = sm[1]
        bound_violation = (
            (mx[17] >= eps_dinf_norm)
            | (mx[18] >= eps_dinf_norm)
            | (mx[19] >= eps_dinf_norm)
        )
        dzHdz = sm[2]
        e2 = settings.eps_dual_inf * settings.eps_dual_inf
        curvature_ok = (dzHdz <= -cfac * e2 * dzdz) | (
            (dzHdz <= cfac * e2 * dzdz)
            & (sm[3] <= -cfac * eps_dinf_norm)
        )
        dinf = (eps_dinf_norm > 0) & ~bound_violation & curvature_ok

        subproblem_done = dua2_norm <= eps_dua_in
        outer_trigger = subproblem_done | (no_change == 3)
        exhausted = it == prev_it + settings.inner_max_iter

        enter_leave = sm[4].astype(jnp.int32)

        # ---- the four branches, fused with where-selects ------------------
        do_term = (solved | pinf | dinf) & ~done
        live = ~done & ~do_term
        do_outer = live & outer_trigger
        do_exh = live & ~outer_trigger & exhausted
        do_inner = live & ~outer_trigger & ~exhausted
        do_sig = do_outer | do_exh

        # outer / exhausted: sigma update (iteration.c:86-145; the
        # unscaled pri_res feeds the boost multiplier)
        pn_uns = jnp.maximum(mx[15], mx[16])
        upd_sigma = do_sig & (it_out > 0) & (pri_norm > eps_pri)
        cond_eq = jnp.abs(pri_eq) > settings.theta * jnp.abs(pri_in_eq)
        cond_box = (
            jnp.abs(pri_box) > settings.theta * jnp.abs(pri_in_box)
        ) & active_box
        mult_eq = jnp.maximum(
            1.0, settings.delta * jnp.abs(pri_eq) / (pn_uns + 1e-6)
        )
        mult_box = jnp.maximum(
            1.0, settings.delta * jnp.abs(pri_box) / (pn_uns + 1e-6)
        )
        sig_eq_new = jnp.where(
            upd_sigma & cond_eq,
            jnp.minimum(mult_eq * sig_eq, settings.sigma_max), sig_eq,
        )
        sig_box_new = jnp.where(
            upd_sigma & cond_box,
            jnp.minimum(mult_box * sig_box, settings.sigma_max), sig_box,
        )
        y_eq_new = jnp.where(do_outer, yh_eq, y_eq)
        y_box_new = jnp.where(do_outer, yh_box, y_box)
        eps_abs_in_new = jnp.where(
            do_outer,
            jnp.maximum(settings.eps_abs, settings.rho * eps_abs_in),
            eps_abs_in,
        )
        eps_rel_in_new = jnp.where(
            do_outer,
            jnp.maximum(settings.eps_rel, settings.rho * eps_rel_in),
            eps_rel_in,
        )

        # proximal: gamma step / settled-active-set boost (qpalm.c:612-630)
        gamma_new = gamma
        gmaxed_new = gamma_maxed
        active_old_after = active_old
        nbch_after = nb_changed
        if prox:
            check = do_outer & ~gamma_maxed & (it_out > 0) \
                & (nb_changed == 0) & (pri_norm < eps_pri)
            Axys2 = Abox + y_box_new / sig_box_new
            act2 = (Axys2 <= d.lo) | (Axys2 >= d.hi)
            nb2f, nact2f = psum_vec([
                jnp.sum((act2 != active_old).astype(dtype)),
                jnp.sum(act2.astype(dtype)),
            ])
            nb2 = nb2f.astype(jnp.int32)
            nact2 = nact2f.astype(jnp.int32)
            # equality rows are always active, so the active set counts
            # them implicitly; their activity never changes
            boost = check & (nb2 == 0)
            boosted = jnp.where(
                nact2 > 0,
                jnp.maximum(
                    settings.gamma_max, 1e14 / jnp.maximum(gersh_c, 1e-30)
                ),
                jnp.asarray(1e12, dtype),
            )
            stepped = jnp.where(
                gamma < settings.gamma_max,
                jnp.minimum(gamma * settings.gamma_upd, settings.gamma_max),
                gamma,
            )
            gamma_new = jnp.where(
                do_outer, jnp.where(boost, boosted, stepped),
                jnp.where(do_exh, stepped, gamma),
            )
            gmaxed_new = gamma_maxed | (boost & (nact2 > 0))
            active_old_after = jnp.where(check, act2, active_old)
            nbch_after = jnp.where(check, jnp.minimum(nb2, 1), nb_changed)
        z0_new = jnp.where(do_sig, z, z0) if prox else z0

        pri_in_eq_new = jnp.where(do_sig, pri_eq, pri_in_eq)
        pri_in_box_new = jnp.where(do_sig, pri_box, pri_in_box)
        it_out_new = jnp.where(do_sig, it_out + 1, it_out)
        prev_it_new = jnp.where(do_sig, it, prev_it)
        no_change_after = jnp.where(do_sig, 0, no_change)

        # ---- inner: Newton via distributed SPIKE + gathered linesearch ----
        sig_box_act = jnp.where(active_box, sig_box_new, 0.0)
        Dblk, Eblk, gersh = assemble_blocks(
            sig_eq_new, sig_box_act, gamma_new
        )
        neg_dphi = -dphi
        dvec = spike_solve_local(Dblk, Eblk, neg_dphi, nd, axis)

        Hd = h_matvec(dvec)
        Hd_prox = Hd + dvec / gamma_new if prox else Hd
        eta, beta = psum_vec([
            jnp.sum(dvec * Hd_prox), jnp.sum(dvec * df)
        ])
        Ad_eq, Ad_box = a_matvec(dvec)
        sqrt_se = jnp.sqrt(sig_eq_new)
        sqrt_sb = jnp.sqrt(sig_box_new)
        s_ad = jnp.concatenate(
            [(sqrt_se * Ad_eq).ravel(), (sqrt_sb * Ad_box).ravel()]
        )
        alpha_lo = jnp.concatenate([
            ((y_eq_new + sig_eq_new * (Aeq - d.beq)) / sqrt_se).ravel(),
            ((y_box_new + sig_box_new * (Abox - d.lo)) / sqrt_sb).ravel(),
        ])
        alpha_hi = jnp.concatenate([
            ((-y_eq_new + sig_eq_new * (d.beq - Aeq)) / sqrt_se).ravel(),
            ((-y_box_new + sig_box_new * (d.hi - Abox)) / sqrt_sb).ravel(),
        ])
        delta_l = jnp.concatenate([-s_ad, s_ad])
        alpha_l = jnp.concatenate([alpha_lo, alpha_hi])
        # one all_gather for both breakpoint vectors (halves the gather
        # latency; the split below restores exactly the two-gather layout)
        both_g = jax.lax.all_gather(
            jnp.stack([delta_l, alpha_l]), axis)
        delta_g = both_g[:, 0, :].ravel()
        alpha_g = both_g[:, 1, :].ravel()
        tau = linesearch_from_breakpoints(eta, beta, delta_g, alpha_g)

        z_new = jnp.where(do_inner, z + tau * dvec, z)
        z_prev_new = jnp.where(do_inner, z, z_prev)
        Hd_t_new = jnp.where(do_inner, tau * Hd, Hd_t)
        Ad_eq_t_new = jnp.where(do_inner, tau * Ad_eq, Ad_eq_t)
        Ad_box_t_new = jnp.where(do_inner, tau * Ad_box, Ad_box_t)
        gersh_new = jnp.where(do_inner, gersh, gersh_c)
        active_old_new = jnp.where(do_inner, active_box, active_old_after)
        nbch_new = jnp.where(
            do_inner, jnp.minimum(enter_leave, 1), nbch_after
        )
        # the stall counter reads the PREVIOUS Newton step's enter/leave
        # flag (qpalm.c:664-665; device twin core.py inner_step), i.e. the
        # carried nb_changed — NOT this trip's enter_leave, which becomes
        # next trip's nb_changed via nbch_new
        no_change_new = jnp.where(
            do_inner,
            jnp.where(nb_changed > 0, 0, no_change_after + 1),
            no_change_after,
        )

        # certificates captured at termination (store_solution semantics)
        dz_eq_new = jnp.where(
            do_term & pinf & ~solved, scal.Eeq * (dy_eq / cfac), dz_cert_eq
        )
        dz_box_new = jnp.where(
            do_term & pinf & ~solved, scal.Ebox * (dy_box / cfac),
            dz_cert_box,
        )
        dx_new = jnp.where(
            do_term & dinf & ~solved & ~pinf, scal.D * dz, dx_cert
        )

        done_new = done | do_term
        status_new = jnp.where(
            do_term,
            jnp.where(
                solved, jnp.asarray(C.QPALM_SOLVED, jnp.int32),
                jnp.where(
                    pinf, jnp.asarray(C.QPALM_PRIMAL_INFEASIBLE, jnp.int32),
                    jnp.asarray(C.QPALM_DUAL_INFEASIBLE, jnp.int32),
                ),
            ),
            status,
        )
        it_new = jnp.where(done_new, it, it + 1)

        return (z_new, z0_new, z_prev_new, y_eq_new, y_box_new, sig_eq_new,
                sig_box_new, pri_in_eq_new, pri_in_box_new, eps_abs_in_new,
                eps_rel_in_new, active_old_new, gamma_new, gmaxed_new,
                gersh_new, nbch_new, no_change_new, it_new, it_out_new,
                prev_it_new, done_new, status_new, Hd_t_new, Ad_eq_t_new,
                Ad_box_t_new, dz_eq_new, dz_box_new, dx_new, pri_norm,
                dua_norm)

    return iteration


@functools.partial(
    jax.jit, static_argnames=("settings", "mesh", "axis", "has_ws")
)
@full_matmul_precision
def _solve_impl(
    data: MPCStageData,
    z_ws,
    y_eq_ws,
    y_box_ws,
    settings: Settings,
    mesh: Mesh,
    axis: str,
    has_ws: bool,
):
    nd = mesh.shape[axis]
    spec = P(axis)
    data_specs = MPCStageData(H=spec, q=spec, beq=spec, lo=spec, hi=spec,
                              Ad=P(), Bd=P())

    # scaling runs on globally-viewed arrays (XLA SPMD handles the halos)
    if settings.scaling:
        scaled, scal = scale_stage_data(data, settings.scaling)
    else:
        scaled, scal = identity_stage_scaling(data)
    sc_specs = StageScaled(H=spec, q=spec, beq=spec, lo=spec, hi=spec,
                           G=spec, Ap=spec, W=spec)
    scl_specs = StageScaling(D=spec, Eeq=spec, Ebox=spec, c=P())

    def local(dd: StageScaled, ss: StageScaling, zw, yew, ybw):
        S_loc, nb = dd.q.shape
        nx = dd.beq.shape[-1]
        dtype = dd.H.dtype
        iteration = _loop_body(dd, ss, settings, nd, axis)

        def psum(v):
            return jax.lax.psum(jnp.sum(v), axis)

        if has_ws:
            z = zw * (1.0 / ss.D)
            y_eq = yew * (1.0 / ss.Eeq) * (scal.c if settings.scaling
                                           else 1.0)
            y_box = ybw * (1.0 / ss.Ebox) * (scal.c if settings.scaling
                                             else 1.0)
        else:
            z = jnp.zeros((S_loc, nb), dtype)
            y_eq = jnp.zeros((S_loc, nx), dtype)
            y_box = jnp.zeros((S_loc, nb), dtype)

        # initialize_sigma (iteration.c:50-84)
        def a_eq(zv):
            z_last = jax.lax.ppermute(
                zv[-1], axis, [(i, (i + 1) % nd) for i in range(nd)]
            )
            z_prev = jnp.concatenate(
                [jnp.where(jax.lax.axis_index(axis) == 0,
                           jnp.zeros_like(z_last), z_last)[None], zv[:-1]],
                axis=0,
            )
            return jnp.einsum("sij,sj->si", dd.G, zv) - jnp.einsum(
                "sij,sj->si", dd.Ap, z_prev
            )

        Aeq0 = a_eq(z)
        Abox0 = dd.W * z
        Hz0 = jnp.einsum("sij,sj->si", dd.H, z)
        Hz0p = Hz0 + z / settings.gamma_init if settings.proximal else Hz0
        f = 0.5 * psum(z * Hz0p) + psum(dd.q * z)
        dist2 = psum((Aeq0 - dd.beq) ** 2) + psum(
            (Abox0 - jnp.clip(Abox0, dd.lo, dd.hi)) ** 2
        )
        sig0 = jnp.clip(
            settings.sigma_init * jnp.maximum(1.0, jnp.abs(f))
            / jnp.maximum(1.0, 0.5 * dist2),
            1e-4, 1e4,
        )

        st = (
            z,                                    # z
            z,                                    # z0 (proximal center)
            z,                                    # z_prev
            y_eq, y_box,
            jnp.full((S_loc, nx), sig0, dtype),   # sig_eq
            jnp.full((S_loc, nb), sig0, dtype),   # sig_box
            jnp.zeros((S_loc, nx), dtype),        # pri_in_eq
            jnp.zeros((S_loc, nb), dtype),        # pri_in_box
            jnp.asarray(settings.eps_abs_in, dtype),
            jnp.asarray(settings.eps_rel_in, dtype),
            jnp.zeros((S_loc, nb), bool),         # active_old
            jnp.asarray(settings.gamma_init, dtype),  # gamma
            jnp.zeros((), bool),                  # gamma_maxed
            jnp.zeros((), dtype),                 # gersh cache
            jnp.ones((), jnp.int32),              # nb_changed (unsettled)
            jnp.zeros((), jnp.int32),             # no_change
            jnp.zeros((), jnp.int32),             # iter
            jnp.zeros((), jnp.int32),             # iter_out
            jnp.zeros((), jnp.int32),             # prev_iter
            jnp.zeros((), bool),                  # done
            jnp.asarray(C.QPALM_UNSOLVED, jnp.int32),
            jnp.zeros((S_loc, nb), dtype),        # Hd_t
            jnp.zeros((S_loc, nx), dtype),        # Ad_eq_t
            jnp.zeros((S_loc, nb), dtype),        # Ad_box_t
            jnp.zeros((S_loc, nx), dtype),        # delta_y_eq cert
            jnp.zeros((S_loc, nb), dtype),        # delta_y_box cert
            jnp.zeros((S_loc, nb), dtype),        # delta_z cert
            jnp.zeros((), dtype),                 # pri_norm
            jnp.zeros((), dtype),                 # dua_norm
        )

        def cond(st):
            return (~st[20]) & (st[17] < settings.max_iter)

        final = jax.lax.while_loop(cond, iteration, st)
        status = jnp.where(
            final[20], final[21],
            jnp.asarray(C.QPALM_MAX_ITER_REACHED, jnp.int32),
        )
        # unscale (termination.c:242-252); final multiplier estimate is yh,
        # recomputed from the final iterate like store_solution
        zf = final[0]
        cinv = 1.0 / (scal.c if settings.scaling else jnp.ones((), dtype))
        z_out = ss.D * zf
        Aeqf = a_eq(zf)
        Aboxf = dd.W * zf
        yh_eq_f = final[3] + final[5] * (Aeqf - dd.beq)
        yh_box_f = final[4] + final[6] * (
            Aboxf - jnp.clip(Aboxf + final[4] / final[6], dd.lo, dd.hi)
        )
        y_eq_out = ss.Eeq * (cinv * yh_eq_f)
        y_box_out = ss.Ebox * (cinv * yh_box_f)
        return MPCResult(
            z=z_out, y_eq=y_eq_out, y_box=y_box_out, status=status,
            iterations=final[17], pri_res_norm=final[28],
            dua_res_norm=final[29], delta_y_eq=final[25],
            delta_y_box=final[26], delta_z=final[27],
        )

    ws_spec = spec
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(sc_specs, scl_specs, ws_spec, ws_spec, ws_spec),
        out_specs=MPCResult(
            z=spec, y_eq=spec, y_box=spec, status=P(), iterations=P(),
            pri_res_norm=P(), dua_res_norm=P(), delta_y_eq=spec,
            delta_y_box=spec, delta_z=spec,
        ),
        check_vma=False,
    )(scaled, scal, z_ws, y_eq_ws, y_box_ws)


def solve_mpc_stage_sharded(
    data: MPCStageData,
    settings: Settings,
    mesh: Mesh,
    axis: str = "stage",
    z0=None,
    y_eq0=None,
    y_box0=None,
) -> MPCResult:
    """Solve a stage-structured MPC QP with the horizon sharded over `mesh`.

    Full solver-parity configuration support: proximal (incl. the gamma
    boost), Ruiz scaling, warm starts (`z0`/`y_eq0`/`y_box0`, unscaled),
    and primal/dual infeasibility certificates.  Returns an `MPCResult`
    with stage-sharded solution/certificates and replicated scalars.  The
    horizon S must be divisible by the mesh size.
    """
    S, nb = data.q.shape
    nx = data.beq.shape[-1]
    dtype = data.H.dtype
    has_ws = z0 is not None or y_eq0 is not None or y_box0 is not None
    zw = jnp.asarray(z0, dtype) if z0 is not None else jnp.zeros(
        (S, nb), dtype
    )
    yew = jnp.asarray(y_eq0, dtype) if y_eq0 is not None else jnp.zeros(
        (S, nx), dtype
    )
    ybw = jnp.asarray(y_box0, dtype) if y_box0 is not None else jnp.zeros(
        (S, nb), dtype
    )
    return _solve_impl(data, zw, yew, ybw, settings, mesh, axis, has_ws)
