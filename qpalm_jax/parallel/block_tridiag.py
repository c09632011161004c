"""Block-tridiagonal SPD solves: sequential (block Thomas) and
stage-partitioned across a device mesh (SPIKE / Schur-complement reduction).

Why this exists: MPC-ladder QPs (reference workload chain80w,
simulations/chain80w/info.txt:16-24) have stage-banded KKT structure — with
z = [x_1..x_N | u_0..u_{N-1}] ordered by stages, the P-ALM Schur matrix
M = H + A' Sigma A is block-tridiagonal at stage granularity (dynamics
couple adjacent stages only; box constraints are diagonal).  The reference
factors it as one global sparse LDL' (solver_interface.c:372-405); the
design here partitions stages across devices and reduces the
interfaces with collectives — the "Schur-complement reduction of block-partitioned
KKT systems" called for in SURVEY §2.4/§5.

Layout:  M = blocktridiag(D_0..D_{S-1}; E_0..E_{S-2}) with D_k (nb, nb) SPD
blocks and E_k the subdiagonal coupling (block row k+1, column k).

* `thomas_solve(D, E, b)` — sequential block Cholesky-Thomas via lax.scan;
  the single-device / per-chunk workhorse.
* `spike_solve(D, E, b, mesh, axis)` — stages sharded over the mesh; each
  device factors its chunk once, forms boundary spikes, reduces the
  interface system by distributed odd-even cyclic reduction
  (O(nb^3 log nd) compute, O(nb^2 log nd) interconnect traffic per device via
  log2(nd) ppermute rounds), and back-substitutes locally.  Non-power-of-
  two meshes fall back to an all_gather + replicated QR of the
  (2 * devices * nb) reduced system.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..precision import full_matmul_precision


def _chol(M):
    return jnp.linalg.cholesky(M)


def _chol_solve(L, B):
    from jax.scipy.linalg import solve_triangular

    y = solve_triangular(L, B, lower=True)
    return solve_triangular(L, y, lower=True, trans=1)


def thomas_factor(D: jnp.ndarray, E: jnp.ndarray):
    """Block LDL'-style forward elimination.

    D: (S, nb, nb) diagonal blocks, E: (S-1, nb, nb) subdiagonal blocks
    (E[k] sits at block (k+1, k)).  Returns per-stage Cholesky factors of
    the eliminated diagonal blocks, for reuse across solves.
    """
    S, nb, _ = D.shape

    def step(carry, inp):
        Schur_prev = carry  # (nb, nb): D_k - E_{k-1} D̂_{k-1}^-1 E_{k-1}'
        Dk, Ekm1, first = inp
        L_prev = _chol(Schur_prev)
        W = _chol_solve(L_prev, Ekm1.T)  # D̂_{k-1}^-1 E_{k-1}'
        Schur_k = jnp.where(first, Dk, Dk - Ekm1 @ W)
        return Schur_k, (L_prev, W)

    E_pad = jnp.concatenate([jnp.zeros((1, nb, nb), D.dtype), E], axis=0)
    firsts = jnp.arange(S) == 0
    # scan over stages: carry is the running Schur block
    Schur_last, (L_all, W_all) = jax.lax.scan(
        step, jnp.eye(nb, dtype=D.dtype), (D, E_pad, firsts)
    )
    # L_all[k] is the factor of stage k-1's eliminated block; roll so
    # L[k] factors stage k, and append the last
    L_last = _chol(Schur_last)
    L = jnp.concatenate([L_all[1:], L_last[None]], axis=0)
    W = jnp.concatenate([W_all[1:], jnp.zeros((1, nb, nb), D.dtype)], axis=0)
    # W[k] = D̂_k^-1 E_k' for k < S-1
    return L, W


def thomas_solve(D: jnp.ndarray, E: jnp.ndarray, b: jnp.ndarray,
                 factors=None) -> jnp.ndarray:
    """Solve the block-tridiagonal SPD system M x = b.

    b: (S, nb) or (S, nb, k) for multiple right-hand sides.
    """
    squeeze = b.ndim == 2
    if squeeze:
        b = b[..., None]
    S, nb, k = b.shape
    if factors is None:
        factors = thomas_factor(D, E)
    L, W = factors
    E_pad = jnp.concatenate([jnp.zeros((1, nb, nb), D.dtype), E], axis=0)

    # forward: y_k = b_k - E_{k-1} D̂_{k-1}^-1 y_{k-1}
    def fwd(carry, inp):
        y_prev = carry  # D̂_{k-1}^-1 y_{k-1} (zeros for k=0)
        bk, Ekm1, Lk = inp
        yk = bk - Ekm1 @ y_prev
        zk = _chol_solve(Lk, yk)  # D̂_k^-1 y_k
        return zk, zk

    z0 = jnp.zeros((nb, k), D.dtype)
    _, z = jax.lax.scan(fwd, z0, (b, E_pad, L))

    # backward: x_k = z_k - D̂_k^-1 E_k' x_{k+1} = z_k - W_k x_{k+1}
    def bwd(carry, inp):
        x_next = carry
        zk, Wk = inp
        xk = zk - Wk @ x_next
        return xk, xk

    _, x_rev = jax.lax.scan(
        bwd, jnp.zeros((nb, k), D.dtype), (z[::-1], W[::-1])
    )
    x = x_rev[::-1]
    return x[..., 0] if squeeze else x


def _local_spikes(D, E, E_left, E_right, b):
    """Factor the local chunk and solve for [V | W | g]:

        A_d V = e_first E_left     (spike to the left neighbor's last stage:
                                    global row `first` carries E_left x_prev)
        A_d W = e_last  E_right'   (row `last` carries E_right' x_next)
        A_d g = b
    """
    S, nb = D.shape[0], D.shape[1]
    factors = thomas_factor(D, E)
    rhs_V = jnp.zeros((S, nb, nb), D.dtype).at[0].set(E_left)
    rhs_W = jnp.zeros((S, nb, nb), D.dtype).at[-1].set(E_right.T)
    # one multi-RHS solve: the sequential forward/backward scans dominate
    # the latency, so [V | W | g] share a single scan pair
    rhs = jnp.concatenate([rhs_V, rhs_W, b[..., None]], axis=-1)
    sol = thomas_solve(D, E, rhs, factors)
    V = sol[..., :nb]
    Wsp = sol[..., nb:2 * nb]
    g = sol[..., 2 * nb]
    return V, Wsp, g


def _qr_solve(B, X):
    """Solve B Z = X with QR (Householder QR needs no pivoting)."""
    from jax.scipy.linalg import solve_triangular

    Qf, Rf = jnp.linalg.qr(B)
    return solve_triangular(Rf, Qf.T @ X, lower=False)


def _reduced_solve_cr(Vf, Vl, Wf, Wl, gf, gl, nd: int, axis_name: str):
    """Distributed block cyclic reduction of the SPIKE interface system.

    The reduced system over the per-chunk boundary unknowns
    u_d = [x_first_d; x_last_d] is itself block-tridiagonal in the device
    index:

        B_d u_d + C_d u_{d-1} + F_d u_{d+1} = g_d,
        B_d = I,  C_d = [[0, Vf],[0, Vl]],  F_d = [[Wf, 0],[Wl, 0]]

    so instead of all_gathering it and QR-factoring the dense
    (2 nd nb)^2 matrix replicated on every device (O((nd nb)^3), the
    round-1 implementation), odd-even cyclic reduction eliminates half the
    device rows per level: log2(nd) ppermute rounds, O(nb^3 log nd)
    compute and O(nb^2 log nd) interconnect traffic per device.  Requires nd to be
    a power of two (the caller falls back to the gather path otherwise).

    Returns u_d = (x_first_d, x_last_d), each (nb,).
    """
    nb = Vf.shape[-1]
    two = 2 * nb
    dtype = Vf.dtype
    idx = jax.lax.axis_index(axis_name)
    eye = jnp.eye(two, dtype=dtype)
    B = eye
    C = jnp.zeros((two, two), dtype)
    C = C.at[:nb, nb:].set(Vf).at[nb:, nb:].set(Vl)
    F = jnp.zeros((two, two), dtype)
    F = F.at[:nb, :nb].set(Wf).at[nb:, :nb].set(Wl)
    g = jnp.concatenate([gf, gl])[:, None]  # (2nb, 1)
    levels = max(nd.bit_length() - 1, 0)

    def fetch(vals, s, direction):
        """Rows of the neighbor at idx - s (direction=-1) / idx + s (+1);
        out-of-range fetches return B=I, C=F=0, g=0 (a no-op row)."""
        if direction < 0:
            perm = [(i, (i + s) % nd) for i in range(nd)]
            valid = idx >= s
        else:
            perm = [(i, (i - s) % nd) for i in range(nd)]
            valid = idx + s < nd
        Bv, Cv, Fv, gv = (
            jax.lax.ppermute(v, axis_name, perm) for v in vals
        )
        Bv = jnp.where(valid, Bv, eye)
        Cv = jnp.where(valid, Cv, 0.0)
        Fv = jnp.where(valid, Fv, 0.0)
        gv = jnp.where(valid, gv, 0.0)
        return Bv, Cv, Fv, gv

    for r in range(levels):
        s = 1 << r
        Bl, Cl, Fl, gl_ = fetch((B, C, F, g), s, -1)
        Br, Cr, Fr, gr_ = fetch((B, C, F, g), s, +1)
        CBl = C @ _qr_solve(Bl, jnp.concatenate([Fl, Cl, gl_], axis=1))
        FBr = F @ _qr_solve(Br, jnp.concatenate([Cr, Fr, gr_], axis=1))
        B_new = B - CBl[:, :two] - FBr[:, :two]
        C_new = -CBl[:, two:2 * two]
        F_new = -FBr[:, two:2 * two]
        g_new = g - CBl[:, 2 * two:] - FBr[:, 2 * two:]
        keep = (idx % (2 * s)) == 0  # this row survives to the next level
        B = jnp.where(keep, B_new, B)
        C = jnp.where(keep, C_new, C)
        F = jnp.where(keep, F_new, F)
        g = jnp.where(keep, g_new, g)

    # root solve (device 0's row has no remaining couplings)
    u = jnp.where(idx == 0, _qr_solve(B, g), jnp.zeros_like(g))

    for r in range(levels - 1, -1, -1):
        s = 1 << r
        perm_l = [(i, (i + s) % nd) for i in range(nd)]
        perm_r = [(i, (i - s) % nd) for i in range(nd)]
        u_left = jax.lax.ppermute(u, axis_name, perm_l)
        u_right = jax.lax.ppermute(u, axis_name, perm_r)
        u_left = jnp.where(idx >= s, u_left, 0.0)
        u_right = jnp.where(idx + s < nd, u_right, 0.0)
        solver = (idx % (2 * s)) == s  # eliminated at level r: solve now
        u_new = _qr_solve(B, g - C @ u_left - F @ u_right)
        u = jnp.where(solver, u_new, u)

    u = u[:, 0]
    return u[:nb], u[nb:]


def spike_solve_local(D_loc, E_loc, b_loc, nd: int, axis_name: str):
    """The shard-local SPIKE computation: to be called INSIDE a shard_map
    whose `axis_name` axis shards the stages.  Used by `spike_solve` and by
    the stage-sharded MPC solve loop (parallel/mpc_loop.py) where the whole
    P-ALM iteration lives inside one shard_map."""
    idx = jax.lax.axis_index(axis_name)
    nb = D_loc.shape[1]
    # couplings to neighbors: E_left = E[last of prev chunk] lives on
    # the previous device — fetch via ppermute of each chunk's last E
    my_last_E = E_loc[-1]
    E_from_left = jax.lax.ppermute(
        my_last_E, axis_name,
        [(i, (i + 1) % nd) for i in range(nd)],
    )
    is_first = idx == 0
    is_last = idx == nd - 1
    E_left = jnp.where(is_first, jnp.zeros_like(E_from_left), E_from_left)
    E_right = jnp.where(is_last, jnp.zeros_like(my_last_E), my_last_E)

    E_interior = E_loc[:-1]
    V, Wsp, g = _local_spikes(D_loc, E_interior, E_left, E_right, b_loc)

    if nd & (nd - 1) == 0 and nd > 1:
        # power-of-two mesh: O(nb^3 log nd) distributed cyclic reduction
        u_first, u_last = _reduced_solve_cr(
            V[0], V[-1], Wsp[0], Wsp[-1], g[0], g[-1], nd, axis_name
        )
        x_last_prev = jax.lax.ppermute(
            u_last, axis_name, [(i, (i + 1) % nd) for i in range(nd)]
        )
        x_first_next = jax.lax.ppermute(
            u_first, axis_name, [(i, (i - 1) % nd) for i in range(nd)]
        )
        x_last_prev = jnp.where(is_first, 0.0, x_last_prev)
        x_first_next = jnp.where(is_last, 0.0, x_first_next)
        return g - V @ x_last_prev - Wsp @ x_first_next

    # fallback (non-power-of-two meshes): gather the reduced interface
    # system and QR-solve it redundantly on every device
    bd = jnp.stack([V[0], V[-1], Wsp[0], Wsp[-1]])  # (4, nb, nb)
    gb = jnp.stack([g[0], g[-1]])  # (2, nb)
    all_bd = jax.lax.all_gather(bd, axis_name)  # (nd, 4, nb, nb)
    all_gb = jax.lax.all_gather(gb, axis_name)  # (nd, 2, nb)

    # unknowns: u = [x_first_0, x_last_0, x_first_1, x_last_1, ...]
    # equations:  x_first_d = g_first_d - V_first_d x_last_{d-1}
    #                                  - W_first_d x_first_{d+1}
    #             x_last_d  = g_last_d - V_last_d x_last_{d-1}
    #                                  - W_last_d x_first_{d+1}
    n_u = 2 * nd * nb
    eye = jnp.eye(nb, dtype=D_loc.dtype)
    R = jnp.zeros((n_u, n_u), D_loc.dtype)
    rhs = jnp.zeros((n_u,), D_loc.dtype)
    for d in range(nd):
        rf = (2 * d) * nb      # row block: x_first_d
        rl = (2 * d + 1) * nb  # row block: x_last_d
        Vf, Vl = all_bd[d, 0], all_bd[d, 1]
        Wf, Wl = all_bd[d, 2], all_bd[d, 3]
        R = R.at[rf:rf + nb, rf:rf + nb].set(eye)
        R = R.at[rl:rl + nb, rl:rl + nb].set(eye)
        if d > 0:
            cl_prev = (2 * (d - 1) + 1) * nb
            R = R.at[rf:rf + nb, cl_prev:cl_prev + nb].add(Vf)
            R = R.at[rl:rl + nb, cl_prev:cl_prev + nb].add(Vl)
        if d < nd - 1:
            cf_next = (2 * (d + 1)) * nb
            R = R.at[rf:rf + nb, cf_next:cf_next + nb].add(Wf)
            R = R.at[rl:rl + nb, cf_next:cf_next + nb].add(Wl)
        rhs = rhs.at[rf:rf + nb].set(all_gb[d, 0])
        rhs = rhs.at[rl:rl + nb].set(all_gb[d, 1])

    # tiny dense system, solved redundantly on every device, with QR
    # (no pivoting needed)
    from jax.scipy.linalg import solve_triangular

    Qr, Rr = jnp.linalg.qr(R)
    u = solve_triangular(Rr, Qr.T @ rhs, lower=False)
    u = u.reshape(2 * nd, nb)

    x_last_prev = jnp.where(
        is_first, jnp.zeros((nb,), D_loc.dtype), u[2 * idx - 1]
    )
    x_first_next = jnp.where(
        is_last, jnp.zeros((nb,), D_loc.dtype),
        u[jnp.minimum(2 * (idx + 1), 2 * nd - 1)],
    )
    return g - V @ x_last_prev - Wsp @ x_first_next


@functools.partial(jax.jit, static_argnames=("mesh", "axis_name"))
@full_matmul_precision
def spike_solve(
    D: jnp.ndarray,
    E: jnp.ndarray,
    b: jnp.ndarray,
    mesh: Mesh,
    axis_name: str = "stage",
) -> jnp.ndarray:
    """Distributed block-tridiagonal solve, stages sharded over `mesh`.

    D: (S, nb, nb), E: (S, nb, nb) with E[k] coupling block rows k, k+1
    (the last E[S-1] is ignored/zero), b: (S, nb).  S must be divisible by
    the mesh size.  Returns x replicated? No — x is returned stage-sharded
    like the inputs.
    """
    nd = mesh.shape[axis_name]
    spec3 = P(axis_name)

    def local(D_loc, E_loc, b_loc):
        return spike_solve_local(D_loc, E_loc, b_loc, nd, axis_name)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(spec3, spec3, spec3),
        out_specs=spec3,
        check_vma=False,
    )(D, E, b)


def extract_block_tridiag(M: jnp.ndarray, nb: int):
    """Slice a dense stage-ordered matrix into (D, E) block-tridiag form.

    For an MPC QP with stage-interleaved variables z_k = [x_k; u_k], the
    P-ALM Schur matrix M = H + A' Sigma_act A is block-tridiagonal with
    block size nb = nx + nu (dynamics couple adjacent stages only, box rows
    are diagonal), so this extraction is exact.  Returns
    D: (S, nb, nb), E: (S, nb, nb) with E[k] = M[(k+1)-block, k-block]
    (E[S-1] zero), ready for `thomas_solve` / `spike_solve`.
    """
    n = M.shape[0]
    S = n // nb
    Mb = M.reshape(S, nb, S, nb).transpose(0, 2, 1, 3)  # (S, S, nb, nb)
    D = Mb[jnp.arange(S), jnp.arange(S)]
    E = jnp.zeros((S, nb, nb), M.dtype)
    E = E.at[: S - 1].set(Mb[jnp.arange(1, S), jnp.arange(S - 1)])
    return D, E


def block_tridiag_error(M: jnp.ndarray, nb: int):
    """Max |entry| of M outside the block-tridiagonal band — a cheap check
    that a given ordering really is stage-banded before using spike_solve."""
    n = M.shape[0]
    S = n // nb
    blk_r = jnp.arange(n) // nb
    mask = jnp.abs(blk_r[:, None] - blk_r[None, :]) <= 1
    return jnp.max(jnp.abs(jnp.where(mask, 0.0, M)))
