"""Exact piecewise-quadratic linesearch, fixed-shape for XLA.

The reference (src/linesearch.c:14-120) builds 2m breakpoints, filters the
positive ones with data-dependent compaction, qsorts them, and walks the
sorted list accumulating (a, b) until the 1-D derivative a*tau + b crosses
zero.  Data-dependent shapes and a serial walk are both poison for XLA, so
here the same math becomes:

  * build all 2m breakpoints (invalid ones keyed to +inf),
  * one `jnp.sort` (fixed shape 2m),
  * a prefix-sum of the (a, b) increments,
  * `argmax` of the first sign change.

The walk semantics (including the IEEE inf/nan conventions the reference
relies on at linesearch.c:46 for delta == 0 entries) are preserved exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def exact_linesearch(
    d: jnp.ndarray,  # (n,) newton direction
    Qd: jnp.ndarray,  # (n,) Q d (+ d/gamma when proximal) — precomputed
    Ad: jnp.ndarray,  # (m,) A d
    df: jnp.ndarray,  # (n,) gradient of f
    Ax: jnp.ndarray,  # (m,)
    y: jnp.ndarray,  # (m,)
    sigma: jnp.ndarray,  # (m,)
    sqrt_sigma: jnp.ndarray,  # (m,)
    bmin: jnp.ndarray,
    bmax: jnp.ndarray,
    mode: str = "sort",
) -> jnp.ndarray:
    """Return the exact minimizer tau of phi(x + tau*d).

    Mirrors reference linesearch.c:14-120; Qd/Ad are computed by the caller
    (reference computes them at linesearch.c:17-23) so they can be reused for
    the iterate update.  `mode` selects the sort-and-scan walk ("sort",
    the reference's qsort form) or the sort-free bisection ("bisect") —
    identical exact minimizer, see `linesearch_bisection`.
    """
    dtype = d.dtype
    eta = jnp.vdot(d, Qd)
    beta = jnp.vdot(d, df)

    s_ad = sqrt_sigma * Ad
    delta = jnp.concatenate([-s_ad, s_ad])  # (2m,)
    alpha_lo = (y + sigma * (Ax - bmin)) / sqrt_sigma
    alpha_hi = (-y + sigma * (bmax - Ax)) / sqrt_sigma
    alpha = jnp.concatenate([alpha_lo, alpha_hi])  # (2m,)

    if mode == "bisect":
        return linesearch_bisection(eta, beta, delta, alpha)
    return linesearch_from_breakpoints(eta, beta, delta, alpha)


def linesearch_bisection(eta, beta, delta, alpha, iters: int = 30):
    """Sort-free exact linesearch: safeguarded Newton/bisection on the
    monotone piecewise-linear derivative

        psi'(tau) = eta*tau + beta + sum_i delta_i * (delta_i*tau - alpha_i)
                                              * 1[delta_i*tau - alpha_i > 0]

    which is the same function the sorted breakpoint walk of
    `linesearch_from_breakpoints` evaluates piece by piece (reference:
    linesearch.c:96-117 — each passed breakpoint adds delta^2 to the slope
    and -delta*alpha to the intercept; hinges with delta < 0 deactivate).

    Within the correct piece the Newton proposal -b/a is the *exact* root,
    and each bisection halving reduces the candidate piece set, so `iters`
    ~ log2(2m) + a few lands exactly.  No sort, no scan: each step is a
    handful of fused elementwise ops — the form a vectorized device
    kernel wants.  Matches `linesearch_from_breakpoints` to fp tolerance,
    including the tau <= 0 case (derivative already positive at 0+, where
    the reference returns -b0/a0 from the 0+ piece).
    """
    dtype = delta.dtype
    dd = delta * delta
    da = delta * alpha

    def ab_at(tau):
        act = (delta * tau - alpha) > 0
        a = eta + jnp.sum(jnp.where(act, dd, 0.0), axis=-1)
        b = beta - jnp.sum(jnp.where(act, da, 0.0), axis=-1)
        return a, b

    # the 0+ piece (reference j_mask): hinges active just right of 0
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    a0, b0 = ab_at(tiny)

    # bracket: hi beyond every positive breakpoint and the final-piece root
    s = alpha / delta
    s_valid = jnp.where(s > 0, s, 0.0)
    s_max = jnp.max(jnp.where(jnp.isfinite(s_valid), s_valid, 0.0), axis=-1)
    act_fin = delta > 0
    a_fin = eta + jnp.sum(jnp.where(act_fin, dd, 0.0), axis=-1)
    b_fin = beta - jnp.sum(jnp.where(act_fin, da, 0.0), axis=-1)
    tau_fin = -b_fin / jnp.maximum(a_fin, tiny)
    hi = jnp.maximum(jnp.maximum(s_max, tau_fin), 1.0) * 1.01 + 1.0
    lo = jnp.zeros_like(hi)

    def step(_, state):
        lo, hi, tau = state
        a, b = ab_at(tau)
        # exact root of the current piece, safeguarded into the bracket
        prop = -b / jnp.maximum(a, tiny)
        mid = 0.5 * (lo + hi)
        prop = jnp.where((prop > lo) & (prop < hi), prop, mid)
        pa, pb = ab_at(prop)
        pos = pa * prop + pb > 0
        return (
            jnp.where(pos, lo, prop),
            jnp.where(pos, prop, hi),
            prop,
        )

    tau0 = jnp.minimum(-b0 / jnp.maximum(a0, tiny), hi)
    tau0 = jnp.where(tau0 > 0, tau0, 0.5 * hi)
    lo, hi, tau = jax.lax.fori_loop(0, iters, step, (lo, hi, tau0))
    # final exact Newton step from the landed piece
    a, b = ab_at(tau)
    tau_star = -b / jnp.maximum(a, tiny)
    # derivative already positive at 0+ -> the reference's tau <= 0 answer
    return jnp.where(a0 * tiny + b0 > 0, -b0 / a0, tau_star)


def linesearch_from_breakpoints(eta, beta, delta, alpha):
    """The sort-and-scan tail of the exact linesearch, operating on
    pre-built breakpoint vectors.  Split out so the stage-sharded MPC loop
    (parallel/mpc_loop.py) can build `delta`/`alpha` locally per shard,
    all_gather them, and run this tail replicated on every device."""
    dtype = delta.dtype
    # s = alpha ./ delta with IEEE semantics: delta==0 gives +-inf (kept when
    # positive, harmless: its increments are 0) or nan (dropped by s > 0).
    s = alpha / delta
    l_mask = s > 0  # nan compares false
    p_mask = delta > 0
    j_mask = jnp.logical_xor(p_mask, l_mask)

    dd = delta * delta
    da_raw = delta * alpha
    jf = j_mask.astype(dtype)
    a0 = eta + jnp.sum(jf * dd)
    b0 = beta - jnp.sum(jf * da_raw)

    # per-breakpoint increments applied when the walk passes breakpoint i
    # (reference linesearch.c:96-117): +dd/-da if delta>0 else -dd/+da
    inc_a = jnp.where(p_mask, dd, -dd)
    inc_b = jnp.where(p_mask, -da_raw, da_raw)

    key = jnp.where(l_mask, s, jnp.full_like(s, jnp.inf))
    order = jnp.argsort(key)
    s_sorted = key[order]
    valid = l_mask[order]
    vf = valid.astype(dtype)
    inc_a_sorted = inc_a[order] * vf
    inc_b_sorted = inc_b[order] * vf

    ca = jnp.cumsum(inc_a_sorted)
    cb = jnp.cumsum(inc_b_sorted)
    zero = jnp.zeros((1,), dtype)
    a_k = a0 + jnp.concatenate([zero, ca[:-1]])  # prefix sums before breakpoint k
    b_k = b0 + jnp.concatenate([zero, cb[:-1]])

    crossed = valid & (a_k * s_sorted + b_k > 0)
    any_crossed = jnp.any(crossed)
    k = jnp.argmax(crossed)

    a_fin = a0 + ca[-1]
    b_fin = b0 + cb[-1]
    a_sel = jnp.where(any_crossed, a_k[k], a_fin)
    b_sel = jnp.where(any_crossed, b_k[k], b_fin)
    return -b_sel / a_sel
