"""Matmul-precision policy for the solver's device compute paths.

At *default* precision JAX lets an accelerator lower a float32
`dot`/`@`/`einsum` to reduced-precision products: on an NVIDIA GPU from
Ampere on, a default-precision f32 matmul runs on the tensor cores in
TF32 (a 10-bit mantissa, about 3 decimal digits; measured on an H100 80GB
HBM3 at 700 W: the product of two 64x64 f32 matrices with O(1) entries is
off by up to ~1e-3 at default precision, ~6e-7 at 'highest').  For an optimization solver whose residuals, Newton systems
and certificates live at 1e-4..1e-6 that is the wrong default: residuals
floor above the tolerance and iteration counts drift from the reference
arithmetic.

`full_matmul_precision` scopes `jax.default_matmul_precision("highest")`
(true f32 products) around a traced function body.  Applied beneath
`jax.jit` on the root compute functions, the whole nested trace (newton,
linesearch, CG, certificates) inherits it without touching library-global
config.  Every new jitted entry point that does matvecs must be decorated
(or trace under the same scope).

Reference anchor: the reference is all-double C (`c_float = double`,
global_opts.h:21); full f32 + f64 polish is this framework's documented
speed/accuracy trade (BASELINE.md north star).
"""
from __future__ import annotations

import functools

import jax

__all__ = ["full_matmul_precision"]


def full_matmul_precision(fn):
    """Trace `fn` under jax.default_matmul_precision('highest')."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
