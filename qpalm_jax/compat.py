"""Drop-in compatibility shim for the reference Python binding.

Mirrors the surface of `class Qpalm` in the reference
(interfaces/python/qpalm.py:191-401): `set_data`, `_solve`, `_warm_start`,
`_update_bounds`, `_update_q`, `_update_settings`, a mutable `_settings`
object, and results on `_work.solution` / `_work.info` — so a user of the
reference binding can switch with minimal edits.  New code should prefer
qpalm_jax.QPALM.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Optional

import numpy as np

from .api import QPALM
from .types import Settings


class _MutableSettings:
    """Attribute-mutable mirror of the frozen Settings dataclass, matching
    the reference's `solver._settings.contents.eps_abs = ...` usage (the
    `.contents` hop of ctypes is collapsed: `_settings.eps_abs = ...`)."""

    def __init__(self):
        object.__setattr__(self, "_values", {})
        for f in dataclasses.fields(Settings):
            self._values[f.name] = f.default

    def __getattr__(self, k):
        values = object.__getattribute__(self, "_values")
        if k in values:
            return values[k]
        raise AttributeError(k)

    def __setattr__(self, k, v):
        values = object.__getattribute__(self, "_values")
        if k not in values:
            raise AttributeError(f"unknown setting {k!r}")
        values[k] = v

    @property
    def contents(self):  # reference ctypes-style access
        return self

    def freeze(self) -> Settings:
        return Settings(**object.__getattribute__(self, "_values"))


class Qpalm:
    """Reference-compatible wrapper (reference: interfaces/python/qpalm.py)."""

    def __init__(self):
        self._settings = _MutableSettings()
        self._solver: Optional[QPALM] = None
        self._work = SimpleNamespace(solution=None, info=None)
        self._ws = None
        self._pending_data = None

    def set_data(self, Q, A, q, bmin, bmax):
        """Store problem data (reference: qpalm.py set_data).  Q is
        symmetrized like the reference (`Q = (Q+Q')/2`)."""
        Q = (Q + Q.T) / 2.0
        self._pending_data = (Q, A, np.asarray(q, float),
                              np.asarray(bmin, float), np.asarray(bmax, float))
        self._solver = None
        self._ws = None  # a pending warm start belongs to the OLD problem

    def _setup(self):
        if self._pending_data is None:
            raise RuntimeError("call set_data first")
        Q, A, q, bmin, bmax = self._pending_data
        self._solver = QPALM(Q, A, q, bmin, bmax,
                             settings=self._settings.freeze())

    def _solve(self):
        if self._solver is None:
            self._setup()
        if self._ws is not None:
            self._solver.warm_start(*self._ws)
            self._ws = None
        res = self._solver.solve()
        self._work.solution = res.solution
        self._work.info = res.info
        return res

    def _warm_start(self, x, y):
        self._ws = (np.asarray(x, float), np.asarray(y, float))

    def _update_settings(self):
        if self._solver is not None:
            self._solver.update_settings(self._settings.freeze())

    def _update_bounds(self, bmin, bmax):
        if self._solver is None:
            self._setup()
        self._solver.update_bounds(bmin, bmax)

    def _update_q(self, q):
        if self._solver is None:
            self._setup()
        self._solver.update_q(q)
