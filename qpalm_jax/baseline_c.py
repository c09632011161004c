"""ctypes binding to the native C/LAPACK baseline solver
(native/qpalm_baseline.cpp).

This is bench.py's honest stand-in for the reference C solver: the
environment cannot build C-QPALM itself (the LADEL/SuiteSparse submodules
are empty upstream), so the baseline is a single-threaded dense
double-precision P-ALM + semismooth-Newton solver over LAPACK
dpotrf/dpotrs and BLAS dgemv/dsyrk, with the same iteration semantics and
stopping protocol as the reference (reference: src/qpalm.c:401-736).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from . import native_build

_LIB_PATH = native_build.lib_path("libqpalm_baseline.so")

_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[Exception] = None

_DP = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_IP = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def load_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the baseline library.  Returns None, with
    a RuntimeWarning that carries the build or load error, if unavailable;
    `require_library` raises that error instead."""
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    try:
        if not os.path.exists(_LIB_PATH):
            native_build.build()
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            # built elsewhere (another BLAS path): rebuild here once
            native_build.build(force=True)
            lib = ctypes.CDLL(_LIB_PATH)
    except (OSError, RuntimeError) as e:
        _lib_error = e
        native_build.report_unavailable("libqpalm_baseline.so", e)
        return None
    lib.qpalm_baseline_solve.restype = ctypes.c_int
    lib.qpalm_baseline_solve.argtypes = [
        ctypes.c_int, ctypes.c_int,          # n, m
        _DP, _DP, _DP, _DP, _DP,             # Q, A, q, bmin, bmax
        ctypes.c_double, ctypes.c_double,    # eps_abs, eps_rel
        ctypes.c_int, ctypes.c_int,          # max_iter, scaling
        ctypes.c_double,                     # delta
        _DP, _DP,                            # x_out, y_out
        ctypes.POINTER(ctypes.c_int),        # iter_out
        ctypes.POINTER(ctypes.c_double),     # obj_out
    ]
    if hasattr(lib, "qpalm_sparse_baseline_solve"):
        lib.qpalm_sparse_baseline_solve.restype = ctypes.c_int
        lib.qpalm_sparse_baseline_solve.argtypes = [
            ctypes.c_int, ctypes.c_int,          # n, m
            _IP, _IP, _DP, ctypes.c_int,         # Qp, Qi, Qx, Qnnz
            _IP, _IP, _DP, ctypes.c_int,         # Ap, Ai, Ax, Annz
            _DP, _DP, _DP,                       # q, bmin, bmax
            ctypes.c_double, ctypes.c_double,    # eps_abs, eps_rel
            ctypes.c_int, ctypes.c_int,          # max_iter, scaling
            ctypes.c_double,                     # delta
            ctypes.c_int, ctypes.c_double,       # flags, time_limit
            _DP, _DP,                            # x_out, y_out
            ctypes.POINTER(ctypes.c_int),        # iter_out
            ctypes.POINTER(ctypes.c_double),     # obj_out
            _DP, _DP,                            # dy_out, dx_out (certs)
        ]
    _lib = lib
    return lib


def require_library() -> ctypes.CDLL:
    """The baseline library, or RuntimeError with why it is unavailable."""
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native baseline library unavailable: "
                           f"{_lib_error}") from _lib_error
    return lib


def solve(Q, A, q, bmin, bmax, eps_abs=1e-6, eps_rel=1e-6,
          max_iter=10000, scaling=10, delta=100.0):
    """Solve one dense QP with the native baseline.

    Returns dict(status, x, y, iter, objective).  Raises RuntimeError if the
    native library cannot be built/loaded.
    """
    lib = require_library()
    Q = np.ascontiguousarray(Q, np.float64)
    A = np.ascontiguousarray(A, np.float64)
    q = np.ascontiguousarray(q, np.float64)
    bmin = np.ascontiguousarray(bmin, np.float64)
    bmax = np.ascontiguousarray(bmax, np.float64)
    m, n = A.shape
    x = np.zeros(n)
    y = np.zeros(m)
    it = ctypes.c_int(0)
    obj = ctypes.c_double(0.0)
    status = lib.qpalm_baseline_solve(
        n, m, Q, A, q, bmin, bmax, float(eps_abs), float(eps_rel),
        int(max_iter), int(scaling), float(delta),
        x, y, ctypes.byref(it), ctypes.byref(obj),
    )
    return {
        "status": int(status), "x": x, "y": y,
        "iter": int(it.value), "objective": float(obj.value),
    }


def solve_sparse(Q, A, q, bmin, bmax, eps_abs=1e-6, eps_rel=1e-6,
                 max_iter=50000, scaling=10, delta=100.0, rescue=False,
                 time_limit=0.0, rescue_window=0):
    """Solve one sparse QP with the native single-threaded sparse solver
    (native/qpalm_sparse_baseline.cpp): reference C-QPALM semantics over a
    sparse LDL' with AMD ordering, Schur form (the reference's CHOLMOD
    backend class, solver_interface.c:72-74).  `Q`, `A` are scipy sparse
    (any format); returns dict(status, x, y, iter, objective).

    `rescue=False` is the reference-semantics BASELINE configuration used
    for comparison columns; `rescue=True` enables the framework's
    stagnation rescue (host_sparse.py twin) when this engine runs as the
    framework's native host path.  `time_limit` (s): status -3 when hit.
    """
    import scipy.sparse as sp

    lib = require_library()
    if not hasattr(lib, "qpalm_sparse_baseline_solve"):
        raise RuntimeError("native sparse baseline unavailable")
    Q = sp.csc_matrix(Q)
    A = sp.csc_matrix(A)
    Q.sort_indices()
    A.sort_indices()
    n = Q.shape[0]
    m = A.shape[0]
    q = np.ascontiguousarray(q, np.float64).ravel()
    bmin = np.ascontiguousarray(bmin, np.float64).ravel()
    bmax = np.ascontiguousarray(bmax, np.float64).ravel()
    x = np.zeros(n)
    y = np.zeros(m)
    dy = np.zeros(m)
    dx = np.zeros(n)
    it = ctypes.c_int(0)
    obj = ctypes.c_double(0.0)
    status = lib.qpalm_sparse_baseline_solve(
        n, m,
        np.ascontiguousarray(Q.indptr, np.int32),
        np.ascontiguousarray(Q.indices, np.int32),
        np.ascontiguousarray(Q.data, np.float64), int(Q.nnz),
        np.ascontiguousarray(A.indptr, np.int32),
        np.ascontiguousarray(A.indices, np.int32),
        np.ascontiguousarray(A.data, np.float64), int(A.nnz),
        q, bmin, bmax, float(eps_abs), float(eps_rel),
        int(max_iter), int(scaling), float(delta),
        int(bool(rescue)) | (int(rescue_window) & 0x7F) << 1,
        float(time_limit),
        x, y, ctypes.byref(it), ctypes.byref(obj), dy, dx,
    )
    status = int(status)
    return {
        "status": status, "x": x, "y": y,
        "iter": int(it.value), "objective": float(obj.value),
        "delta_y": dy if status == -3 else None,
        "delta_x": dx if status == -4 else None,
    }
