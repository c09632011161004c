"""ctypes binding to the native sparse LDL' backend (native/sparse_ldl.cpp)
— the framework's LADEL equivalence class (reference:
src/solver_interface.c:319-405).

`SparseLDL` analyzes a (scipy CSC, upper-triangular) pattern once, then
supports repeated numeric refactorizations with new values and a diagonal
shift — exactly the access pattern of the P-ALM Newton loop where the
pattern (all-constraints-active superset) is fixed but values change with
the active set / penalties / gamma.  Fill-reducing ordering: reverse
Cuthill-McKee (scipy) applied symmetrically before analysis.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np
import scipy.sparse as sp

from .. import native_build

_LIB_PATH = native_build.lib_path("libqpalm_ldl.so")

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False

_IP = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_DP = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_FP = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


_lib_lock = threading.Lock()


def load_library() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    # serialized: concurrent first loads (e.g. solve_sparse_batch worker
    # threads) must not observe _lib_tried=True before _lib is assigned
    with _lib_lock:
        if _lib is not None or _lib_tried:
            return _lib
        lib = _load_and_bind(rebuild=not os.path.exists(_LIB_PATH))
        if lib is None and os.path.exists(_LIB_PATH):
            # a stale .so from an older commit lacks the newer symbols
            # (sldl_*/amd_order): force a rebuild and retry once
            lib = _load_and_bind(rebuild=True)
        _lib = lib
        _lib_tried = True
    return lib


def _load_and_bind(rebuild: bool) -> Optional[ctypes.CDLL]:
    try:
        if rebuild:
            native_build.build(force=True)
        lib = ctypes.CDLL(_LIB_PATH)
        _bind_symbols(lib)
    except (OSError, AttributeError, RuntimeError) as e:
        native_build.report_unavailable("libqpalm_ldl.so", e)
        return None
    return lib


def _bind_symbols(lib) -> None:
    lib.ldl_symbolic.restype = ctypes.c_void_p
    lib.ldl_symbolic.argtypes = [ctypes.c_int, _IP, _IP]
    lib.ldl_numeric.restype = ctypes.c_int
    lib.ldl_numeric.argtypes = [ctypes.c_void_p, _IP, _IP, _DP,
                                ctypes.c_double, ctypes.c_int]
    lib.ldl_solve.restype = None
    lib.ldl_solve.argtypes = [ctypes.c_void_p, _DP]
    lib.ldl_lnz.restype = ctypes.c_long
    lib.ldl_lnz.argtypes = [ctypes.c_void_p]
    lib.ldl_free.restype = None
    lib.ldl_free.argtypes = [ctypes.c_void_p]
    # supernodal variant (sparse_ldl_sn.cpp) — lower-triangular CSC input
    lib.sldl_symbolic.restype = ctypes.c_void_p
    lib.sldl_symbolic.argtypes = [ctypes.c_int, _IP, _IP, ctypes.c_int,
                                  ctypes.c_double]
    lib.sldl_numeric.restype = ctypes.c_int
    lib.sldl_numeric.argtypes = [ctypes.c_void_p, _IP, _IP, _DP,
                                 ctypes.c_double, ctypes.c_int]
    lib.sldl_solve.restype = None
    lib.sldl_solve.argtypes = [ctypes.c_void_p, _DP]
    lib.sldl_lnz.restype = ctypes.c_long
    lib.sldl_lnz.argtypes = [ctypes.c_void_p]
    lib.sldl_nsuper.restype = ctypes.c_int
    lib.sldl_nsuper.argtypes = [ctypes.c_void_p]
    lib.sldl_free.restype = None
    lib.sldl_free.argtypes = [ctypes.c_void_p]
    lib.amd_order.restype = ctypes.c_int
    lib.amd_order.argtypes = [ctypes.c_int, _IP, _IP, _IP]
    lib.ldl_count_fill.restype = ctypes.c_long
    lib.ldl_count_fill.argtypes = [ctypes.c_int, _IP, _IP]
    # batched symmetric-indefinite KKT solves (polish hot path)
    lib.bkkt_factor_solve.restype = ctypes.c_int
    lib.bkkt_factor_solve.argtypes = [ctypes.c_int, ctypes.c_int, _DP,
                                      _IP, _DP, _IP]
    lib.bkkt_resolve.restype = ctypes.c_int
    lib.bkkt_resolve.argtypes = [ctypes.c_int, ctypes.c_int, _DP, _IP,
                                 _DP, _IP]
    if hasattr(lib, "bkkt_factor_solve_f32"):
        lib.bkkt_factor_solve_f32.restype = ctypes.c_int
        lib.bkkt_factor_solve_f32.argtypes = [
            ctypes.c_int, ctypes.c_int, _DP, _FP, _IP, _DP, _IP]
        lib.bkkt_resolve_f32.restype = ctypes.c_int
        lib.bkkt_resolve_f32.argtypes = [
            ctypes.c_int, ctypes.c_int, _FP, _IP, _DP, _IP]


# mean L-column count above which the supernodal backend's dense BLAS
# panels beat the scalar up-looking loop (measured crossover ~15-30; the
# scalar path wins on banded patterns with short columns)
_SUPERNODAL_MEAN_COLS = 24.0


def estimate_fill(pattern) -> int:
    """Exact LDL' fill (nnz of L below the diagonal) of `pattern` under the
    native AMD ordering (RCM fallback) — the O(nnz + lnz-walk) etree count
    only, no factor allocation.  Used by routing decisions
    (solve_sparse_auto) that don't need the analysis kept around."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native LDL library unavailable")
    M = sp.csc_matrix(pattern)
    n = M.shape[0]
    Ap = np.ascontiguousarray(M.indptr, np.int32)
    Ai = np.ascontiguousarray(M.indices, np.int32)
    perm = np.zeros(n, np.int32)
    if lib.amd_order(n, Ap, Ai, perm) != 0:
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        perm = np.asarray(reverse_cuthill_mckee(M, symmetric_mode=True))
    Mp = sp.csc_matrix(M[perm][:, perm])
    fill = int(lib.ldl_count_fill(
        n, np.ascontiguousarray(Mp.indptr, np.int32),
        np.ascontiguousarray(Mp.indices, np.int32)))
    if fill < 0:
        raise RuntimeError("ldl_count_fill failed")
    return fill


class SparseLDL:
    """Factorization handle over a fixed symmetric sparsity pattern.

    Parameters
    ----------
    pattern : scipy.sparse matrix (square, symmetric); only the structure
        matters here.  `ordering='rcm'` permutes symmetrically with reverse
        Cuthill-McKee to bound fill on banded problems.
    method : 'auto' | 'simplicial' | 'supernodal'.  The simplicial backend
        (native/sparse_ldl.cpp, scalar up-looking) is right for short-column
        banded/structured factors; the supernodal backend
        (native/sparse_ldl_sn.cpp, left-looking with BLAS dgemm panels) wins
        when fill makes the mean L column long.  'auto' runs the cheap
        simplicial symbolic analysis and picks by mean column count.
    ordering : 'auto' | 'amd' | 'rcm' | 'none'.  'amd' is the native
        approximate-minimum-degree (native/amd_order.cpp — the reference's
        LADEL ordering, solver_interface.c:336); 'rcm' scipy reverse
        Cuthill-McKee; 'auto' (default) computes both and keeps whichever
        gives less exact fill (one O(nnz) etree count per candidate).
    """

    def __init__(self, pattern, ordering: str = "auto",
                 method: str = "auto"):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native LDL library unavailable")
        self._lib = lib
        self._h = None
        M = sp.csc_matrix(pattern)
        n = M.shape[0]
        perm = self._pick_ordering(M, ordering)
        self.perm = perm
        self.iperm = np.argsort(perm)
        Mp = M[perm][:, perm]
        U = sp.triu(Mp, format="csc")
        U.sort_indices()
        Up = np.ascontiguousarray(U.indptr, np.int32)
        Ui = np.ascontiguousarray(U.indices, np.int32)
        self.n = n

        if method == "auto":
            h = lib.ldl_symbolic(n, Up, Ui)
            if not h:
                raise RuntimeError("LDL symbolic analysis failed")
            mean_cols = lib.ldl_lnz(h) / max(n, 1)
            if mean_cols >= _SUPERNODAL_MEAN_COLS:
                lib.ldl_free(h)
                method = "supernodal"
            else:
                method = "simplicial"
                self._h = h
        self.method = method

        if method == "supernodal":
            L = sp.tril(Mp, format="csc")
            L.sort_indices()
            self._Tp = np.ascontiguousarray(L.indptr, np.int32)
            self._Ti = np.ascontiguousarray(L.indices, np.int32)
            self._h = lib.sldl_symbolic(n, self._Tp, self._Ti, 48, 0.2)
            if not self._h:
                raise RuntimeError("supernodal symbolic analysis failed")
        else:
            self._Tp, self._Ti = Up, Ui
            if self._h is None:
                self._h = lib.ldl_symbolic(n, Up, Ui)
                if not self._h:
                    raise RuntimeError("LDL symbolic analysis failed")
        # column-major (col, row) keys of the analyzed pattern, globally
        # sorted — lets `factor` scatter a sub-pattern's values with one
        # searchsorted (scipy's sparse addition silently drops zero-valued
        # entries, so a zero-pattern union cannot be used for alignment)
        cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(self._Tp))
        self._keys = cols * np.int64(n) + self._Ti.astype(np.int64)

    def _pick_ordering(self, M, ordering: str) -> np.ndarray:
        n = M.shape[0]
        if ordering == "none":
            return np.arange(n)

        def rcm_perm():
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            return np.asarray(reverse_cuthill_mckee(M, symmetric_mode=True))

        def amd_perm():
            Ap = np.ascontiguousarray(M.indptr, np.int32)
            Ai = np.ascontiguousarray(M.indices, np.int32)
            perm = np.zeros(n, np.int32)
            if self._lib.amd_order(n, Ap, Ai, perm) != 0:
                raise RuntimeError("amd_order failed")
            return perm.astype(np.int64)

        if ordering == "rcm":
            return rcm_perm()
        if ordering == "amd":
            return amd_perm()
        # auto: exact fill of each candidate via the etree count
        candidates = []
        try:
            candidates.append(amd_perm())
        except Exception:
            pass
        candidates.append(rcm_perm())
        if len(candidates) == 1:
            return candidates[0]
        best, best_fill = None, None
        for p in candidates:
            Mp = sp.csc_matrix(M[p][:, p])
            fill = int(self._lib.ldl_count_fill(
                n, np.ascontiguousarray(Mp.indptr, np.int32),
                np.ascontiguousarray(Mp.indices, np.int32)))
            if fill < 0:
                continue  # native count failed: skip this candidate
            if best_fill is None or fill < best_fill:
                best, best_fill = p, fill
        return best if best is not None else candidates[-1]

    @property
    def lnz(self) -> int:
        if self.method == "supernodal":
            return int(self._lib.sldl_lnz(self._h))
        return int(self._lib.ldl_lnz(self._h))

    @property
    def nsuper(self) -> int:
        """Number of supernodes (supernodal method only)."""
        if self.method != "supernodal":
            return self.n
        return int(self._lib.sldl_nsuper(self._h))

    def _aligned_values(self, M) -> np.ndarray:
        """Permute + take this method's triangle of M and align its values
        to the analyzed pattern (which may be a structural superset).

        The P-ALM loop refactors the same superset pattern with new values
        every few iterations, and the scipy permute/triangle work dominated
        profile time — so the data mapping (which entry of M.data lands in
        which superset slot) is computed once per distinct input pattern
        with an index tracer and replayed as two fancy-indexing ops."""
        M = sp.csc_matrix(M)
        key = (M.shape, M.nnz, M.indptr.tobytes(), M.indices.tobytes())
        cached = getattr(self, "_align_cache", None)
        if cached is not None and cached[0] == key:
            _, pos, src, nvals = cached
            vals = np.zeros(nvals, np.float64)
            vals[pos] = M.data[src]
            return vals
        # slow path: run the permutation/triangle once with tracer data
        # 1..nnz so the surviving entries reveal their source positions
        tracer = sp.csc_matrix(
            (np.arange(1, M.nnz + 1, dtype=np.float64), M.indices.copy(),
             M.indptr.copy()), shape=M.shape,
        )
        Tp = tracer[self.perm][:, self.perm]
        tri = sp.tril if self.method == "supernodal" else sp.triu
        T = tri(Tp, format="csc")
        T.sort_indices()
        T.eliminate_zeros()  # tracer values are >= 1, zeros are structural
        src = T.data.astype(np.int64) - 1
        # scatter positions into the superset pattern via sorted keys
        cols = np.repeat(np.arange(self.n, dtype=np.int64),
                         np.diff(T.indptr))
        sub_keys = cols * np.int64(self.n) + T.indices.astype(np.int64)
        pos = np.searchsorted(self._keys, sub_keys)
        if (pos >= len(self._keys)).any() or not np.array_equal(
                self._keys[np.minimum(pos, len(self._keys) - 1)],
                sub_keys):
            raise ValueError("pattern not contained in analyzed pattern")
        nvals = len(self._keys)
        self._align_cache = (key, pos, src, nvals)
        vals = np.zeros(nvals, np.float64)
        vals[pos] = M.data[src]
        return vals

    def factor(self, M, shift: float = 0.0,
               shift_size: Optional[int] = None) -> None:
        """Numeric (re)factorization of M (+ shift on the first
        `shift_size` diagonal entries of the ORIGINAL indexing; default
        the whole diagonal — LADEL diag_size semantics,
        solver_interface.c:330-343).  M must have a sparsity pattern
        contained in the analyzed one."""
        vals = self._aligned_values(M)
        if (shift != 0.0 and shift_size is not None
                and shift_size < self.n):
            # the fill-reducing permutation scatters original indices, so
            # a partial shift is folded into the aligned values at the
            # matching diagonal slots (cached 0/1 mask)
            vals = vals + shift * self._diag_shift_mask(shift_size)
            shift = 0.0
        fn = (self._lib.sldl_numeric if self.method == "supernodal"
              else self._lib.ldl_numeric)
        status = fn(self._h, self._Tp, self._Ti, vals, float(shift),
                    self.n)
        if status < 0:
            # native exception (e.g. allocation failure), not a zero pivot
            raise RuntimeError("native LDL numeric factorization failed")
        if status != 0:
            raise np.linalg.LinAlgError(
                f"LDL numeric breakdown at column {status - 1}"
            )

    def _diag_shift_mask(self, shift_size: int) -> np.ndarray:
        """0/1 vector over the analyzed value slots marking diagonal
        entries whose ORIGINAL index is < shift_size (cached).  Requires
        those diagonal slots to exist in the analyzed pattern."""
        cached = getattr(self, "_diag_mask_cache", None)
        if cached is not None and cached[0] == shift_size:
            return cached[1]
        jj = np.where(self.perm < shift_size)[0].astype(np.int64)
        keys = jj * np.int64(self.n) + jj  # diagonal keys, permuted frame
        pos = np.searchsorted(self._keys, keys)
        ok = (pos < len(self._keys)) & (
            self._keys[np.minimum(pos, len(self._keys) - 1)] == keys)
        if not ok.all():
            raise ValueError("partial shift requires the shifted diagonal "
                             "entries in the analyzed pattern")
        mask = np.zeros(len(self._keys), np.float64)
        mask[pos] = 1.0
        self._diag_mask_cache = (shift_size, mask)
        return mask

    def solve(self, b) -> np.ndarray:
        x = np.ascontiguousarray(np.asarray(b, np.float64)[self.perm])
        if self.method == "supernodal":
            self._lib.sldl_solve(self._h, x)
        else:
            self._lib.ldl_solve(self._h, x)
        return x[self.iperm]

    def __del__(self):
        if getattr(self, "_h", None) and getattr(self, "_lib", None):
            if self.method == "supernodal":
                self._lib.sldl_free(self._h)
            else:
                self._lib.ldl_free(self._h)
            self._h = None
