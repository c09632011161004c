"""QPS/MTX/settings-file drivers (reference: interfaces/qps, interfaces/mtx)."""

import os
import textwrap

import numpy as np
import pytest

import qpalm_jax
from qpalm_jax import Settings
from qpalm_jax.io import load_mtx, load_qps, read_settings_file
from qpalm_jax.io.cli import main as cli_main


QPS_TEXT = textwrap.dedent("""\
    NAME          TESTQP
    ROWS
     N  obj
     L  c1
     G  c2
     E  c3
    COLUMNS
        x1  obj  1.0  c1  1.0
        x1  c2  1.0
        x1  c3  1.0
        x2  obj  2.0  c1  2.0
        x2  c2  -1.0
    RHS
        rhs  c1  4.0  c2  -1.0
        rhs  c3  1.5
        rhs  obj  -0.5
    RANGES
        rng  c1  2.0
    BOUNDS
     UP bnd  x1  3.0
     FR bnd  x2
    QUADOBJ
        x1  x1  2.0
        x1  x2  0.5
        x2  x2  2.0
    ENDATA
    """)


@pytest.fixture
def qps_file(tmp_path):
    p = tmp_path / "test.qps"
    p.write_text(QPS_TEXT)
    return str(p)


def test_qps_parse(qps_file):
    p = load_qps(qps_file)
    assert p.name == "TESTQP"
    assert (p.n, p.m) == (2, 4)
    np.testing.assert_allclose(p.Q.toarray(), [[2, 0.5], [0.5, 2]])
    np.testing.assert_allclose(p.q, [1, 2])
    assert p.c == 0.5
    # rows: c1 (L, ranged), c2 (G), c3 (E), then the x1 bound row (x2 is FR)
    np.testing.assert_allclose(p.A.toarray(), [[1, 2], [1, -1], [1, 0], [1, 0]])
    np.testing.assert_allclose(p.bmin, [2, -1, 1.5, 0])
    np.testing.assert_allclose(p.bmax, [4, 1e20, 1.5, 3])


def test_qps_solve_kkt(qps_file):
    p = load_qps(qps_file)
    res = qpalm_jax.solve(
        p.Q, p.A, p.q, p.bmin, p.bmax, c=p.c,
        settings=Settings(eps_abs=1e-6, eps_rel=1e-6),
    )
    assert res.info.status == "solved"
    from helpers import kkt_check

    kkt_check(
        p.Q.toarray(), p.A.toarray(), p.q, p.bmin, p.bmax,
        res.solution.x, res.solution.y, tol=1e-5,
    )


def test_qps_unnamed_rhs_and_bounds(tmp_path):
    text = textwrap.dedent("""\
        NAME UN
        ROWS
         N  obj
         G  r1
        COLUMNS
            x1  obj  -1.0  r1  1.0
        RHS
            r1  0.5
        BOUNDS
         UP  x1  2.0
        ENDATA
        """)
    p = tmp_path / "u.qps"
    p.write_text(text)
    prob = load_qps(str(p))
    assert (prob.n, prob.m) == (1, 2)
    np.testing.assert_allclose(prob.bmin, [0.5, 0.0])
    np.testing.assert_allclose(prob.bmax, [1e20, 2.0])


def test_qps_free_rows_unnamed_ranges_fr_rebound(tmp_path):
    """Review regressions: (a) a second N row is a standard MPS free row —
    its COLUMNS/RHS entries must be ignored, not KeyError; (b) RANGES
    auto-detects the unnamed format like RHS; (c) FR followed by a
    tightening bound keeps the variable bounded."""
    text = textwrap.dedent("""\
        NAME FRN
        ROWS
         N  obj
         N  freer
         L  r1
        COLUMNS
            x1  obj  1.0  freer  9.0
            x1  r1  1.0
            x2  obj  1.0  r1  1.0
        RHS
            r1  4.0
            freer  7.0
        RANGES
            r1  1.5
        BOUNDS
         FR  x1
         UP  x1  2.0
         FR  x2
        ENDATA
        """)
    p = tmp_path / "f.qps"
    p.write_text(text)
    prob = load_qps(str(p))
    # rows: r1 + one bound row for x1 (x2 stays free, no row)
    assert (prob.n, prob.m) == (2, 2)
    # RANGES on an L row: bmin = bmax - |val|
    np.testing.assert_allclose(prob.bmin[0], 4.0 - 1.5)
    np.testing.assert_allclose(prob.bmax[0], 4.0)
    # x1: FR then UP 2.0 -> (-inf, 2.0]
    np.testing.assert_allclose(prob.bmin[1], -1e20)
    np.testing.assert_allclose(prob.bmax[1], 2.0)


def test_mtx_general_banner_and_comments(tmp_path):
    """Review regressions: a `general` banner file storing both triangles
    must NOT be mirrored (scipy sums duplicates, doubling off-diagonals),
    and standard '%' comment lines must be skipped."""
    from qpalm_jax.io.mtx import _load_mtx_matrix, _load_mtx_vector

    p = tmp_path / "q.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate real general\n"
        "% exported with full storage\n"
        "2 2 4\n"
        "1 1 2.0\n"
        "1 2 0.5\n"
        "2 1 0.5\n"
        "% a mid-file comment\n"
        "2 2 3.0\n"
    )
    M = _load_mtx_matrix(str(p), symmetric_default=True).toarray()
    np.testing.assert_allclose(M, [[2.0, 0.5], [0.5, 3.0]])
    # symmetric banner: one-triangle storage mirrored
    p2 = tmp_path / "qs.mtx"
    p2.write_text(
        "%%MatrixMarket matrix coordinate real symmetric\n"
        "2 2 3\n"
        "1 1 2.0\n"
        "2 1 0.5\n"
        "2 2 3.0\n"
    )
    M2 = _load_mtx_matrix(str(p2)).toarray()
    np.testing.assert_allclose(M2, [[2.0, 0.5], [0.5, 3.0]])
    pv = tmp_path / "v.mtx"
    pv.write_text("%%MatrixMarket\n% comment\n2 1\n1.0\n-2.0\n")
    np.testing.assert_allclose(_load_mtx_vector(str(pv)), [1.0, -2.0])


def test_settings_file(tmp_path):
    p = tmp_path / "settings.txt"
    p.write_text(
        "h1\nh2\nh3\nh4\nh5\n"
        "eps_abs 1e-6\neps_rel 1e-6\nmax_iter 50000\nverbose 1\n"
        "time_limit 3600\n"
    )
    s = read_settings_file(str(p))
    assert s.eps_abs == 1e-6 and s.max_iter == 50000
    assert s.verbose is True and s.time_limit == 3600.0
    with pytest.raises(ValueError):
        p2 = tmp_path / "bad.txt"
        p2.write_text("h\nh\nh\nh\nh\nnot_a_setting 1\n")
        read_settings_file(str(p2))


def test_mtx_roundtrip(tmp_path):
    # A 2x2 QP in the reference's five-file mtx format (qpalm_mtx.c:12-130)
    (tmp_path / "A.mtx").write_text(
        "%%MatrixMarket matrix coordinate real general\n3 2 4\n"
        "1 1 1.0\n2 1 1.0\n1 2 1.0\n3 2 1.0\n"
    )
    (tmp_path / "Q.mtx").write_text(
        "%%MatrixMarket matrix coordinate real symmetric\n2 2 2\n"
        "1 1 2.0\n2 2 2.0\n"
    )
    (tmp_path / "q.mtx").write_text("%%vector\n2\n-2.0\n-6.0\n")
    (tmp_path / "bmin.mtx").write_text("%%vector\n3\n-1e30\n-1e30\n-1e30\n")
    (tmp_path / "bmax.mtx").write_text("%%vector\n3\n2.0\n2.0\n3.0\n")
    prob = load_mtx(
        str(tmp_path / "A.mtx"), str(tmp_path / "Q.mtx"),
        str(tmp_path / "q.mtx"), str(tmp_path / "bmin.mtx"),
        str(tmp_path / "bmax.mtx"),
    )
    assert (prob.n, prob.m) == (2, 3)
    assert prob.bmin[0] == -1e20  # clipped to QPALM infinity
    res = qpalm_jax.solve(
        prob.Q, prob.A, prob.q, prob.bmin, prob.bmax,
        settings=Settings(eps_abs=1e-6, eps_rel=1e-6),
    )
    assert res.info.status == "solved"


def _fields(*pairs):
    line = ""
    for col, text in pairs:
        line = line.ljust(col) + text
    return line


def test_old_fixed_column_format(tmp_path):
    """Old fixed-column MPS with spaces inside names auto-converts
    (reference: qps_conversion.c:37-160 — spaces in name fields removed)."""
    L = [
        "NAME          OLDQP",
        "ROWS",
        _fields((1, "N"), (4, "COST")),
        _fields((1, "L"), (4, "LIM 1")),
        _fields((1, "G"), (4, "LIM2")),
        "COLUMNS",
        _fields((4, "X 1"), (14, "COST"), (24, "1.0"), (39, "LIM 1"), (49, "2.0")),
        _fields((4, "X 1"), (14, "LIM2"), (24, "1.0")),
        _fields((4, "X2"), (14, "COST"), (24, "2.0"), (39, "LIM 1"), (49, "1.0")),
        "RHS",
        _fields((4, "RHS"), (14, "LIM 1"), (24, "4.0"), (39, "LIM2"), (49, "1.0")),
        "BOUNDS",
        _fields((1, "UP"), (4, "BND"), (14, "X 1"), (24, "4.0")),
        "QUADOBJ",
        _fields((4, "X 1"), (14, "X 1"), (24, "2.0")),
        _fields((4, "X2"), (14, "X2"), (24, "2.0")),
        "ENDATA",
    ]
    p = tmp_path / "old.qps"
    p.write_text("\n".join(L) + "\n")
    prob = load_qps(str(p))
    assert (prob.n, prob.m) == (2, 4)
    np.testing.assert_allclose(prob.A.toarray(), [[2, 1], [1, 0], [1, 0], [0, 1]])
    np.testing.assert_allclose(prob.Q.toarray(), [[2, 0], [0, 2]])
    np.testing.assert_allclose(prob.bmax, [4, 1e20, 4, 1e20])


def test_native_parser_matches_python(qps_file):
    from qpalm_jax.io.native import load_library
    from qpalm_jax.io.qps import load_qps_python

    if load_library() is None:
        pytest.skip("native QPS reader unavailable")
    pn = load_qps(qps_file, native=True)
    pp = load_qps_python(qps_file)
    assert (pn.name, pn.n, pn.m, pn.c) == (pp.name, pp.n, pp.m, pp.c)
    np.testing.assert_array_equal(pn.Q.toarray(), pp.Q.toarray())
    np.testing.assert_array_equal(pn.A.toarray(), pp.A.toarray())
    np.testing.assert_array_equal(pn.q, pp.q)
    np.testing.assert_array_equal(pn.bmin, pp.bmin)
    np.testing.assert_array_equal(pn.bmax, pp.bmax)


def test_native_parser_error(tmp_path):
    from qpalm_jax.io.native import load_library

    if load_library() is None:
        pytest.skip("native QPS reader unavailable")
    p = tmp_path / "bad.qps"
    p.write_text("NAME X\nROWS\n N obj extra_token_oldformat\nENDATA\n")
    with pytest.raises(ValueError):
        load_qps(str(p), native=True)


def test_mini_suite_harness():
    """The committed MM-protocol mini suite solves end-to-end through the
    parse -> bucket -> batch pipeline (subset for test speed)."""
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    suite = os.path.join(root, "benchmarks", "qps_mini")
    if not os.path.isdir(suite):
        pytest.skip("mini suite not generated")
    sys.path.insert(0, os.path.join(root, "scripts"))
    from run_qps_suite import main as suite_main

    import tempfile, json
    out = os.path.join(tempfile.mkdtemp(), "res.json")
    rc = suite_main([suite, "--eps", "1e-6", "--max-n", "60",
                     "--json", out])
    assert rc == 0
    with open(out) as f:
        res = json.load(f)
    assert all(r["status"] == 1 for r in res["results"])


def test_cli(qps_file, capsys):
    rc = cli_main([qps_file])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Status: solved" in out
    assert "TESTQP" in out


def test_hard_suite_parses_and_stress_problems_solve():
    """The committed hard suite (benchmarks/qps_hard): every file parses,
    the old fixed-column files convert, and a stress instance from each
    class solves / certifies correctly."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    suite = os.path.join(root, "benchmarks", "qps_hard")
    if not os.path.isdir(suite):
        pytest.skip("hard suite not generated")
    files = sorted(f for f in os.listdir(suite) if f.endswith(".qps"))
    assert len(files) >= 30
    probs = {}
    for f in files:
        p = load_qps(os.path.join(suite, f))
        probs[f[:-4]] = p
    # old-format conversion produced the right tiny QPs
    assert probs["OLDFMT0"].n == 2 and probs["OLDFMT0"].m == 1
    np.testing.assert_allclose(probs["OLDFMT1"].q, [-1.0, -1.0])

    s = Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False)
    p = probs["ILLCOND0"]  # cond(Q) = 1e8
    r = qpalm_jax.solve(p.Q, p.A, p.q, p.bmin, p.bmax, settings=s)
    assert r.info.status == "solved"
    p = probs["PINF0"]
    r = qpalm_jax.solve(p.Q, p.A, p.q, p.bmin, p.bmax, settings=s)
    assert r.info.status == "primal infeasible"
    p = probs["DINF0"]
    r = qpalm_jax.solve(p.Q, p.A, p.q, p.bmin, p.bmax, settings=s)
    assert r.info.status == "dual infeasible"


def test_save_qps_variable_bounds_roundtrip(tmp_path):
    """save_qps with lvar/uvar emits LO/UP/FX/FR/MI BOUNDS entries; the
    parsers fold them back into appended identity rows of A (the reference
    convention, qpalm_qps.c:145-148).  Sparse inputs must not densify."""
    import scipy.sparse as sp
    from qpalm_jax.io.qps import load_qps_python, save_qps

    rng = np.random.default_rng(0)
    n, m = 6, 3
    Q = sp.random(n, n, density=0.4, random_state=rng, format="csc")
    Q = (Q + Q.T + n * sp.eye(n)).tocsc()
    A = sp.random(m, n, density=0.5, random_state=rng, format="csc")
    A[0, 0] = 1.5  # ensure at least one entry
    q = rng.standard_normal(n)
    bmin = np.array([-1.0, -np.inf, 2.0])
    bmax = np.array([1.0, 3.0, 2.0])
    # one of each bound class: FR, FX, MI+UP, LO+UP, UP-only (lo=0), LO-only
    lvar = np.array([-np.inf, 2.5, -np.inf, -1.0, 0.0, 0.5])
    uvar = np.array([np.inf, 2.5, 4.0, 1.0, 2.0, np.inf])
    path = str(tmp_path / "rt.qps")
    save_qps(path, Q, A, q, bmin, bmax, c=0.25, name="RT", lvar=lvar,
             uvar=uvar)
    for prob in (load_qps_python(path), load_qps(path, native=True)):
        nb = int(np.sum(~(np.isinf(lvar) & np.isinf(uvar))))  # non-FR vars
        assert (prob.n, prob.m) == (n, m + nb)
        np.testing.assert_allclose(prob.Q.toarray(), Q.toarray(),
                                   atol=1e-14)
        np.testing.assert_allclose(prob.A.toarray()[:m], A.toarray(),
                                   atol=1e-14)
        np.testing.assert_allclose(prob.q, q, atol=1e-14)
        assert prob.c == 0.25
        lo = np.clip(bmin, -1e20, 1e20)
        np.testing.assert_allclose(prob.bmin[:m], lo, atol=1e-14)
        np.testing.assert_allclose(prob.bmax[:m], np.clip(bmax, -1e20, 1e20),
                                   atol=1e-14)
        # bound rows: one identity row per non-FR variable, in column order
        bnd = prob.A.toarray()[m:]
        cols = [int(np.flatnonzero(r)[0]) for r in bnd]
        assert cols == [1, 2, 3, 4, 5]
        exp_lo = np.clip(lvar[cols], -1e20, 1e20)
        exp_hi = np.clip(uvar[cols], -1e20, 1e20)
        np.testing.assert_allclose(prob.bmin[m:], exp_lo)
        np.testing.assert_allclose(prob.bmax[m:], exp_hi)
