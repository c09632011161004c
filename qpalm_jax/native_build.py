"""Build the native helper libraries (`native/*.so`) from the committed
sources.

The libraries are built on first use into the gitignored `native/`
outputs.  BLAS/LAPACK come from the scipy wheel's OpenBLAS (see
`native/Makefile`), so the build needs only a C++ compiler and the Python
packages.  A failed build raises with the compiler's own message: callers
that can run without a library report that message rather than drop it.
"""

from __future__ import annotations

import os
import subprocess
import sys
import warnings

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)


def lib_path(name: str) -> str:
    return os.path.join(NATIVE_DIR, name)


def build(force: bool = False) -> None:
    """Run `make -C native` with this interpreter's scipy; raise
    RuntimeError with the tail of make's output if it fails."""
    cmd = ["make", "-C", NATIVE_DIR, "-s", f"PYTHON={sys.executable}"]
    if force:
        cmd.append("-B")
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native build failed: {e}") from e
    if p.returncode != 0:
        tail = "\n".join((p.stdout + p.stderr).strip().splitlines()[-12:])
        raise RuntimeError(f"native build failed (make rc={p.returncode}):\n"
                           f"{tail}")


def report_unavailable(name: str, err: BaseException) -> None:
    """Warn that an optional native library could not be built or loaded."""
    warnings.warn(f"native library {name} unavailable: {err}",
                  RuntimeWarning, stacklevel=3)
