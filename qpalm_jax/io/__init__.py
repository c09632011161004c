"""File-format drivers: QPS/MPS reader, MTX reader, settings files, CLI.

Equivalents of the reference's C drivers
(reference: interfaces/qps/src/qpalm_qps.c, interfaces/mtx/qpalm_mtx.c).
"""

from .qps import QPProblem, load_qps
from .mtx import load_mtx
from .settings_io import read_settings_file

__all__ = ["QPProblem", "load_qps", "load_mtx", "read_settings_file"]
