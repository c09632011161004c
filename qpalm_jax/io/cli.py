"""Command-line QPS driver.

Equivalent of the reference `qpalm_qps` executable (reference:
interfaces/qps/src/qpalm_qps.c:694-806):

    python -m qpalm_jax.io.cli problem.qps [settings.txt]
    python -m qpalm_jax.io.cli --mtx A.mtx Q.mtx q.mtx bmin.mtx bmax.mtx

Prints the problem name, iterations, status, objective and runtime.

The solve runs on JAX's default backend (the GPU where there is one);
`--platform cpu` keeps it on the host, `--platform gpu` requires the GPU.
Batched float32 sweeps should use qpalm_jax.batch directly.
"""

from __future__ import annotations

import sys

PLATFORMS = ("cpu", "gpu")
USAGE = (
    "Usage: python -m qpalm_jax.io.cli [--platform cpu|gpu] problem.qps "
    "[settings.txt]\n"
    "       python -m qpalm_jax.io.cli [--platform cpu|gpu] --mtx A Q q bmin "
    "bmax [settings.txt]"
)


def parse_platform(argv):
    """Split `--platform cpu|gpu` off `argv`: (platform or None, rest).
    None means JAX's default backend.  Raises ValueError on a bad value."""
    argv = list(argv)
    if "--platform" not in argv:
        return None, argv
    i = argv.index("--platform")
    if i + 1 >= len(argv) or argv[i + 1] not in PLATFORMS:
        raise ValueError(f"--platform takes one of {', '.join(PLATFORMS)}")
    platform = argv[i + 1]
    del argv[i : i + 2]
    return platform, argv


def use_platform(platform) -> None:
    """Restrict JAX to `platform` ("cpu" or "gpu"; None keeps JAX's
    default backend) and turn on the persistent compilation cache."""
    import jax

    from ..compile_cache import enable_compile_cache

    if platform is not None:
        jax.config.update("jax_platforms",
                          "cuda" if platform == "gpu" else platform)
    enable_compile_cache()


def main(argv=None) -> int:
    try:
        platform, argv = parse_platform(
            sys.argv[1:] if argv is None else argv)
    except ValueError as e:
        print(f"{e}\n{USAGE}", file=sys.stderr)
        return 1
    if not argv:
        print(USAGE, file=sys.stderr)
        return 1
    use_platform(platform)

    from .mtx import load_mtx
    from .qps import load_qps
    from .settings_io import read_settings_file

    settings_path = None
    if argv[0] == "--mtx":
        if len(argv) < 6:
            print("--mtx needs 5 files: A Q q bmin bmax", file=sys.stderr)
            return 1
        prob = load_mtx(*argv[1:6])
        if len(argv) > 6:
            settings_path = argv[6]
    else:
        prob = load_qps(argv[0])
        if len(argv) > 1:
            settings_path = argv[1]
    print(f"Reading problem {prob.name or argv[0]}")
    print(f"n = {prob.n}, m = {prob.m}")

    from ..api import solve
    from ..types import Settings

    settings = Settings()
    if settings_path is not None:
        settings = read_settings_file(settings_path, settings)

    res = solve(
        prob.Q, prob.A, prob.q, prob.bmin, prob.bmax, c=prob.c,
        settings=settings,
    )
    print(f"Iter: {int(res.info.iter)}")
    print(f"Status: {res.info.status}")
    print(f"Objective: {float(res.info.objective):.6e}")
    print(f"Runtime: {res.info.run_time:.6f} seconds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
