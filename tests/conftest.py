"""Test configuration: run on the CPU with 8 virtual devices, so the
multi-device sharding paths are exercised without a GPU.  Tests that need
the card carry the `gpu` marker and run it from a child process (see
test_chip_smoke.py), so this process never opens the card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from qpalm_jax.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
