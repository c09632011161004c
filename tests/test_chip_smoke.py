"""chip_smoke.py and bench.py on the CPU: each smoke phase at a tiny size,
the multi-device phases on virtual devices, the no-GPU failure paths, the
bench's peak table and lockstep accounting, the compile-cache rule and the
CLI's --platform parsing.  `test_chip_smoke_on_gpu` runs the real smoke
on the card (marker `gpu`; it skips where there is none)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from qpalm_jax import certify, compile_cache  # noqa: E402
from qpalm_jax.io import cli  # noqa: E402

TINY_PHASES = {
    "cholesky": lambda: chip_smoke.phase_cholesky(B=8, n=16, n_big=48),
    "fleet": lambda: chip_smoke.phase_fleet(B=16, n=12, m=18, n_ref=4),
    "scenario": lambda: chip_smoke.phase_scenario(B=64, n=8, m=12,
                                                  n_check=8),
    "large": lambda: chip_smoke.phase_large(n=48),
    "api": lambda: chip_smoke.phase_api(n=16, m=24),
    "cli": lambda: chip_smoke.phase_cli(),
    "dp": lambda: chip_smoke.phase_dp(4, B_per=8, n=8, m=12),
    "con": lambda: chip_smoke.phase_constraint_sharded(4, n=32, m=30),
    "stage": lambda: chip_smoke.phase_stage_sharded(4, horizon=8),
}


@pytest.mark.parametrize("phase", sorted(TINY_PHASES))
def test_smoke_phase_tiny(phase):
    out = TINY_PHASES[phase]()
    json.dumps(out, default=str)  # printable as the phase's result line
    if phase in ("dp", "con", "stage"):
        assert out["devices"] == 4
    if phase == "fleet":
        assert out["certified"] == out["batch"] == 16
        assert out["referee_agree"] == out["referee_checked"]
        assert out["lockstep_lane_iters"] == 16 * out["max_iters"]


def test_smoke_check_raises():
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check(False, "boom")


def test_smoke_main_fails_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_bench_fails_without_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        certify.require_gpu()
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.main()


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3", "NVIDIA A100-SXM4-80GB"])
def test_bench_peak_lookup(kind):
    if kind in bench.PEAKS:
        peak = bench.peak_for(kind)
        assert peak["fp32_flops_per_s"] == 67e12
        assert peak["hbm_bytes_per_s"] == 3.35e12
    else:
        with pytest.raises(KeyError, match="no published peak"):
            bench.peak_for(kind)


def test_lockstep_accounting():
    # the vmapped loop runs every lane until the slowest finishes
    assert certify.lockstep_iters(np.array([3, 9, 4, 1])) == 4 * 9
    assert certify.lockstep_iters(np.zeros(0, np.int32)) == 0
    n, m = 64, 96
    assert bench.flops_per_lockstep_iter(n, m) == pytest.approx(
        2 * n * n * m + n ** 3 / 3 + 5 * n * n + 4 * n * m)


def test_compile_cache_respects_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # set nothing


def test_compile_cache_default_in_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        d = compile_cache.enable_compile_cache()
        assert d == compile_cache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == d
        assert os.path.dirname(d) == ROOT
        with open(os.path.join(ROOT, ".gitignore")) as f:
            assert os.path.basename(d) + "/" in f.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("argv,platform,rest", [
    (["p.qps"], None, ["p.qps"]),
    (["--platform", "cpu", "p.qps"], "cpu", ["p.qps"]),
    (["p.qps", "--platform", "gpu", "s.txt"], "gpu", ["p.qps", "s.txt"]),
])
def test_cli_platform_parsing(argv, platform, rest):
    assert cli.parse_platform(argv) == (platform, rest)


@pytest.mark.parametrize("argv", [["--platform", "rocm", "p.qps"],
                                  ["p.qps", "--platform"]])
def test_cli_platform_rejects(argv, capsys):
    with pytest.raises(ValueError):
        cli.parse_platform(argv)
    assert cli.main(argv) == 1
    assert "--platform" in capsys.readouterr().err


@pytest.fixture
def gpu_card():
    """Skip unless nvidia-smi lists a card (decided here, at run time)."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run(
            [smi, "-L"], capture_output=True).returncode != 0:
        pytest.skip("no NVIDIA GPU on this machine")


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_card):
    """The full one-card smoke, in a child process: this test process
    stays on the CPU, so the child is the only process on the card."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
