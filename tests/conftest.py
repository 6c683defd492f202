import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

# `benchmarks` is a plain directory (run via `python -m benchmarks.run`);
# make it importable for tests that exercise the bench harness even when
# pytest was not launched from the repo root.
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def run_subprocess(code: str, devices: int = 8, timeout: int = 900):
    """Run a python snippet in a fresh process with N fake XLA devices.

    Used by tests that need a multi-device mesh (the main process keeps the
    default single CPU device so ordinary tests stay fast).
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=timeout)
    if res.returncode != 0:
        raise AssertionError(
            f"subprocess failed (rc={res.returncode})\n--- stdout ---\n"
            f"{res.stdout[-4000:]}\n--- stderr ---\n{res.stderr[-4000:]}")
    return res.stdout


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips (from a fixture) "
        "where none is present")


@pytest.fixture
def subproc():
    return run_subprocess


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled XLA executables after each test module.

    Every jitted executable holds mmapped JIT code pages; across the full
    suite the process accumulates ~60k anonymous maps and crosses the
    kernel's vm.max_map_count (65530 by default), at which point the next
    backend_compile segfaults. Clearing per module keeps the peak bounded
    by the hungriest single module instead of the suite-wide sum.
    """
    yield
    import gc

    import jax

    jax.clear_caches()
    gc.collect()
