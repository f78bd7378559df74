"""Test config: force CPU backend with 8 virtual devices.

Multi-device sharding paths are validated on a virtual device mesh;
renders in tests are small enough for CPU. Tests marked `gpu` need a card:
they run their GPU work in a child process (this one stays on the CPU) and
skip where nvidia-smi finds none.
A pytest plugin may import jax before this conftest runs, so we use
jax.config.update (effective until backend initialization) rather than env
vars alone.
"""
import os

os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

assert jax.device_count() == 8, (
    "expected 8 virtual CPU devices; jax backend was initialized before "
    "conftest could reconfigure it"
)


import pytest  # noqa: E402

_SLOW_LIST = os.path.join(os.path.dirname(__file__), "slow_tests.txt")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: test measured >=5s on the CPU backend; excluded "
        "from the fast lane (pytest -m 'not slow', <6 min)")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one); run on "
        "the card with pytest tests/ -m gpu")


def pytest_collection_modifyitems(config, items):
    """Mark tests listed in slow_tests.txt (measured >=5 s) as slow.

    The list holds parametrization-stripped node ids; regenerate with
      pytest tests/ -q --durations=0 | awk '$1+0>=5{print $3}' \\
        | sed 's/\\[.*//' | sort -u > tests/slow_tests.txt
    Fast lane:  python -m pytest tests/ -m "not slow" -q   (~5 min)
    Full suite: python -m pytest tests/ -q                 (~33 min)
    """
    try:
        with open(_SLOW_LIST) as f:
            slow = {ln.strip() for ln in f if ln.strip()}
    except OSError:
        return
    for item in items:
        base = item.nodeid.split("[")[0]
        if base in slow:
            item.add_marker(pytest.mark.slow)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables after each test module.

    Round-2 finding: a single-process run of the whole suite segfaulted
    inside XLA CPU compilation (jax/_src/compiler.py backend_compile_and_
    load) after ~150 jit programs — compiler memory growth across
    hundreds of live executables. Bounding the live-cache to one module
    keeps the process healthy; within-module caching (the hot path for
    parametrized tests) is unaffected.
    """
    yield
    import jax as _jax

    _jax.clear_caches()


@pytest.fixture
def gpu():
    """Skip unless an NVIDIA GPU is present (asked of nvidia-smi, so this
    process never opens the card)."""
    import shutil
    import subprocess

    smi = shutil.which("nvidia-smi")
    found = smi is not None and subprocess.run(
        [smi, "-L"], capture_output=True, timeout=60).returncode == 0
    if not found:
        pytest.skip("no NVIDIA GPU (nvidia-smi finds none)")
