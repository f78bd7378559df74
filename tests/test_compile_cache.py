"""The entry points' persistent compile cache: JAX_COMPILATION_CACHE_DIR
when set (and then no directory is set in code), else a fixed directory
inside the checkout. Each case runs in a fresh interpreter, since JAX
reads the variable once at import."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(tmp_path, env_set):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    code = ("import jax\n"
            "from mitsuba_jax.utils.compile_cache import enable_compile_cache\n"
            "print(enable_compile_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    returned, configured = out.stdout.split()[-2:]
    want = str(tmp_path / "cache") if env_set else os.path.join(
        REPO, ".jax_cache")
    assert returned == configured == want
