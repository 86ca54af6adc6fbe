"""The persistent compile cache lands where the helper says."""

import os
import pathlib
import subprocess
import sys

from tpu_slam.utils import compile_cache

_REPO = pathlib.Path(__file__).resolve().parent.parent
_PROBE = (
    "import jax, jax.numpy as jnp;"
    "from tpu_slam.utils.compile_cache import enable_compile_cache;"
    "print(enable_compile_cache());"
    "jax.jit(lambda x: jnp.sin(x) @ x.T)(jnp.ones((64, 64)))"
    ".block_until_ready()"
)


def _run(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0",
               PYTHONPATH=str(_REPO))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return out.stdout.strip().splitlines()[-1]


def test_cache_goes_to_the_variable_when_set(tmp_path):
    target = tmp_path / "xla_cache"
    assert _run(target) == str(target)
    assert any(target.iterdir())


def test_cache_defaults_to_repo_dot_jax_cache(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    default = _REPO / ".jax_cache"
    assert compile_cache.DEFAULT_DIR == default
    assert _run(None) == str(default)
    assert any(default.iterdir())
    ignored = (_REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
