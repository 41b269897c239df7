"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR wins when set;
otherwise the package puts the cache at ``<repo>/.jax_cache``.  Each case
imports the package in a fresh process."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = (
    "import jax, pygradflow_tpu\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
)


def _cache_dir(env):
    proc = subprocess.run(
        [sys.executable, "-c", PROBE],
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
        cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout.strip().splitlines()[-1]


def test_default_cache_dir_in_checkout():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    assert _cache_dir(env) == os.path.join(REPO, ".jax_cache")


def test_env_cache_dir_honoured(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert _cache_dir(env) == str(tmp_path)
