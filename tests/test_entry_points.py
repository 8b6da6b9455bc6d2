"""Where the compile cache lives, and the GPU entry points refusing to run
without a GPU (they must fail, and print no result, rather than measure or
check anything on the CPU)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from rtvqa_tpu.obs import jaxcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jaxcache.REPO_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert jaxcache.cache_dir() == jaxcache.REPO_CACHE_DIR
    assert jaxcache.enable_persistent_cache() == jaxcache.REPO_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == jaxcache.REPO_CACHE_DIR
    assert os.path.isdir(jaxcache.REPO_CACHE_DIR)


def test_cache_dir_follows_the_environment(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own reading of it stands:
    the program sets no other directory and creates nothing in the
    checkout."""
    code = (
        "import jax, json; from rtvqa_tpu.obs import jaxcache; "
        "print(json.dumps([jaxcache.enable_persistent_cache(), "
        "jax.config.jax_compilation_cache_dir]))"
    )
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc"),
               PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                         capture_output=True, text=True, check=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [str(tmp_path / "cc")] * 2


@pytest.mark.parametrize("script,alone", [
    ("chip_smoke.py", False), ("chip_smoke.py", True), ("bench.py", False),
    ("scripts/motion_ab.py", False),
])
def test_gpu_entry_points_fail_without_a_gpu(tmp_path, script, alone):
    path = os.path.join(REPO, script)
    if alone:  # the script with nothing else of the repository beside it
        path = shutil.copy(path, tmp_path / script)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, path], env=env, cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert '"value"' not in proc.stdout
