"""Test harness config: run JAX on a virtual 8-device CPU mesh.

Sharding tests use ``--xla_force_host_platform_device_count=8`` (standard JAX
practice, SURVEY.md §4); it must be set before jax initializes. Tests marked
``gpu`` need a card: they run on the GPU machine (``chip_smoke.py`` runs
``pytest -m gpu tests/`` with ``JAX_PLATFORMS=cuda``) and skip elsewhere —
the ``gpu_device`` fixture decides, never module import.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Persistent XLA cache: recompiling the metric programs dominates test
# wall-clock; cache across test sessions (rtvqa_tpu.obs.jaxcache placement).
import jax  # noqa: E402

from rtvqa_tpu.obs.jaxcache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()


@pytest.fixture(autouse=True, scope="module")
def _release_executable_mappings():
    """Free each module's compiled executables when the module finishes.

    Every XLA:CPU executable holds tens-to-hundreds of anonymous mappings
    for its JIT code/data. A full single-process ``pytest tests/`` run
    accumulates past ``vm.max_map_count`` (65530 here): measured 65,062
    maps right before a deterministic SIGSEGV inside
    ``backend_compile_and_load`` (or, with the persistent cache on, inside
    the cache's zstd (de)serialization — whichever allocation crossed the
    limit first) around test ~196 of 260; every module passes in
    isolation. ``jax.clear_caches()`` provably returns the mappings
    (1188 -> 464 in a 60-program probe). Per-module clearing bounds the
    peak at one module's working set; the on-disk persistent cache keeps
    the recompiles cheap.
    """
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    from rtvqa_tpu.backend import on_gpu

    if not on_gpu():
        pytest.skip("needs a GPU: run `pytest -m gpu tests/` on the card")
    return jax.devices()[0]
