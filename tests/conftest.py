"""Test configuration: run everything on a virtual 8-device CPU mesh.

Sharding-correctness of the distributed BA/pose-graph path is validated on
`--xla_force_host_platform_device_count=8` exactly as SURVEY.md §4 prescribes
(the reference has no tests at all; we test every kernel against oracles and
every solver against closed forms / scipy).
"""

import os

# Unit tests run on a virtual 8-device CPU mesh, whatever accelerator is
# attached. Only an explicit JAX_PLATFORMS naming another platform (the
# command that runs the `gpu`-marked tests on the card) keeps it.
PLATFORM = os.environ.get("JAX_PLATFORMS") or "cpu"
if PLATFORM == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402
import pytest  # noqa: E402

if PLATFORM == "cpu":
    jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == "cpu", "tests must run on the CPU mesh"
    assert len(jax.devices()) == 8, \
        "tests expect the virtual 8-device CPU mesh"

# f32 matmul accuracy for oracle comparisons (default lowers precision).
jax.config.update("jax_default_matmul_precision", "highest")
# Persistent compilation cache makes re-runs cheap: JAX_COMPILATION_CACHE_DIR
# when set (JAX reads it itself), else a fixed test path.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", "/tmp/jax_cache_tests")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


@pytest.fixture
def gpu():
    """Skip unless the test process runs on a GPU (tests marked `gpu`)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu")
    return jax.devices()[0]
