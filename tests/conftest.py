"""Test configuration: run everything on a virtual 8-device CPU mesh.

Must set XLA flags before jax is imported anywhere.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
# No persistent compilation cache under pytest: its executable
# serialization has segfaulted the suite mid-write twice (jax 0.9.0,
# compilation_cache.put_executable_and_time), and CPU compiles gain
# little from persistence. core/cache.enable_compilation_cache honors
# this sentinel.
os.environ.setdefault("AVSR_JAX_CACHE", "off")

import jax  # noqa: E402

# The hosted TPU plugin ignores the JAX_PLATFORMS env var; force via config.
jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_enable_compilation_cache", False)
except Exception:
    pass

import pytest  # noqa: E402


REFERENCE_ROOT = "/root/reference"


def has_reference() -> bool:
    return os.path.isdir(REFERENCE_ROOT)


requires_reference = pytest.mark.skipif(
    not has_reference(), reason="upstream reference assets not mounted"
)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where torch sees none"
    )
