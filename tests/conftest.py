"""Test configuration.

Forces JAX onto a virtual 8-device CPU mesh, so the multi-device sharding
code paths run without accelerator hardware even where a GPU is attached.
Must run before any jax import.
"""

import os

# Tests are hardware-independent: jax.config.update still takes effect
# because no backend has been initialized yet.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

# Build the native runtime if missing or stale (the .so is not checked into
# git; `make -C native` is the canonical build).
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SO = os.path.join(_REPO, "guacamole", "runtime", "libguac_runtime.so")
_NATIVE = os.path.join(_REPO, "native")


def _native_stale() -> bool:
    if not os.path.exists(_SO):
        return True
    so_mtime = os.path.getmtime(_SO)
    for fn in os.listdir(_NATIVE):
        if fn.endswith((".cpp", ".h", ".hpp")):
            if os.path.getmtime(os.path.join(_NATIVE, fn)) > so_mtime:
                return True
    return False


if _native_stale():
    import subprocess

    subprocess.run(["make", "-C", _NATIVE], check=True, capture_output=True)

# The upstream Scala project's test resources (chrM, chr20 and GATK
# fixtures), read in place when a checkout of it sits at this path; tests
# that need them skip elsewhere.
REFERENCE_RESOURCES = "/root/reference/src/test/resources"


@pytest.fixture(scope="session")
def resources_dir():
    return _require_resources()


def _require_resources() -> str:
    if not os.path.isdir(REFERENCE_RESOURCES):
        pytest.skip("reference test resources not available")
    return REFERENCE_RESOURCES


def resource_path(name: str) -> str:
    """Path of one reference fixture; skips the calling test when the
    reference resources are absent."""
    return os.path.join(_require_resources(), name)
