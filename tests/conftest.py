"""Test configuration: the CPU backend with 8 virtual devices by default.

Multi-device sharding tests run on a fake 8-device CPU mesh
(xla_force_host_platform_device_count), per SURVEY.md §4. Must run before
jax initializes a backend, hence the env mutation at import time.

``JAX_PLATFORMS`` naming another platform (``JAX_PLATFORMS=cuda pytest -m
gpu`` on a card, or chip_smoke.py's test phase) leaves the platform to
JAX; tests that need the card are marked ``gpu`` and take the ``gpu``
fixture, which skips them when JAX's first device is not a GPU.
"""

import os

import pytest

_ON_CPU = os.environ.get("JAX_PLATFORMS", "cpu").strip().lower() in ("",
                                                                      "cpu")
if _ON_CPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if _ON_CPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX device: {dev.platform})")
    return dev


# Build the native library up front so the C++ tests always run instead of
# silently skipping. Best-effort: a missing toolchain degrades back to the
# skip markers in test_native.py.
import pathlib  # noqa: E402
import subprocess  # noqa: E402

_REPO = pathlib.Path(__file__).resolve().parent.parent
_SO = _REPO / "native" / "build" / "libtpu_slam_native.so"
if _ON_CPU and not _SO.exists():
    try:
        subprocess.run(["make", "native"], cwd=_REPO, check=True,
                       capture_output=True, timeout=300)
    except Exception:
        pass
