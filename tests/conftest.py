"""Test config: the CPU backend with 8 virtual devices.

Multi-device sharding tests run on a simulated CPU mesh (SURVEY.md SS4).
The persistent compilation cache is off for the tests and the CLI
subprocesses they start (the cache rule has its own test).

Tests that need a GPU take the `gpu` fixture: it skips, with a reason,
where JAX finds no GPU. It decides when the test runs, never at import
or collection, so every xdist worker collects the same tests.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"

import jax  # noqa: E402
import pytest  # noqa: E402

# CPU unless the caller names platforms (the card-only tests run with
# JAX_PLATFORMS=cuda,cpu: python -m pytest -m gpu tests/)
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)  # f64 available; default stays f32


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (on the card: "
                    "JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/)")
    return devs[0]
