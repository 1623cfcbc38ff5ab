"""Test harness configuration.

* tests run on CPU with 8 virtual devices so the multi-device sharding
  path is exercised without GPUs (SURVEY.md section 4, tier 2).  A
  JAX_PLATFORMS set in the environment wins: the ``gpu``-marked tests run
  on the card with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``
  and skip (inside a fixture) everywhere else;
* float64 is enabled to match the reference's NumPy float64 numerics —
  the analytic parity tolerances assume it.  GPU production runs use
  float32 (see chip_smoke.py), which the engine supports via
  dtype-agnostic code paths.

Env vars alone are not enough: pytest plugins (jaxtyping) import jax
before this conftest runs, so the jax.config API is used as well — it is
still effective because no backend has been initialized yet.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["JAX_ENABLE_X64"] = "1"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture()
def rng():
    import numpy as np

    return np.random.default_rng(42)
