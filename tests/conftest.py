"""Test env: force an 8-device virtual CPU platform.

Multi-device sharding tests run on this virtual mesh as they would on eight
accelerators (SURVEY.md §4: the torch reference could not test its
distributed paths; we can). jax.config is set as well as the environment, in
case jax was imported before this file.

Tests that need a GPU carry the ``gpu`` marker and skip here (see the
``gpu`` fixture); ``chip_smoke.py`` runs the same paths on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu"
assert len(jax.devices()) == 8, jax.devices()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skips a ``gpu``-marked test unless JAX's device is a GPU (never under
    this file's CPU platform; chip_smoke.py runs those checks on the card)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: chip_smoke.py runs this check on the card")
    return jax.devices()[0]
