"""Test harness setup.

Tests run on the CPU backend with 8 virtual devices so multi-device
sharding logic is exercised without a multi-card host (SURVEY.md section
4.5). The platform is pinned via jax.config after importing jax but before
any backend initialization, so a machine with a GPU still tests on the
CPU. Tests that need the card are marked ``gpu`` and skip here
(``python chip_smoke.py`` runs the same checks on the card).
"""

import numpy as np
import pytest

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import ndpp_tpu  # noqa: F401,E402  (enables jax x64 + compile cache)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(20260816)
