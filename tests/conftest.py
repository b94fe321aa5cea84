import os

# Run the test suite on a virtual 8-device CPU mesh so multi-device
# sharding paths are exercised without an accelerator. jax.config is
# set too, in case the environment pinned another platform before
# this file ran.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

from medicalimageanalysis_tpu.data import Data


@pytest.fixture(autouse=True)
def clear_registry():
    Data.clear()
    yield
    Data.clear()


@pytest.fixture
def rng():
    return np.random.default_rng(seed=1234)
