"""Exactness oracles at 1080p block counts on the GPU (marker `gpu`).

Run on a machine with an NVIDIA GPU:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

Elsewhere each test skips: whether a GPU is present is decided inside
the fixture, never at import time.
"""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def smoke(chip_smoke):
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")
    return chip_smoke


@pytest.mark.gpu
@pytest.mark.parametrize("check", ["check_transforms", "check_intra",
                                   "check_satd", "check_mc_windows",
                                   "check_ssd_grid"])
def test_oracle_full_width(smoke, check):
    getattr(smoke, check)(smoke.FULL_W, smoke.FULL_H,
                          np.random.default_rng(0))
