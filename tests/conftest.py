import importlib.util
import os

import pytest

# Tests run on the platform named by JAX_PLATFORMS (CPU when unset), with
# a virtual 8-device CPU mesh so the sharding paths are exercised without
# several accelerators.  Tests that need a GPU carry the `gpu` marker and
# skip elsewhere (tests/test_gpu_oracles.py).
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
# test runs write no persistent compile cache into the checkout
jax.config.update("jax_enable_compilation_cache", False)


# ---- smoke subset (fast pre-commit gate: -m smoke) ----
# Kernel-oracle and contract tests; the compile-heavy pipeline modules
# stay in the full suite.
_SMOKE_MODULES = {
    "test_pack", "test_transforms", "test_cabac_engine",
    "test_metrics", "test_sei", "test_api", "test_ratecontrol",
    "test_badapt", "test_estbits",
}


def pytest_collection_modifyitems(config, items):
    for it in items:
        mod = it.module.__name__.rsplit(".", 1)[-1]
        if mod in _SMOKE_MODULES:
            it.add_marker(pytest.mark.smoke)


@pytest.fixture(scope="session")
def chip_smoke():
    """chip_smoke.py from the repository root, loaded as a module."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
