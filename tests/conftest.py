import os

# Tests run on the CPU backend with a virtual 8-device mesh so sharding logic
# is exercised without a multi-GPU host. Tests marked `gpu` need a card:
# run them there with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
# Must be set before importing jax.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "1")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
# One program at a time on the CPU backend: with async dispatch two
# in-flight 8-device programs can hold each other's device threads, and
# XLA aborts the process when an all-to-all rendezvous waits 40 s.
jax.config.update("jax_cpu_enable_async_dispatch", False)

from prmers_tpu import jaxconf  # noqa: E402,F401  (x64 + compile cache)

import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption("--run-slow", action="store_true", default=False)
    parser.addoption("--run-heavy", action="store_true", default=False)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long golden runs (--run-slow)")
    config.addinivalue_line(
        "markers",
        "heavy: multi-minute compile/e2e tests (--run-heavy; "
        "make test-heavy). The default tier is the <5-min smoke suite.")
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU; skips elsewhere (the `gpu` fixture decides)")


def pytest_collection_modifyitems(config, items):
    run_slow = config.getoption("--run-slow")
    run_heavy = config.getoption("--run-heavy") or run_slow
    skip_slow = pytest.mark.skip(reason="slow; use --run-slow")
    skip_heavy = pytest.mark.skip(reason="heavy; use --run-heavy")
    for item in items:
        if "slow" in item.keywords and not run_slow:
            item.add_marker(skip_slow)
        elif "heavy" in item.keywords and not run_heavy:
            item.add_marker(skip_heavy)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none. Decided at
    run time, so every xdist worker collects the same tests."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/")
    return devs[0]
