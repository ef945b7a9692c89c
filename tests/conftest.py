"""Tier-1 suite configuration.

The default (quick) path must finish in minutes on a small CPU container:
multi-minute end-to-end paths are marked ``@pytest.mark.slow`` and skipped
unless ``--runslow`` is given, and tests that sweep training epochs take the
``quick_epochs`` fixture so the quick path shrinks ``max_epochs``.
"""
import pytest


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (full-epoch end-to-end paths)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-minute end-to-end path; needs --runslow")
    config.addinivalue_line(
        "markers", "needs_devices(n): requires >= n jax devices; "
        "auto-skipped otherwise (fake host devices with "
        "XLA_FLAGS=--xla_force_host_platform_device_count=N)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips itself on a host without "
        "one (on the card: python -m pytest -m gpu tests/test_torch_gpu.py)")


def pytest_collection_modifyitems(config, items):
    runslow = config.getoption("--runslow")
    n_dev = None                      # import jax only if a test needs it
    for item in items:
        if "slow" in item.keywords and not runslow:
            item.add_marker(pytest.mark.skip(
                reason="slow path: pass --runslow to run"))
        marker = item.get_closest_marker("needs_devices")
        if marker is not None:
            if n_dev is None:
                import jax
                n_dev = jax.device_count()
            need = marker.args[0] if marker.args else 2
            if n_dev < need:
                item.add_marker(pytest.mark.skip(
                    reason=f"needs {need} jax devices, have {n_dev}; "
                    f"set XLA_FLAGS=--xla_force_host_platform_device_"
                    f"count={need} before jax initializes"))


@pytest.fixture(scope="session")
def quick_epochs_module(request) -> int:
    """max_epochs budget for trained-to-convergence assertions: generous
    under --runslow, small in the default quick path.  Session-scoped so
    module-scoped fixtures (e.g. a sweep shared by several tests) can
    depend on it."""
    return 60 if request.config.getoption("--runslow") else 12


@pytest.fixture
def quick_epochs(quick_epochs_module) -> int:
    return quick_epochs_module
