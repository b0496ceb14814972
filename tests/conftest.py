import os

import pytest

# Tests must see the real (single) CPU device — do NOT force 512 here;
# only launch/dryrun.py sets xla_force_host_platform_device_count.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# The property-based modules import hypothesis at module scope; without it
# they must be skipped at collection (not error the whole run).  Install
# via requirements-dev.txt to get them back.
try:
    import hypothesis  # noqa: F401
except ImportError:
    collect_ignore = [
        "test_connection.py",
        "test_fabric.py",
        "test_properties.py",
        "test_rings.py",
    ]


def _pallas_available() -> bool:
    """Can this backend execute Pallas kernels (compiled or interpreter)?

    CPU runs them through ``interpret=True``; a backend where even the
    interpreter import fails (stripped builds, exotic platforms) should
    skip kernel-parity tests instead of erroring them.
    """
    try:
        from jax.experimental import pallas  # noqa: F401
        return True
    except Exception:
        return False


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "requires_pallas: test drives a Pallas kernel (compiled or "
        "interpret mode); auto-skipped when jax.experimental.pallas is "
        "unavailable on this backend")
    config.addinivalue_line(
        "markers",
        "requires_cuda: test runs a CUDA kernel of repro_torch on the card; "
        "skips where torch.cuda.is_available() is False")


def pytest_collection_modifyitems(config, items):
    if _pallas_available():
        return
    skip = pytest.mark.skip(
        reason="jax.experimental.pallas unavailable on this backend")
    for item in items:
        if "requires_pallas" in item.keywords:
            item.add_marker(skip)
