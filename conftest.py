"""Collection order for the whole suite: the PyTorch port's tests first.

The suite is run under a time limit with pytest-xdist's load scheduling,
which hands tests to workers in collection order; the port's files
(tests/test_torch_*.py) sort after the long JAX rollouts and would never be
reached. This hook moves them to the front with a stable sort: it selects,
skips and marks nothing, and the other tests keep their relative order.

It imports neither jax nor torch: this file loads before tests/conftest.py,
which must configure JAX before its first import. The fixture below runs
each port test that compares with JAX inside the port's own compilation
cache (tests/torch_parity.py:port_compile_cache).
"""

import sys

import pytest


def _is_port_test(item) -> bool:
    return item.path.name.startswith("test_torch_")


def pytest_collection_modifyitems(session, config, items):
    items.sort(key=lambda item: not _is_port_test(item))


@pytest.fixture(autouse=True)
def _port_compile_cache(request):
    parity = sys.modules.get("torch_parity")
    if parity is None or not _is_port_test(request.node):
        yield
        return
    with parity.port_compile_cache():
        yield
