"""An autouse fixture for the port's test modules, which run the JAX
reference in the test process: at the end of each module it drops every
executable JAX has compiled (``jax.clear_caches``).

A compiled CPU executable holds a few memory mappings, and an xdist worker
runs many modules in one process.  Without a release a worker's mappings
grow towards the kernel's per-process limit (``vm.max_map_count``, 65,530
by default); there XLA's next compile fails inside LLVM ("Cannot allocate
memory") and the worker dies with a segmentation fault.
``tests/test_property.py`` alone leaves ~36,000 mappings in its process.
"""
import jax
import pytest


@pytest.fixture(autouse=True, scope="module")
def release_compiled_executables():
    yield
    jax.clear_caches()
