"""Builds the JAX package's C++ library before any test module is collected.

tests/test_jpegdct.py, tests/test_jpegdct4.py and tests/test_dct_train.py
skip their whole module at collection when the library does not load, and
the JAX loader builds it lazily with `make` in whichever process asks
first: pytest-xdist's workers, collecting side by side, can then map a
half-written file and skip those modules. Here the main process (the xdist
controller, before it starts any worker, or the one process without xdist)
builds it once through tests/test_torch_native.build_jax_native, under that
helper's file lock, so every worker finds a whole library.
"""

import sys


def pytest_configure(config):
    # Only where tests/conftest.py has put JAX on the CPU (a run of tests/),
    # and not again in each xdist worker.
    if "tests.conftest" not in sys.modules or hasattr(config, "workerinput"):
        return
    from tests.test_torch_native import build_jax_native

    build_jax_native()
